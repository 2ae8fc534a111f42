// Native geometry engine: ray-parity mesh voxelization (OpenMP), the port's
// own copy of fluid_simulation_tpu/native/geometry.cpp.
//
// The counterpart of the reference's C++ scene preprocessor
// (object_loader.cpp:270-452): coarse-occupancy early rejection, jittered
// sample points, one random-direction ray per point, Moller-Trumbore parity.
// Two deliberate upgrades over the reference:
//   * deterministic counter-based RNG (splitmix64 on the fine-point linear
//     index) instead of thread-id-seeded minstd (object_loader.cpp:399) — the
//     result is independent of the thread count, equals the JAX package's
//     build of the same source bit for bit, and equals the NumPy engine
//     (scene/voxelize.py) except for Moller-Trumbore verdicts on rays that
//     graze a seam;
//   * no critical section: obstacle cells are written as idempotent stores.
//
// Built by native/geometry.py with g++ -ffp-contract=off (no FMA
// contraction), the JAX Makefile's flags, and called through a C ABI by
// ctypes.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t z) {
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

inline double u01(uint64_t seed, uint64_t lin, int channel) {
    uint64_t ctr = (lin * 6ULL + (uint64_t)(channel + 1))
                   * 0x9E3779B97F4A7C15ULL + seed;
    return (double)(splitmix64(ctr) >> 11) * 0x1.0p-53;
}

struct Vec3 { double x, y, z; };

inline Vec3 sub(const Vec3& a, const Vec3& b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y,
            a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
inline double dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Moller-Trumbore with the reference's thresholds (object_loader.cpp:205-233)
inline bool ray_hits(const Vec3& orig, const Vec3& dir,
                     const Vec3& v1, const Vec3& e1, const Vec3& e2) {
    const Vec3 h = cross(dir, e2);
    const double a = dot(e1, h);
    if (std::fabs(a) < 1e-6) return false;
    const double f = 1.0 / a;
    const Vec3 s = sub(orig, v1);
    const double u = f * dot(s, h);
    if (u < 0.0 || u > 1.0) return false;
    const Vec3 q = cross(s, e1);
    const double v = f * dot(dir, q);
    if (v < 0.0 || u + v > 1.0) return false;
    const double t = f * dot(e2, q);
    return t > 1e-3;
}

}  // namespace

extern "C" {

// Bumped whenever any exported signature changes; native/geometry.py refuses
// a library whose version does not match (a silently-loaded old binary would
// read pointer arguments from the wrong slots).
long fstpu_abi_version() { return 3; }

// Returns the number of obstacle cells written into out_mask, which must be a
// zero-initialized float array of (D+2)*(H+2)*(W+2), z-major/x-fastest like
// the solver grid. Triangles are (n,3,3) float32, already rotated.
// fine_divisor is 200.0 for reference behavior (object_loader.cpp:368);
// tests pass smaller values to shrink the fine scan grid.
long fstpu_voxelize_ray_parity(
    const float* tris, long n_tris,
    const double* padded_lo, const double* padded_hi,
    const double* obj_center, double scale,
    long W, long H, long D,
    const double* translate,
    uint64_t seed,
    double fine_divisor,
    float* out_mask) {

    // fine resolution & scan dims (object_loader.cpp:362-372)
    const double ext_x = padded_hi[0] - padded_lo[0];
    const double ext_y = padded_hi[1] - padded_lo[1];
    const double ext_z = padded_hi[2] - padded_lo[2];
    double obj_size = ext_x;
    if (ext_y > obj_size) obj_size = ext_y;
    if (ext_z > obj_size) obj_size = ext_z;
    double resolution = obj_size / fine_divisor;
    if (resolution < 0.02) resolution = 0.02;
    const long nx = (long)(ext_x / resolution);
    const long ny = (long)(ext_y / resolution);
    const long nz = (long)(ext_z / resolution);

    // double-precision triangle cache + precomputed edges
    std::vector<Vec3> v1(n_tris), e1(n_tris), e2(n_tris);
    for (long t = 0; t < n_tris; ++t) {
        const float* p = tris + t * 9;
        Vec3 a{p[0], p[1], p[2]}, b{p[3], p[4], p[5]}, c{p[6], p[7], p[8]};
        v1[t] = a;
        e1[t] = sub(b, a);
        e2[t] = sub(c, a);
    }

    // coarse 64^3 occupancy at 5x fine resolution (object_loader.cpp:380-389)
    const int GSZ = 64;
    const double coarse = resolution * 5.0;
    std::vector<uint8_t> occ((size_t)GSZ * GSZ * GSZ, 0);
    auto occ_at = [&](long x, long y, long z) -> uint8_t& {
        return occ[(size_t)((z * GSZ + y) * GSZ + x)];
    };
    for (long t = 0; t < n_tris; ++t) {
        const float* p = tris + t * 9;
        double mn[3], mx[3];
        for (int c = 0; c < 3; ++c) {
            mn[c] = p[c]; mx[c] = p[c];
            for (int vtx = 1; vtx < 3; ++vtx) {
                const double val = p[vtx * 3 + c];
                if (val < mn[c]) mn[c] = val;
                if (val > mx[c]) mx[c] = val;
            }
        }
        long lo[3], hi[3];
        for (int c = 0; c < 3; ++c) {
            lo[c] = (long)((mn[c] - padded_lo[c]) / coarse);
            hi[c] = (long)((mx[c] - padded_lo[c]) / coarse);
            if (lo[c] < 0) lo[c] = 0;
            if (hi[c] > GSZ - 1) hi[c] = GSZ - 1;
        }
        for (long z = lo[2]; z <= hi[2]; ++z)
            for (long y = lo[1]; y <= hi[1]; ++y)
                for (long x = lo[0]; x <= hi[0]; ++x)
                    occ_at(x, y, z) = 1;
    }

    // world -> grid mapping (object_loader.cpp:426-438); gridScale in f32
    // like the reference
    const float grid_scale = (float)scale
        * (float)std::min(std::min(W, H), D) / (float)obj_size;
    const double gc_x = (double)W / 2.0, gc_y = (double)H / 2.0,
                 gc_z = (double)D / 2.0;
    const long W2 = W + 2, H2 = H + 2;

    long added = 0;
    #pragma omp parallel for collapse(2) reduction(+:added) schedule(dynamic, 4)
    for (long i = 0; i < nx; ++i) {
        for (long j = 0; j < ny; ++j) {
            for (long k = 0; k < nz; ++k) {
                const uint64_t lin = (uint64_t)((i * ny + j) * nz + k);
                Vec3 p{padded_lo[0] + i * resolution,
                       padded_lo[1] + j * resolution,
                       padded_lo[2] + k * resolution};
                // coarse early rejection (object_loader.cpp:412-414)
                const long cx = (long)((p.x - padded_lo[0]) / coarse);
                const long cy = (long)((p.y - padded_lo[1]) / coarse);
                const long cz = (long)((p.z - padded_lo[2]) / coarse);
                if (cx < 0 || cx >= GSZ || cy < 0 || cy >= GSZ
                    || cz < 0 || cz >= GSZ || !occ_at(cx, cy, cz))
                    continue;
                // jitter + random ray (object_loader.cpp:417-422), shared RNG
                p.x += u01(seed, lin, 0) * 1e-3 - 5e-4;
                p.y += u01(seed, lin, 1) * 1e-3 - 5e-4;
                p.z += u01(seed, lin, 2) * 1e-3 - 5e-4;
                const Vec3 dir{0.1 + 0.9 * u01(seed, lin, 3),
                               0.1 + 0.9 * u01(seed, lin, 4),
                               0.1 + 0.9 * u01(seed, lin, 5)};
                long hits = 0;
                for (long t = 0; t < n_tris; ++t)
                    if (ray_hits(p, dir, v1[t], e1[t], e2[t])) ++hits;
                if (!(hits & 1)) continue;
                // map to simulation cell, truncation like the reference int
                // casts (object_loader.cpp:432-434)
                const long gx = (long)((p.x - obj_center[0]) * grid_scale
                                       + gc_x + translate[0]);
                const long gy = (long)((p.y - obj_center[1]) * grid_scale
                                       + gc_y + translate[1]);
                const long gz = (long)((p.z - obj_center[2]) * grid_scale
                                       + gc_z + translate[2]);
                if (gx >= 1 && gx <= W && gy >= 1 && gy <= H
                    && gz >= 1 && gz <= D) {
                    out_mask[(gz * H2 + gy) * W2 + gx] = 1.0f;
                    ++added;
                }
            }
        }
    }
    return added;
}

}  // extern "C"
