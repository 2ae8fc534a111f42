"""The sharded wind tunnel: z-slab domain decomposition over a list of devices
(``fluid_simulation_tpu/parallel/sharded.py``, its 1-D z mesh).

Each rank owns a z-slab in local padded form ``(Dl+2, H+2, W+2)``: the
reference's ghost layout (simulation.cpp:35), except that the z ghost rows
of interior ranks are halos, the neighbours' edge rows. The JAX package runs
one program over a device mesh (``shard_map``); so does this module. Every
slab-local function here takes the list of all ranks' tensors, rank ``r``'s
on its own device, and every collective of the JAX step is one helper over
that list: ``lax.ppermute`` up and down is ``_ppermute_updown`` (all the
planes a rank sends are copied out before any halo is written, as the
collective is simultaneous), ``psum`` and ``pmax`` are sums and maxima
gathered on rank 0's device, ``all_gather`` is ``_gather_global``, and a
``jnp.where(i == 0, ...)`` on the rank index is a Python branch per rank.
Several ranks may share one device (one card holds every rank of a run that
shows the kernels); on a machine with several cards each rank gets its own
with no change here.

Halo protocol per relaxation sweep (simulation.cpp:251-273 and :183-246):

  red half  ->  exchange (red values cross slabs; global-edge ghosts stay
  stale, as in the single-device sweep)  ->  black half  ->  set_bounds with
  exchange (x/y faces local; z ghosts = pre-keep mirrors on the edge ranks,
  the neighbours' post-bounds rows elsewhere).

With ``use_pallas``, rbgs and an even slab depth the sweeps run
``kernels/linsolve_sweep.rbgs_sweep_packed`` on every rank (the CUDA kernel
on a card, its plain version on the CPU); otherwise the plain padded sweeps.
Advection backtraces reach the whole domain: each advect reads its z rows
from a window of ``advect_halo_slabs`` slabs either side, or from the full
gather when some backtrace reaches further (one host read per advect decides
which). Both read the same values; the lerp fractions come from the global
coordinates, so the window changes no bit. Advection, projection glue,
confinement and halo algebra are plain torch on every device, as the JAX
package computes them in XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fluid_simulation_tpu_torch.config import SimParams
from fluid_simulation_tpu_torch.kernels import _build
from fluid_simulation_tpu_torch.kernels.linsolve_sweep import (
    rbgs_sweep_packed, sweep_supported)
from fluid_simulation_tpu_torch.models import windtunnel as wtm
from fluid_simulation_tpu_torch.models.windtunnel import FluidState, StepStats
from fluid_simulation_tpu_torch.ops.advect import trilinear_gather
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.ops.linsolve import (
    as_scalar, diffusion_coeffs, neighbor_sum)
from fluid_simulation_tpu_torch.ops.project import _one_axis_gradient, grid_h
from fluid_simulation_tpu_torch.ops.vorticity import _central
from fluid_simulation_tpu_torch.parallel.mesh import cuda_devices, make_mesh

INTERIOR = (slice(1, -1),) * 3


# --------------------------------------------------------------------------
# collectives over the ranks' list
# --------------------------------------------------------------------------

def _ppermute_updown(up, down):
    """``lax.ppermute`` of ``up`` to rank r+1 and of ``down`` to rank r-1:
    ``(from_prev, from_next)``, rank r's entries copies of rank r-1's ``up``
    and rank r+1's ``down`` on r's device (None at the global edges). The
    copies are taken before the caller writes any halo, and never alias the
    sender's slab."""
    n = len(up)
    from_prev = [None] + [up[r - 1].to(up[r].device, copy=True)
                          for r in range(1, n)]
    from_next = [down[r + 1].to(down[r].device, copy=True)
                 for r in range(n - 1)] + [None]
    return from_prev, from_next


def _psum(xs):
    """Sum of per-rank values, in rank order, on rank 0's device."""
    s = xs[0]
    for x in xs[1:]:
        s = s + x.to(s.device)
    return s


def _pmax(xs):
    dev = xs[0].device
    return torch.stack([x.to(dev) for x in xs]).max()


def _gather_global(fs):
    """``all_gather``: the global padded field on each rank's device, from
    the ranks' interior rows and the edge ranks' ghost rows."""
    if len(fs) == 1:
        return list(fs)
    parts = [fs[0][:1]] + [f[1:-1] for f in fs] + [fs[-1][-1:]]
    by_dev = {}
    for f in fs:
        if f.device not in by_dev:
            by_dev[f.device] = torch.cat([p.to(f.device) for p in parts])
    return [by_dev[f.device] for f in fs]


def _exchange_interior(fs):
    """Refresh every rank's z halos from its neighbours; the global-edge
    ghosts keep their values (only set_bounds rewrites them). New
    tensors."""
    n = len(fs)
    if n == 1:
        return list(fs)
    from_prev, from_next = _ppermute_updown([f[-2] for f in fs],
                                            [f[1] for f in fs])
    out = []
    for r, f in enumerate(fs):
        f = f.clone()
        if r > 0:
            f[0] = from_prev[r]
        if r < n - 1:
            f[-1] = from_next[r]
        out.append(f)
    return out


def _set_bounds_ex(b, fs, keeps, wall_mode):
    """The sharded ``ops.bounds.set_bounds``: x/y faces and the keep
    multiply on each slab; z ghosts are the pre-keep mirrors on the edge
    ranks (ghost edges zero) and the neighbours' post-bounds rows inside the
    domain. New tensors."""
    sx, sy, sz = face_signs(b, wall_mode)
    n = len(fs)
    outs, mirrors = [], []
    for r, (f, keep) in enumerate(zip(fs, keeps)):
        f = f.clone()
        f[1:-1, 1:-1, 0] = sx * f[1:-1, 1:-1, 1]
        f[1:-1, 1:-1, -1] = f[1:-1, 1:-1, -2]
        f[1:-1, 0, 1:-1] = sy * f[1:-1, 1, 1:-1]
        f[1:-1, -1, 1:-1] = sy * f[1:-1, -2, 1:-1]
        lo = hi = None
        if r == 0:
            lo = torch.zeros_like(f[0])
            lo[1:-1, 1:-1] = sz * f[1, 1:-1, 1:-1]
        if r == n - 1:
            hi = torch.zeros_like(f[0])
            hi[1:-1, 1:-1] = sz * f[-2, 1:-1, 1:-1]
        f.mul_(keep)
        outs.append(f)
        mirrors.append((lo, hi))
    from_prev, from_next = _ppermute_updown([f[-2] for f in outs],
                                            [f[1] for f in outs])
    for r, f in enumerate(outs):
        lo, hi = mirrors[r]
        f[0] = lo if r == 0 else from_prev[r]
        f[-1] = hi if r == n - 1 else from_next[r]
    return outs


# --------------------------------------------------------------------------
# masks and the solve
# --------------------------------------------------------------------------

class _LocalMasks(NamedTuple):
    keep_scalar: torch.Tensor
    keep_vel: torch.Tensor
    fluid_i: torch.Tensor
    red_i: torch.Tensor            # bool, global parity
    nb: Tuple                      # (xp, xm, yp, ym, zp, zm) interior-shaped


def _local_masks(solid, n, i, D) -> _LocalMasks:
    """``scene.masks.build_masks`` on rank i's slab: adjacency and neighbour
    validity read the solid halos; in-bounds checks and red/black parity use
    global z."""
    Dl, H, W = (s - 2 for s in solid.shape)
    dt, dev = solid.dtype, solid.device
    solid_i = solid[INTERIOR]
    fluid_i = 1.0 - solid_i
    adj = (solid[1:-1, 1:-1, 2:] + solid[1:-1, 1:-1, :-2]
           + solid[1:-1, 2:, 1:-1] + solid[1:-1, :-2, 1:-1]
           + solid[2:, 1:-1, 1:-1] + solid[:-2, 1:-1, 1:-1])
    adj_fluid = ((adj > 0) & (solid_i < 0.5)).to(dt)
    keep_scalar = torch.ones_like(solid)
    keep_scalar[INTERIOR] = fluid_i
    keep_vel = keep_scalar.clone()
    keep_vel[INTERIOR] = fluid_i * (1.0 - adj_fluid)

    zg = (torch.arange(1, Dl + 1, device=dev) + i * Dl).reshape(Dl, 1, 1)
    yg = torch.arange(1, H + 1, device=dev).reshape(1, H, 1)
    xg = torch.arange(1, W + 1, device=dev).reshape(1, 1, W)
    red_i = ((zg + yg + xg) % 2) == 0
    fl = 1.0 - solid
    nb = (fl[1:-1, 1:-1, 2:] * (xg + 1 <= W).to(dt),
          fl[1:-1, 1:-1, :-2] * (xg - 1 >= 1).to(dt),
          fl[1:-1, 2:, 1:-1] * (yg + 1 <= H).to(dt),
          fl[1:-1, :-2, 1:-1] * (yg - 1 >= 1).to(dt),
          fl[2:, 1:-1, 1:-1] * (zg + 1 <= D).to(dt),
          fl[:-2, 1:-1, 1:-1] * (zg - 1 >= 1).to(dt))
    return _LocalMasks(keep_scalar, keep_vel, fluid_i, red_i, nb)


def _update(f, prev_i, a, crec):
    return (prev_i + a * neighbor_sum(f)) * crec


def _plane_update(p, prev_plane, zp_i, zm_i, a, crec):
    """The red update of one padded plane ``p`` (H+2, W+2) whose z
    neighbours are ``zp_i``/``zm_i``: the operand order of ``_update``."""
    s = ((((p[1:-1, 2:] + p[1:-1, :-2]) + p[2:, 1:-1]) + p[:-2, 1:-1])
         + zp_i) + zm_i
    return (prev_plane[1:-1, 1:-1] + a * s) * crec


def _black_phase_planes(fks, prevs, znlos, znhis, a, crec, red_lo, red_hi):
    """The planes the black half reads at local rows -1 and Dl, interiors
    (H, W): inside the domain the neighbour's red-updated edge row,
    recomputed here from the same values in the same operand order (one
    plane of work, no mid-sweep exchange); on the edge ranks the carried
    global ghost plane. ``red_lo``/``red_hi`` are the red cells of padded
    rows 0 and Dl+1 (global rows r·Dl, even, and (r+1)·Dl+1, odd: the slab
    depth is even)."""
    n = len(fks)
    from_prev2, from_next2 = _ppermute_updown([fk[-2] for fk in fks],
                                              [fk[1] for fk in fks])
    out = []
    for r in range(n):
        fk, prev, znlo, znhi = fks[r], prevs[r], znlos[r], znhis[r]
        lo, hi = znlo[1:-1, 1:-1], znhi[1:-1, 1:-1]
        if r > 0:
            lo = torch.where(red_lo[r], _plane_update(
                znlo, prev[0], fk[0], from_prev2[r], a, crec), lo)
        if r < n - 1:
            hi = torch.where(red_hi[r], _plane_update(
                znhi, prev[-1], from_next2[r], fk[-1], a, crec), hi)
        out.append((lo.contiguous(), hi.contiguous()))
    return out


def _black_phase_planes_padded(fs, prevs, a, crec, red_lo, red_hi):
    """``_black_phase_planes`` on padded slabs (``sharded.py::
    _black_phase_planes``): full (H+2, W+2) rows 0 and Dl+1 with the
    neighbour's red update in their interior, the planes the padded sweep
    (``kernels/linsolve_sweep.rbgs_sweep``) reads."""
    planes = _black_phase_planes([f[INTERIOR] for f in fs], prevs,
                                 [f[0] for f in fs], [f[-1] for f in fs], a,
                                 crec, red_lo, red_hi)
    out = []
    for f, (lo, hi) in zip(fs, planes):
        plo, phi = f[0].clone(), f[-1].clone()
        plo[1:-1, 1:-1] = lo
        phi[1:-1, 1:-1] = hi
        out.append((plo, phi))
    return out


def _edge_parity(fs):
    """Per rank, the red cells of the interior of padded rows 0 and Dl+1
    (global rows r·Dl, even, and (r+1)·Dl+1, odd, for an even slab depth),
    one copy per device."""
    H2, W2 = fs[0].shape[1:]
    by_dev = {}
    for f in fs:
        if f.device not in by_dev:
            yy = torch.arange(1, H2 - 1, device=f.device).reshape(-1, 1)
            xx = torch.arange(1, W2 - 1, device=f.device).reshape(1, -1)
            by_dev[f.device] = (((yy + xx) % 2) == 0,
                                ((1 + yy + xx) % 2) == 0)
    return ([by_dev[f.device][0] for f in fs],
            [by_dev[f.device][1] for f in fs])


def _pad_plane(interior, x0, x1, y0, y1):
    """A padded (H+2, W+2) row from its interior and the ghost values the
    x/y ghost planes carry for it (ghost edges zero)."""
    H, W = interior.shape
    z = interior.new_zeros((H + 2, W + 2))
    z[1:-1, 1:-1] = interior
    z[1:-1, 0] = x0
    z[1:-1, -1] = x1
    z[0, 1:-1] = y0
    z[-1, 1:-1] = y1
    return z


def _solve_packed(b, fs, prevs, a, c, a_c, crec, keeps, acc, wall_mode):
    """The sharded rbgs solve through the packed sweep
    (``kernels/linsolve_sweep.rbgs_sweep_packed``, the port of ``sharded.py::
    _solve_pallas``): each slab travels as its (Dl, H, W) interior, its x/y
    ghost planes and its padded z halo planes; torch computes the black-phase
    planes and the two exchanges of each sweep (4 planes per rank, as the
    padded path sends). Equal to the padded path bit for bit."""
    n = len(fs)
    H2, W2 = fs[0].shape[1:]
    red_lo, red_hi = _edge_parity(fs)
    rps = [p[INTERIOR] for p in prevs]
    kps = [k[INTERIOR] for k in keeps]
    carry = [[f[INTERIOR].contiguous(), f[1:-1, 1:-1, 0].contiguous(),
              f[1:-1, 1:-1, -1].contiguous(), f[1:-1, 0, 1:-1].contiguous(),
              f[1:-1, -1, 1:-1].contiguous(), f[0], f[-1]] for f in fs]
    for _ in range(acc):
        bps = _black_phase_planes([cr[0] for cr in carry], prevs,
                                  [cr[5] for cr in carry],
                                  [cr[6] for cr in carry], a_c, crec, red_lo,
                                  red_hi)
        swept = []
        for r, (fk, gx0, gx1, gy0, gy1, znlo, znhi) in enumerate(carry):
            swept.append(rbgs_sweep_packed(
                b, fk, rps[r], kps[r], gx0, gx1, gy0, gy1,
                znlo[1:-1, 1:-1].contiguous(), znhi[1:-1, 1:-1].contiguous(),
                bps[r][0], bps[r][1], a, c, wall_mode))
        # the post-bounds z exchange: global mirrors (zero borders) on the
        # edge ranks, the neighbours' padded edge rows elsewhere
        lo_pl = [_pad_plane(s[0][-1], s[1][-1], s[2][-1], s[3][-1], s[4][-1])
                 for s in swept]
        hi_pl = [_pad_plane(s[0][0], s[1][0], s[2][0], s[3][0], s[4][0])
                 for s in swept]
        from_prev, from_next = _ppermute_updown(lo_pl, hi_pl)
        carry = []
        for r, (fk, gx0, gx1, gy0, gy1, gz0, gz1) in enumerate(swept):
            if r == 0:
                znlo = fk.new_zeros((H2, W2))
                znlo[1:-1, 1:-1] = gz0
            else:
                znlo = from_prev[r]
            if r == n - 1:
                znhi = fk.new_zeros((H2, W2))
                znhi[1:-1, 1:-1] = gz1
            else:
                znhi = from_next[r]
            carry.append([fk, gx0, gx1, gy0, gy1, znlo, znhi])
    outs = []
    for f, (fk, gx0, gx1, gy0, gy1, znlo, znhi) in zip(fs, carry):
        out = torch.zeros_like(f)
        out[INTERIOR] = fk
        out[1:-1, 1:-1, 0] = gx0
        out[1:-1, 1:-1, -1] = gx1
        out[1:-1, 0, 1:-1] = gy0
        out[1:-1, -1, 1:-1] = gy1
        out[0] = znlo
        out[-1] = znhi
        outs.append(out)
    return outs


def _plain_solve_reason(p: SimParams, local_shape, dtype) -> Optional[str]:
    """Why the sharded solves do not take the packed sweep, or None when
    they do: ``use_pallas``, rbgs, and a slab ``sweep_supported`` takes."""
    if not p.use_pallas:
        return "use_pallas=False"
    if p.solver != "rbgs":
        return f"solver={p.solver!r} (kernel implements rbgs only)"
    if not sweep_supported(local_shape, dtype):
        Dl = local_shape[0] - 2
        if Dl % 2:
            return (f"odd local slab depth {Dl} (depth={p.depth} over "
                    f"nz={p.depth // Dl}; parity locality needs an even "
                    f"slab)")
        return (f"local slab {tuple(local_shape)} unsupported (dtype "
                f"{p.dtype}, or thinner than 2 rows)")
    return None


def _solve(b, fs, prevs, a, c, lms, keeps, p: SimParams):
    if p.solver not in ("rbgs", "jacobi"):
        raise ValueError(f"sharded mode supports solver in ('rbgs','jacobi'),"
                         f" got {p.solver!r}")
    dtype = fs[0].dtype
    a_c = as_scalar(a, dtype)
    crec = as_scalar(np.float32(1.0) / np.float32(c), dtype)
    if _plain_solve_reason(p, fs[0].shape, dtype) is None:
        return _solve_packed(b, fs, prevs, a, c, a_c, crec, keeps, p.acc,
                             p.wall_mode)
    prev_is = [q[INTERIOR] for q in prevs]
    for _ in range(p.acc):
        if p.solver == "rbgs":
            fs = [f.clone() for f in fs]
            for f, prev_i, lm in zip(fs, prev_is, lms):
                f[INTERIOR] = torch.where(lm.red_i, _update(f, prev_i, a_c,
                                                            crec), f[INTERIOR])
            # red values cross the slab faces
            fs = _exchange_interior(fs)
            for f, prev_i, lm in zip(fs, prev_is, lms):
                f[INTERIOR] = torch.where(lm.red_i, f[INTERIOR],
                                          _update(f, prev_i, a_c, crec))
        else:
            fs = [f.clone() for f in fs]
            for f, prev_i in zip(fs, prev_is):
                f[INTERIOR] = _update(f, prev_i, a_c, crec)
        fs = _set_bounds_ex(b, fs, keeps, p.wall_mode)
    return fs


# --------------------------------------------------------------------------
# advection
# --------------------------------------------------------------------------

def _bounded_z_window(srcs, K):
    """Per rank i, the rows of ``srcs`` from rank i-K to rank i+K (zeros
    where no rank is) with one row either side, and the two global ghost
    rows at their slots where the window reaches them: global padded row
    ``g`` lies at window row ``g - (i-K)·Dl``."""
    n = len(srcs)
    Dl = srcs[0].shape[0] - 2
    D = n * Dl
    out = []
    for i, s in enumerate(srcs):
        dev = s.device
        zero_slab = s.new_zeros((Dl,) + tuple(s.shape[1:]))
        body = [srcs[r][1:-1].to(dev) if 0 <= r < n else zero_slab
                for r in range(i - K, i + K + 1)]
        row = s.new_zeros((1,) + tuple(s.shape[1:]))
        ext = torch.cat([row] + body + [row])
        off = (i - K) * Dl
        if i <= K:
            ext[-off] = srcs[0][0].to(dev)
        if i >= n - 1 - K:
            ext[D + 1 - off] = srcs[-1][-1].to(dev)
        out.append(ext)
    return out


def _bounded_z_ok(zbs, K, Dl, D) -> bool:
    """True iff every rank's z corner rows fall inside its window (ghost
    rows included): one host read for all ranks."""
    n = len(zbs)
    oks = []
    for i, zb in enumerate(zbs):
        g0 = torch.floor(zb).to(torch.int64)
        g1 = g0 + 1
        off = (i - K) * Dl
        lo_ok = g0 - off >= 1
        if i <= K:
            lo_ok = lo_ok | (g0 == 0)
        hi_ok = g1 - off <= (2 * K + 1) * Dl
        if i >= n - 1 - K:
            hi_ok = hi_ok | (g1 == D + 1)
        oks.append(torch.all(lo_ok & hi_ok).to(zbs[0].device))
    return bool(torch.stack(oks).all())


def _z_lerp_dispatch(fields, zbs, p: SimParams, sample):
    """``sample(r, src, z_off)`` for each field (a list of per-rank padded
    slabs) and rank: ``src`` is the bounded K-slab window when every
    backtrace's z corners fit in it, else the full gather; its row 0 is
    global row ``z_off``. Returns per field the list of per-rank samples."""
    n = len(zbs)
    Dl = fields[0][0].shape[0] - 2
    K = min(p.advect_halo_slabs, n - 1)
    if n > 1 and K > 0 and _bounded_z_ok(zbs, K, Dl, p.depth):
        return [[sample(r, w, (r - K) * Dl)
                 for r, w in enumerate(_bounded_z_window(srcs, K))]
                for srcs in fields]
    return [[sample(r, g, 0) for r, g in enumerate(_gather_global(srcs))]
            for srcs in fields]


def _coord_backtrace(v, n_local, off, N, dt, axis):
    """Global 1-based coordinates along one axis (local index + ``off``),
    displaced by ``dt·N·v`` and clamped to the global box
    (simulation.cpp:384-390)."""
    dtype = v.dtype
    sh = [1, 1, 1]
    sh[axis] = n_local
    ci = torch.arange(1, n_local + 1, dtype=dtype,
                      device=v.device).reshape(sh) + off
    dtN = as_scalar(np.float32(dt) * np.float32(N), dtype)
    return (ci - dtN * v).clamp(
        as_scalar(0.5, dtype), as_scalar(np.float32(N) + np.float32(0.5),
                                         dtype))


def _backtraces(vxs, vys, vzs, p: SimParams):
    """Per rank the clamped (xb, yb, zb) of its interior cells."""
    Dl = vxs[0].shape[0] - 2
    return [(_coord_backtrace(vx[INTERIOR], p.width, 0, p.width, p.dt, 2),
             _coord_backtrace(vy[INTERIOR], p.height, 0, p.height, p.dt, 1),
             _coord_backtrace(vz[INTERIOR], Dl, r * Dl, p.depth, p.dt, 0))
            for r, (vx, vy, vz) in enumerate(zip(vxs, vys, vzs))]


def _advect(b, prevs, vxs, vys, vzs, lms, keeps, p: SimParams):
    """Compat advection of field ``b`` (``ops.advect.advect``) on the
    slabs."""
    pick = {1: (prevs, vys, vzs), 2: (vxs, prevs, vzs),
            3: (vxs, vys, prevs)}.get(b, (vxs, vys, vzs))
    bts = _backtraces(*pick, p)
    (smps,) = _z_lerp_dispatch(
        [prevs], [bt[2] for bt in bts], p,
        lambda r, src, off: trilinear_gather(src, *bts[r], off))
    outs = []
    for prev, smp, lm in zip(prevs, smps, lms):
        out = torch.zeros_like(prev)
        out[INTERIOR] = smp * lm.fluid_i
        outs.append(out)
    return _set_bounds_ex(b, outs, keeps, p.wall_mode)


def _lerp(arr, c, axis, off=0):
    """Lerp of ``arr`` along ``axis`` at coordinates ``c`` (full-shaped),
    whose row 0 is global row ``off``: ``advect_split_plain``'s lerp."""
    i0 = torch.floor(c).to(torch.int64)
    s = c - i0.to(c.dtype)
    idx = i0 - off
    return (torch.gather(arr, axis, idx) * (1.0 - s)
            + torch.gather(arr, axis, idx + 1) * s)


def _advect_split_local(prevs, vxs, vys, vzs, lms, p: SimParams):
    """Split advection (mode='split') on the slabs: padded fields with the
    sampled interiors times fluid and zero ghosts. The x and y passes are
    slab-local (the halo rows are the neighbours' rows); the z pass reads
    its window or the gather."""
    Dl = prevs[0].shape[0] - 2
    Bs, zbs = [], []
    for r, (prev, vx, vy, vz) in enumerate(zip(prevs, vxs, vys, vzs)):
        A = _lerp(prev, _coord_backtrace(vx[:, :, 1:-1], p.width, 0,
                                         p.width, p.dt, 2), 2)
        Bs.append(_lerp(A, _coord_backtrace(vy[:, 1:-1, 1:-1], p.height, 0,
                                            p.height, p.dt, 1), 1))
        zbs.append(_coord_backtrace(vz[INTERIOR], Dl, r * Dl, p.depth, p.dt,
                                    0))
    (smps,) = _z_lerp_dispatch([Bs], zbs, p,
                               lambda r, src, off: _lerp(src, zbs[r], 0, off))
    outs = []
    for prev, smp, lm in zip(prevs, smps, lms):
        out = torch.zeros_like(prev)
        out[INTERIOR] = smp * lm.fluid_i
        outs.append(out)
    return outs


def _advect_fast(prev_fields, vxs, vys, vzs, lms, p: SimParams):
    """mode='fast': one shared backtrace through the projected velocity,
    a trilinear sample of each field. Per field the per-rank interiors."""
    bts = _backtraces(vxs, vys, vzs, p)
    smps = _z_lerp_dispatch(
        list(prev_fields), [bt[2] for bt in bts], p,
        lambda r, src, off: trilinear_gather(src, *bts[r], off))
    return [[s * lm.fluid_i for s, lm in zip(field, lms)] for field in smps]


# --------------------------------------------------------------------------
# confinement, projection, the step
# --------------------------------------------------------------------------

def _apply_confinement_local(vxs, vys, vzs, lms, p: SimParams):
    """Vorticity confinement (``ops.vorticity``) on the slabs: the curl
    reads the velocity halos; the gradient of |omega| reads its halos after
    one exchange (the global ghost rows stay zero); the forced velocities'
    halos are exchanged again, their global ghost faces keep their
    pre-confinement mirrors, as the single-device step leaves them."""
    dtype = vxs[0].dtype
    curls, mags = [], []
    for vx, vy, vz in zip(vxs, vys, vzs):
        w = (_central(vz, 1) - _central(vy, 0), _central(vx, 0)
             - _central(vz, 2), _central(vy, 2) - _central(vx, 1))
        mag = torch.zeros_like(vx)
        mag[INTERIOR] = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
        curls.append(w)
        mags.append(mag)
    mags = _exchange_interior(mags)
    eps_dt = as_scalar(np.float32(p.vorticity) * np.float32(p.dt), dtype)
    outs = []
    for vx, vy, vz, (wx, wy, wz), mag, lm in zip(vxs, vys, vzs, curls, mags,
                                                 lms):
        gx, gy, gz = _central(mag, 2), _central(mag, 1), _central(mag, 0)
        norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + as_scalar(1e-5,
                                                                   dtype)
        nx, ny, nz = gx / norm, gy / norm, gz / norm
        s = eps_dt * lm.keep_vel[INTERIOR]
        new = []
        for v, fo in ((vx, s * (ny * wz - nz * wy)),
                      (vy, s * (nz * wx - nx * wz)),
                      (vz, s * (nx * wy - ny * wx))):
            v = v.clone()
            v[INTERIOR] += fo
            new.append(v)
        outs.append(new)
    return tuple(_exchange_interior(list(fs)) for fs in zip(*outs))


def _divergence_local(vx, vy, vz, lm, h):
    hh = as_scalar(np.float32(-0.5) * np.float32(h), vx.dtype)
    xp, xm, yp, ym, zp, zm = lm.nb
    val = (vx[1:-1, 1:-1, 2:] * xp - vx[1:-1, 1:-1, :-2] * xm
           + vy[1:-1, 2:, 1:-1] * yp - vy[1:-1, :-2, 1:-1] * ym
           + vz[2:, 1:-1, 1:-1] * zp - vz[:-2, 1:-1, 1:-1] * zm)
    return hh * val * lm.fluid_i


def _project(vxs, vys, vzs, lms, p: SimParams):
    """The projection (``ops.project.project``) on the slabs."""
    h = grid_h(p.width, p.height, p.depth)
    divs = []
    for vx, vy, vz, lm in zip(vxs, vys, vzs, lms):
        div = torch.zeros_like(vx)
        div[INTERIOR] = _divergence_local(vx, vy, vz, lm, h)
        divs.append(div)
    keep_s = [lm.keep_scalar for lm in lms]
    divs = _set_bounds_ex(0, divs, keep_s, p.wall_mode)
    # set_bounds(0, zeros) is zeros (simulation.cpp:319)
    prs = _solve(0, [torch.zeros_like(v) for v in vxs], divs, 1.0, 6.0, lms,
                 keep_s, p)
    dtype = vxs[0].dtype
    shifts = ((lambda q: q[1:-1, 1:-1, 2:], lambda q: q[1:-1, 1:-1, :-2]),
              (lambda q: q[1:-1, 2:, 1:-1], lambda q: q[1:-1, :-2, 1:-1]),
              (lambda q: q[2:, 1:-1, 1:-1], lambda q: q[:-2, 1:-1, 1:-1]))
    outs = [[], [], []]
    for r, (pr, lm) in enumerate(zip(prs, lms)):
        for axis, (vs, (sp, sm)) in enumerate(zip((vxs, vys, vzs), shifts)):
            g = _one_axis_gradient(pr, lm.nb[2 * axis], lm.nb[2 * axis + 1],
                                   sp, sm, h, dtype)
            v = vs[r].clone()
            v[INTERIOR] += -g * lm.fluid_i
            outs[axis].append(v)
    keep_v = [lm.keep_vel for lm in lms]
    return tuple(_set_bounds_ex(b, fs, keep_v, p.wall_mode)
                 for b, fs in zip((1, 2, 3), outs))


def _local_step(states: Sequence[FluidState], lms, p: SimParams):
    """One full time step on every rank's padded slab (the single-device
    ``simulation_step``, slab-local). All slabs carry valid halos in and
    out. Returns the new per-rank states and the global StepStats."""
    if p.mode not in ("compat", "split", "fast"):
        raise ValueError(f"unknown mode {p.mode!r}")
    n = len(states)
    dtype = states[0].vx.dtype
    vxs, vys, vzs, denss = [], [], [], []
    for st in states:
        vx, vy, vz, dens = (f.clone() for f in st)
        dens[1:-1, 1:-1, 1] += as_scalar(p.inlet_density, dtype)
        vx[1:-1, 1:-1, 1] = as_scalar(p.speed, dtype)
        vy[1:-1, 1:-1, 1] = 0.0
        vz[1:-1, 1:-1, 1] = 0.0
        vxs.append(vx)
        vys.append(vy)
        vzs.append(vz)
        denss.append(dens)
    # the inlets rewrote interiors: refresh the halos before any read
    vxs, vys, vzs, denss = (_exchange_interior(fs)
                            for fs in (vxs, vys, vzs, denss))
    buffer = denss
    pvxs, pvys, pvzs = vxs, vys, vzs

    keep_v = [lm.keep_vel for lm in lms]
    keep_s = [lm.keep_scalar for lm in lms]
    vel_diff = p.visc if p.use_visc_for_velocity else p.diff
    a, c = diffusion_coeffs(p.width, p.height, p.depth, p.dt, vel_diff)
    vxs = _solve(1, vxs, pvxs, a, c, lms, keep_v, p)
    vys = _solve(2, vys, pvys, a, c, lms, keep_v, p)
    vzs = _solve(3, vzs, pvzs, a, c, lms, keep_v, p)
    vxs, vys, vzs = _project(vxs, vys, vzs, lms, p)

    if p.mode == "split":
        vxs, vys, vzs = (
            _set_bounds_ex(b, _advect_split_local(prev, vxs, vys, vzs, lms,
                                                  p), keep_v, p.wall_mode)
            for b, prev in ((1, pvxs), (2, pvys), (3, pvzs)))
    elif p.mode == "fast":
        smps = _advect_fast((pvxs, pvys, pvzs), vxs, vys, vzs, lms, p)
        new = []
        for b, field in zip((1, 2, 3), smps):
            outs = []
            for s, v in zip(field, vxs):
                f = torch.zeros_like(v)
                f[INTERIOR] = s
                outs.append(f)
            new.append(_set_bounds_ex(b, outs, keep_v, p.wall_mode))
        vxs, vys, vzs = new
    else:
        vxs2 = _advect(1, pvxs, vxs, vys, vzs, lms, keep_v, p)
        vys2 = _advect(2, pvys, vxs2, vys, vzs, lms, keep_v, p)
        vzs2 = _advect(3, pvzs, vxs2, vys2, vzs, lms, keep_v, p)
        vxs, vys, vzs = vxs2, vys2, vzs2

    if p.vorticity:
        vxs, vys, vzs = _apply_confinement_local(vxs, vys, vzs, lms, p)

    vxs, vys, vzs = _project(vxs, vys, vzs, lms, p)

    if p.mode == "split":
        denss = _set_bounds_ex(0, _advect_split_local(buffer, vxs, vys, vzs,
                                                      lms, p), keep_s,
                               p.wall_mode)
    else:
        denss = _advect(0, buffer, vxs, vys, vzs, lms, keep_s, p)

    dev0 = vxs[0].device
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev0)
    if p.step_stats:
        # each rank sums the global cells it owns: its interior rows, and
        # the ghost plane on the global-edge ranks
        parts = []
        for r, d in enumerate(denss):
            s = torch.sum(d[1:-1], dtype=torch.float32)
            if r == 0:
                s = s + torch.sum(d[0], dtype=torch.float32)
            if r == n - 1:
                s = s + torch.sum(d[-1], dtype=torch.float32)
            parts.append(s)
        density_sum = _psum(parts)
    else:
        density_sum = nan
    if p.div_stats:
        h = grid_h(p.width, p.height, p.depth)
        max_div = _pmax([_divergence_local(vx, vy, vz, lm, h).abs().max()
                         for vx, vy, vz, lm in zip(vxs, vys, vzs, lms)]
                        ).to(torch.float32)
    else:
        max_div = nan
    new = [FluidState(*f) for f in zip(vxs, vys, vzs, denss)]
    return new, StepStats(density_sum=density_sum, max_divergence=max_div)


# --------------------------------------------------------------------------
# layout conversion and the public API
# --------------------------------------------------------------------------

def split_padded(global_padded, n: int) -> list:
    """(D+2, H+2, W+2) -> n overlapping (D/n+2, H+2, W+2) slabs (copies),
    NumPy arrays or tensors as given."""
    D = global_padded.shape[0] - 2
    if n < 1 or D % n:
        raise ValueError(f"depth {D} not divisible by {n} shards")
    Dl = D // n
    copy = (np.array if isinstance(global_padded, np.ndarray)
            else torch.clone)
    return [copy(global_padded[r * Dl: r * Dl + Dl + 2]) for r in range(n)]


def stitch_padded(slabs):
    """Inverse of ``split_padded``: a sequence of slabs (or a stacked
    (n, Dl+2, H+2, W+2) array) -> the global padded field."""
    slabs = list(slabs)
    parts = [slabs[0][:1]] + [s[1:-1] for s in slabs] + [slabs[-1][-1:]]
    if isinstance(slabs[0], np.ndarray):
        return np.concatenate(parts, axis=0)
    dev = slabs[0].device
    return torch.cat([q.to(dev) for q in parts])


def _stitch_steps(arr: np.ndarray) -> np.ndarray:
    """(steps, n, Dl+2, H+2, W+2) recorded frames -> (steps, D+2, H+2, W+2)
    global padded frames."""
    steps, n = arr.shape[:2]
    interiors = arr[:, :, 1:-1].reshape(steps, -1, *arr.shape[3:])
    return np.concatenate([arr[:, 0, :1], interiors, arr[:, n - 1, -1:]],
                          axis=1)


def unported_reason(p: SimParams, local_depth: int) -> Optional[str]:
    """What in ``p`` has no kernel route on the card yet for slabs of
    ``local_depth`` rows, with its ROADMAP item, or None: the single-device
    step's reasons, and an odd slab depth under rbgs."""
    reason = wtm.unported_reason(p)
    if reason:
        return reason
    if p.solver == "rbgs" and local_depth % 2:
        return (f"odd local slab depth {local_depth}: the sweep kernel needs "
                f"an even slab (ROADMAP A13b)")
    return None


def _require_ported(p: SimParams, states) -> None:
    if p.use_pallas and any(_build.on_card(st.vx) for st in states):
        reason = unported_reason(p, states[0].vx.shape[0] - 2)
        if reason:
            raise NotImplementedError(
                f"{reason}: not ported to the card yet; use_pallas=False "
                f"runs the plain torch sharded step")


def simulate_sharded(states: Sequence[FluidState], solids, params: SimParams,
                     steps: int, record: bool = False):
    """Run ``steps`` sharded steps from the per-rank padded ``states`` over
    the per-rank padded solid slabs ``solids``. Returns ``(states,
    stats)``, or with ``record`` ``(states, (stats, frames))``: ``frames``
    holds every step's per-rank states (the analog of the JAX package's
    recorded scan outputs). Unlike the JAX function it takes no ``mesh``:
    each rank's slab is a tensor on that rank's device, so the states
    carry the mesh."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    states = list(states)
    _require_ported(params, states)
    n = len(states)
    lms = [_local_masks(s, n, r, params.depth) for r, s in enumerate(solids)]
    stats, frames = [], []
    for _ in range(steps):
        states, st = _local_step(states, lms, params)
        stats.append(st)
        if record:
            frames.append(states)
    stacked = StepStats(*(torch.stack(x) for x in zip(*stats)))
    return (states, (stacked, frames)) if record else (states, stacked)


class ShardedWindTunnel:
    """The wind tunnel over a 1-D z mesh, with the JAX package's signature:
    one rank on each of the first ``n_devices`` (default: all) of
    ``devices`` (default: every visible card). A device may repeat, so one
    card can hold several ranks; ``["cpu"] * n`` runs plain torch on the
    host. BASELINE config 5 is 256^3 over two ranks. The 2-D (z, y) mesh
    of the JAX package is not ported yet."""

    def __init__(self, params: SimParams, obstacles: Optional[np.ndarray] = None,
                 n_devices: Optional[int] = None,
                 mesh_shape: Optional[Tuple[int, int]] = None, *,
                 devices: Optional[Sequence] = None):
        devs = [torch.device(d) for d in
                (devices if devices is not None else cuda_devices())]
        if n_devices is not None:
            if not 1 <= n_devices <= len(devs):
                raise ValueError(f"n_devices={n_devices}: have {len(devs)} "
                                 f"devices")
            devs = devs[:n_devices]
        if any(d.type == "cuda" for d in devs) and \
                not torch.cuda.is_available():
            raise RuntimeError("ShardedWindTunnel: no CUDA device; pass "
                               "devices=['cpu'] * n to run on the host")
        if mesh_shape is None:
            mesh_shape = (len(devs), 1)
        self.nz, self.ny = mesh_shape
        if self.ny != 1:
            raise NotImplementedError(
                f"mesh_shape={tuple(mesh_shape)}: the 2-D (z, y) mesh is not "
                f"ported yet (ROADMAP A13b)")
        if self.nz > len(devs):
            raise ValueError(f"mesh {tuple(mesh_shape)} needs {self.nz} "
                             f"devices, have {len(devs)}")
        self.mesh = make_mesh(devices=devs[:self.nz])
        self.devices: List[torch.device] = list(self.mesh.devices[0])
        self.device = self.devices[0]
        self.params = params
        if obstacles is None:
            obstacles = np.zeros(params.padded_shape, np.float32)
        if tuple(obstacles.shape) != params.padded_shape:
            raise ValueError(f"obstacle shape {obstacles.shape} != padded "
                             f"{params.padded_shape}")
        self.obstacles = np.asarray(obstacles, np.float32)
        dtype = wtm._dtype(params)
        solid = (self.obstacles >= 0.5).astype(np.float32)
        self.solids = [torch.tensor(s, dtype=dtype, device=d) for s, d in
                       zip(split_padded(solid, self.nz), self.devices)]
        self.state = [FluidState(*(torch.zeros(s.shape, dtype=dtype,
                                               device=s.device)
                                   for _ in range(4))) for s in self.solids]
        _require_ported(params, self.state)

    def backend_report(self) -> dict:
        """Which solve the slabs use, and why."""
        local_shape = tuple(self.solids[0].shape)
        reason = _plain_solve_reason(self.params, local_shape,
                                     self.solids[0].dtype)
        if reason is None and not any(d.type == "cuda" for d in self.devices):
            reason = ("CPU tensors: the packed route runs "
                      "rbgs_sweep_packed_plain")
        return {
            "mesh": (self.nz, self.ny),
            "local_padded_shape": local_shape,
            "devices": [str(d) for d in self.devices],
            "solve": "plain_rbgs" if reason else "cuda_packed_sweep",
            "solve_reason": reason or "supported",
        }

    def step(self) -> StepStats:
        self.state, stats = simulate_sharded(self.state, self.solids,
                                             self.params, 1)
        return StepStats(*(x[0] for x in stats))

    def simulate(self, steps: int, record: bool = False):
        """Advance ``steps``. With ``record`` also returns the per-step
        frames stitched to the global padded layout (host NumPy), as the
        JAX package's ``simulate(record=True)`` does."""
        if not record:
            self.state, stats = simulate_sharded(self.state, self.solids,
                                                 self.params, steps)
            return self.state, stats
        self.state, (stats, frames) = simulate_sharded(
            self.state, self.solids, self.params, steps, record=True)
        host = FluidState(*(
            _stitch_steps(np.stack([np.stack([st[k].cpu().numpy()
                                              for st in ranks])
                                    for ranks in frames]))
            for k in range(4)))
        return self.state, (stats, host)

    def global_state(self) -> FluidState:
        """The slabs stitched to the single-device padded layout, on rank
        0's device."""
        return FluidState(*(stitch_padded([st[k] for st in self.state])
                            for k in range(4)))

    def collective_bytes_per_step(self) -> dict:
        """What each rank sends per step, by phase (the JAX package's
        accounting): the advect figure assumes the bounded K-slab window
        engages; the all-gather bound is reported beside it."""
        p = self.params
        n, itemsize = self.nz, 4 if p.dtype == "float32" else 2
        H2, W2 = p.height + 2, p.width + 2
        Dl = p.depth // n
        plane = H2 * W2 * itemsize
        slab = Dl * plane
        # rbgs sweep: red exchange (2 planes) + set_bounds exchange (2);
        # jacobi: set_bounds only. 3 diffusions + 2 Poisson solves per step.
        planes_per_sweep = 4 if p.solver == "rbgs" else 2
        solve_bytes = 5 * p.acc * planes_per_sweep * plane
        K = min(p.advect_halo_slabs, n - 1)
        adv_bounded = 4 * (2 * K * slab + 2 * plane)
        adv_fallback = 4 * (n - 1) * (slab + 2 * plane)
        misc = (8 if p.vorticity else 4) * 2 * plane
        total = solve_bytes + (adv_bounded if K > 0 else adv_fallback) + misc
        return {
            "plane_bytes": plane, "slab_bytes": slab,
            "solve_bytes": solve_bytes,
            "advect_bytes_bounded": adv_bounded if K > 0 else None,
            "advect_bytes_fallback": adv_fallback,
            "misc_bytes": misc,
            "total_bytes": total,
        }
