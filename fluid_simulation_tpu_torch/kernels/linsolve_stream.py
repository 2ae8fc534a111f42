"""Kernels 11-13: the streamed, temporally blocked red-black Gauss-Seidel solve
of big grids (``csrc/rbgs_stream.cu``) and its plain torch version.

Port of the JAX package's big-grid solves, which compute one map on the
packed (D, H, W) pre-keep carry ``fpre``: ``pallas_rbgs_solve_mdma``
(``kernels/linsolve_mdma.py``), ``pallas_rbgs_solve_stream`` and
``pallas_rbgs_solve_stream_t`` (``kernels/linsolve_stream.py``), and
``pallas_rbgs_solve_temporal`` (``kernels/linsolve_temporal.py``, the same
function in the padded layout). A solve is

1. sweep 1 on the padded field, which reads the caller's own ghost faces
   and writes no face and no keep: the packed pre-keep field after one
   sweep (``make_sweep1_packed_call``);
2. ``(acc - 1) // nsw`` passes of ``nsw`` sweeps on the carry, then one
   pass of the remainder (``merged_sweep_chain``). Inside a pass an
   out-of-domain neighbour reads ``sign * fpre`` of the edge cell itself
   (x+ an outflow copy), the red half reads black cells times keep and the
   black half reads the red cells' fresh pre-keep values;
3. the padded result (``_rebuild_padded``): interior ``fpre * keep``, faces
   the signed mirrors of the pre-keep edge, ghost edges and corners passed
   through from the input. Plain torch glue on the card too.

This equals ``ops.linsolve.relax`` with rbgs (the resident route,
``kernels/linsolve.py``) bit for bit. The plain version repeats the carry
algebra step by step and does not call ``relax``.

The route. Grids of ``STREAM_MIN_CELLS`` interior cells or more stream their
solves and projections; smaller ones stay on the resident kernels. The
constant sits between the 128x64x64 class (524,288 cells, whose padded field
and rhs, 4.5 MB, live in the H100's 50 MB L2 across the 30 half-sweeps of a
solve) and 256x128x128 (4,194,304 cells, 35 MB for the pair, 137 MB per
field at 512x256x256), where the JAX package's own gates split them at the
bench's grids. ``NSW`` = 2 sweeps per pass, as ``linsolve_mdma.mdma_params``
fixes it by measurement on the TPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build
from fluid_simulation_tpu_torch.ops.bounds import face_signs
from fluid_simulation_tpu_torch.ops.linsolve import as_scalar, neighbor_sum
from fluid_simulation_tpu_torch.scene.masks import red_parity

STREAM_MIN_CELLS = 1 << 22
NSW = 2
KERNEL_NSW = (1, 2)   # the pass depths the card's kernel is built for

# The pass kernel's z-march (csrc/rbgs_tile.cuh; tests hold these to its
# constants): a block's output tile in (x, y) at each pass depth, and its
# output planes.
MARCH_TILE = {1: (32, 16), 2: (32, 32)}
MARCH_CHUNK = 32


def streams(shape) -> bool:
    """True when a padded field of ``shape`` takes the streamed solve and
    projection (at least ``STREAM_MIN_CELLS`` interior cells)."""
    D, H, W = (n - 2 for n in shape)
    return D * H * W >= STREAM_MIN_CELLS


def _chain(one_pass, fpre, n_sweeps: int, nsw: int):
    """``n_sweeps`` sweeps as passes of ``nsw`` plus one remainder pass;
    ``one_pass(fpre, depth)`` runs one pass."""
    npass, rem = divmod(n_sweeps, nsw)
    for _ in range(npass):
        fpre = one_pass(fpre, nsw)
    if rem:
        fpre = one_pass(fpre, rem)
    return fpre


def _mirror_faces_(f, fpre, b, wall_mode):
    """Write padded ``f``'s six ghost faces as the signed mirrors of the
    pre-keep edges of ``fpre`` (x+ a plain copy); edges and corners stay."""
    sx, sy, sz = face_signs(b, wall_mode)
    f[1:-1, 1:-1, 0] = sx * fpre[:, :, 0]
    f[1:-1, 1:-1, -1] = fpre[:, :, -1]
    f[1:-1, 0, 1:-1] = sy * fpre[:, 0, :]
    f[1:-1, -1, 1:-1] = sy * fpre[:, -1, :]
    f[0, 1:-1, 1:-1] = sz * fpre[0]
    f[-1, 1:-1, 1:-1] = sz * fpre[-1]
    return f


def _sweep_(f, rhs_i, a, crec, red):
    """One red-black sweep of padded ``f``'s interior in place; the ghost
    cells are read, never written."""
    interior = f[1:-1, 1:-1, 1:-1]
    upd = lambda: (rhs_i + a * neighbor_sum(f)) * crec   # noqa: E731
    interior.copy_(torch.where(red, upd(), interior))
    interior.copy_(torch.where(red, interior, upd()))


def _consts(a, c, dtype):
    return (as_scalar(a, dtype),
            as_scalar(np.float32(1.0) / np.float32(c), dtype))


def sweep1_plain(field, rhs_i, a: float, c: float):
    """Sweep 1 in plain torch: the packed pre-keep field after one sweep of
    padded ``field`` (its own ghost faces) with interior rhs ``rhs_i``."""
    f = field.clone()
    _sweep_(f, rhs_i, *_consts(a, c, f.dtype),
            red_parity(rhs_i.shape, f.device))
    return f[1:-1, 1:-1, 1:-1].contiguous()


def pass_plain(fpre, rhs_i, keep_i: Optional[torch.Tensor], b: int, a: float,
               c: float, nsw: int, wall_mode: str = "reference"):
    """One pass in plain torch: the pre-keep carry ``nsw`` sweeps later.
    Each sweep reads a padded array whose interior is ``fpre * keep_i`` and
    whose faces are ``sign * fpre`` at the edge."""
    a, crec = _consts(a, c, fpre.dtype)
    red = red_parity(fpre.shape, fpre.device)
    for _ in range(nsw):
        f = F.pad(fpre if keep_i is None else fpre * keep_i, (1, 1) * 3)
        _mirror_faces_(f, fpre, b, wall_mode)
        _sweep_(f, rhs_i, a, crec, red)
        fpre = f[1:-1, 1:-1, 1:-1].contiguous()
    return fpre


def passes_plain(fpre, rhs_i, keep_i, b, a, c, n_sweeps, nsw, wall_mode):
    """``n_sweeps`` sweeps of the carry as plain passes of ``nsw``."""
    return _chain(lambda f, n: pass_plain(f, rhs_i, keep_i, b, a, c, n,
                                          wall_mode), fpre, n_sweeps, nsw)


def rebuild_padded(field, fpre, keep_i: Optional[torch.Tensor], b: int,
                   wall_mode: str = "reference"):
    """The padded solve result from the final carry: interior ``fpre *
    keep_i``, faces from the pre-keep edge, ghost edges and corners from
    ``field``."""
    out = field.clone()
    out[1:-1, 1:-1, 1:-1] = fpre if keep_i is None else fpre * keep_i
    return _mirror_faces_(out, fpre, b, wall_mode)


def rbgs_solve_stream_plain(b: int, field, prev, a: float, c: float,
                            acc: int = 15, wall_mode: str = "reference",
                            keep: Optional[torch.Tensor] = None,
                            nsw: int = NSW):
    """The streamed solve in plain torch (any ``nsw`` >= 1)."""
    if acc < 1:
        return field.clone()
    keep_i = None if keep is None else keep[1:-1, 1:-1, 1:-1]
    rhs_i = prev[1:-1, 1:-1, 1:-1]
    fpre = passes_plain(sweep1_plain(field, rhs_i, a, c), rhs_i, keep_i, b,
                        a, c, acc - 1, nsw, wall_mode)
    return rebuild_padded(field, fpre, keep_i, b, wall_mode)


def rbgs_solve_stream(b: int, field, prev, a: float, c: float, acc: int = 15,
                      wall_mode: str = "reference",
                      keep: Optional[torch.Tensor] = None, nsw: int = NSW):
    """Solve on padded ``field`` with right-hand side ``prev`` through
    passes of ``nsw`` sweeps; returns a new padded tensor, equal to
    ``kernels.linsolve.rbgs_solve``'s. ``keep`` is the padded obstacle
    multiplier (1 on the ghost shell). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels or raises."""
    if not _build.on_card(field):
        return rbgs_solve_stream_plain(b, field, prev, a, c, acc, wall_mode,
                                       keep, nsw)
    name = "rbgs_solve_stream" if keep is None else "rbgs_solve_stream_keep"
    _build.check_operands(name, (field, prev), (None, field.shape))
    if field.ndim != 3 or min(field.shape) < 3:
        raise ValueError(f"{name}: bad padded shape {tuple(field.shape)}")
    if nsw not in KERNEL_NSW:
        raise ValueError(f"{name}: nsw={nsw}; the pass kernel takes "
                         f"{KERNEL_NSW}")
    interior = tuple(n - 2 for n in field.shape)
    keep_i = None
    if keep is not None:
        keep_i = keep[1:-1, 1:-1, 1:-1]
        _build.mask_view(name, keep_i, interior, field.get_device())
    if acc < 1:
        return field.clone()
    rhs_i = prev[1:-1, 1:-1, 1:-1]
    fpre = field.new_empty(interior)
    _launch_sweep1(field, rhs_i, fpre, a, c)
    fpre = passes(fpre, rhs_i, keep_i, b, a, c, acc - 1, nsw, wall_mode)
    out = rebuild_padded(field, fpre, keep_i, b, wall_mode)
    LAUNCHES[name] += 1
    return out


def passes(fpre, rhs_i, keep_i, b, a, c, n_sweeps, nsw, wall_mode):
    """``n_sweeps`` sweeps of the carry ``fpre`` (a buffer the caller owns,
    overwritten) as kernel passes, ping-ponging between two buffers; returns
    the buffer that holds the result. The streamed projection runs its
    Poisson solve through here too."""
    spare = torch.empty_like(fpre)

    def one_pass(f, depth):
        nonlocal spare
        _launch_pass(f, rhs_i, keep_i, spare, b, a, c, depth, wall_mode)
        f, spare = spare, f
        return f

    return _chain(one_pass, fpre, n_sweeps, nsw)


def sweep1(field, rhs_i, a: float, c: float):
    """Sweep 1 alone (``rbgs_sweep1``), uncounted: the plain version for a
    CPU tensor, the kernel for a CUDA tensor. ``chip_smoke.py`` holds the
    two against each other."""
    if not _build.on_card(field):
        return sweep1_plain(field, rhs_i, a, c)
    _build.check_operands("rbgs_sweep1", (field,))
    out = field.new_empty(tuple(n - 2 for n in field.shape))
    _launch_sweep1(field, rhs_i, out, a, c)
    return out


def sweep_pass(fpre, rhs_i, keep_i, b: int, a: float, c: float, nsw: int,
               wall_mode: str = "reference"):
    """One pass alone (``rbgs_pass``), uncounted, as ``sweep1``."""
    if not _build.on_card(fpre):
        return pass_plain(fpre, rhs_i, keep_i, b, a, c, nsw, wall_mode)
    _build.check_operands("rbgs_pass", (fpre,))
    out = torch.empty_like(fpre)
    _launch_pass(fpre, rhs_i, keep_i, out, b, a, c, nsw, wall_mode)
    return out


def _launch_sweep1(field, rhs_i, out, a, c):
    D, H, W = out.shape
    dev = field.get_device()
    rp, rsz, rsy = _build.mask_view("rbgs_sweep1", rhs_i, (D, H, W), dev)
    a32, crec = (float(x) for x in _consts(a, c, torch.float32))
    _build.launch("fst_rbgs_sweep1", dev, _build.ptr(field), rp, rsz, rsy,
                  _build.ptr(out), D, H, W, a32, crec)


def _launch_pass(fin, rhs_i, keep_i, out, b, a, c, nsw, wall_mode):
    """One pass of ``nsw`` sweeps from ``fin`` into ``out`` (both packed)."""
    D, H, W = fin.shape
    dev = fin.get_device()
    rp, rsz, rsy = _build.mask_view("rbgs_pass", rhs_i, (D, H, W), dev)
    kp, ksz, ksy = (None, 0, 0) if keep_i is None else _build.mask_view(
        "rbgs_pass", keep_i, (D, H, W), dev)
    a32, crec = (float(x) for x in _consts(a, c, torch.float32))
    mask = _build.neg_mask([face_signs(b, wall_mode)])
    _build.launch("fst_rbgs_pass", dev, _build.ptr(fin), rp, rsz, rsy, kp,
                  ksz, ksy, _build.ptr(out), D, H, W, a32, crec, nsw, mask)


# ---- The pass kernel's plan, and a NumPy emulation of its march --------
#
# ``csrc/rbgs_tile.cuh`` says why the kernel marches z; these functions
# say what it does, step by step, in the kernel's own layout, so that the
# CPU tests can hold its plan to ``pass_plain`` and ``sweep1_plain`` bit
# for bit where the kernel itself cannot run.


def march_geometry(nsw: int):
    """``(M, L, LY, HW, R)`` of a pass of ``nsw`` sweeps: the halo (one
    cell a half-sweep), a ring plane's width and rows with it, a row's
    cells of one colour, and the ring's slots (the 2*nsw + 2 planes one
    march step reads, and one for the plane being loaded), which hold u,
    rhs and keep alike."""
    M, (tx, ty) = 2 * nsw, MARCH_TILE[nsw]
    L, LY = tx + 2 * M, ty + 2 * M
    return M, L, LY, L // 2, 2 * nsw + 3


def march_grid(shape, nsw: int, chunk: int = MARCH_CHUNK):
    """The kernel's grid on a (D, H, W) carry: (x tiles, y tiles,
    z-ranges)."""
    D, H, W = shape
    tx, ty = MARCH_TILE[nsw]
    return -(-W // tx), -(-H // ty), -(-D // chunk)


def march_planes(D: int, zs: int, ze: int, nsw: int, ghosts: bool):
    """``(zlo, zhi, zend)`` of the block that owns output planes [zs, ze):
    its first and last loaded planes (M = 2*nsw below and above, clipped to
    the domain, or to its ghost planes -1 and D with ``ghosts``) and its
    last march step; the march runs steps zlo .. zend."""
    M, lo = 2 * nsw, (-1 if ghosts else 0)
    return max(zs - M, lo), min(ze + M - 1, D - 1 - lo), ze - 1 + M


def half_planes(D: int, zs: int, ze: int, nsw: int, h: int):
    """The planes half-sweep ``h`` updates in the block of [zs, ze): the
    trapezoid's z extent [zs - M + h + 1, ze + M - 2 - h] in the domain."""
    M = 2 * nsw
    return max(zs - M + h + 1, 0), min(ze + M - 2 - h, D - 1)


def face_block(x0: int, y0: int, H: int, W: int, nsw: int) -> bool:
    """True when the block whose ring plane starts at (x0, y0) reaches past
    the domain's x or y faces: only such a block tests the domain and
    splices the faces (the others take a path without either)."""
    _, L, LY, _, _ = march_geometry(nsw)
    return x0 < 0 or y0 < 0 or x0 + L > W or y0 + LY > H


def _split(win, y0, q):
    """A ring plane in the kernel's layout: (LY, L) cells -> (2, LY, HW),
    half p holding a row's cells of packed parity p (x0 is even, so a
    row's even cells have parity (y0 + row + q) & 1)."""
    e = ((y0 + np.arange(win.shape[0]) + q) & 1)[:, None]
    ev, od = win[:, 0::2], win[:, 1::2]
    return np.stack([np.where(e == 0, ev, od), np.where(e == 0, od, ev)])


def _unsplit(halves, y0, q):
    e = ((y0 + np.arange(halves.shape[1]) + q) & 1)[:, None]
    win = np.empty((halves.shape[1], 2 * halves.shape[2]), halves.dtype)
    win[:, 0::2] = np.where(e == 0, halves[0], halves[1])
    win[:, 1::2] = np.where(e == 0, halves[1], halves[0])
    return win


def march_pass(fin, rhs_i, keep_i, b: int, a: float, c: float, nsw: int,
               wall_mode: str = "reference", *, padded: bool = False,
               variant: str = "full", chunk: int = MARCH_CHUNK):
    """The pass kernel's march in NumPy, block by block and step by step:
    the carry ``nsw`` sweeps later, as ``pass_plain`` (``padded``: the
    padded field after sweep 1, as ``sweep1_plain``; ``variant``: a
    sweep-cost variant, ``kernels/sweepcost.py``). f32 NumPy arrays in and
    out.

    Each block owns a tile of (x, y) output cells (``MARCH_TILE[nsw]``)
    and ``chunk`` output planes [zs, ze). It loads its ring planes with a
    halo of M = 2*nsw cells in x and y, split into colour halves
    (``_split``), into slot
    (q - zlo) % R of an R-slot ring. March step j: plane j+1 is read into
    registers, half-sweep h = 0 .. 2*nsw-1 updates the cells of its
    colour (red, odd parity, for even h) on plane j-1-h within the region
    [h+1, L-2-h] x [h+1, LY-2-h] (which shrinks a cell a side a half) and
    ``half_planes``, plane j+1 goes into its slot just before the last
    half, and plane j-M, now final, is stored where it is an output
    plane."""
    tile = MARCH_TILE[nsw]
    M, L, LY, HW, R = march_geometry(nsw)
    f32 = np.float32
    a, crec = f32(a), f32(1.0) / f32(c)
    sx, sy, sz = (f32(s) for s in face_signs(b, wall_mode))
    D, H, W = rhs_i.shape
    out = np.zeros((D, H, W), f32)
    keep = keep_i is not None
    ghosts = padded or variant == "nosel"
    splice = not ghosts
    arith = variant == "arith"
    rows = np.arange(LY)[:, None]
    ks = np.arange(HW)[None, :]

    def window(src, q, x0, y0, pad):
        """Plane q's (LY, L) window from x0, y0: ``src`` is packed, or
        padded with ``pad``; zeros outside what it holds."""
        win = np.zeros((LY, L), f32)
        lo, (Ds, Hs, Ws) = -pad, (n - 2 * pad for n in src.shape)
        if not lo <= q < Ds - lo:
            return win
        ys = slice(max(y0, lo), min(y0 + LY, Hs - lo))
        xs = slice(max(x0, lo), min(x0 + L, Ws - lo))
        win[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = src[
            q + pad, ys.start + pad:ys.stop + pad,
            xs.start + pad:xs.stop + pad]
        return win

    gx_, gy_, gz_ = march_grid((D, H, W), nsw, chunk)
    for bz in range(gz_):
        zs, ze = bz * chunk, min(bz * chunk + chunk, D)
        zlo, zhi, zend = march_planes(D, zs, ze, nsw, ghosts)
        for by in range(gy_):
            for bx in range(gx_):
                x0, y0 = bx * tile[0] - M, by * tile[1] - M
                face = face_block(x0, y0, H, W, nsw)
                u = np.zeros((R, 2, LY, HW), f32)
                rh = np.zeros((R, 2, LY, HW), f32)
                ub = np.zeros((R, LY, HW), f32)     # black cells' u*keep
                kb = np.zeros((R, LY, HW), f32)     # black cells' keep

                def read(q):
                    """Plane q as the prefetch reads it: u, rhs, keep."""
                    return (_split(window(fin, q, x0, y0, int(padded)), y0,
                                   q),
                            _split(window(rhs_i, q, x0, y0, 0), y0, q),
                            None if not keep else
                            _split(window(keep_i, q, x0, y0, 0), y0, q))

                def write(q, plane):
                    s = (q - zlo) % R
                    u[s], rh[s] = plane[0], plane[1]
                    if keep:                        # black: parity 0
                        kb[s] = plane[2][0]
                        ub[s] = u[s, 0] * kb[s]

                def update(h, q):
                    s, sp, sm = ((q + d - zlo) % R for d in (0, 1, -1))
                    for p in ((0, 1) if arith else (1 - (h & 1),)):
                        off = (p + y0 + rows + q) & 1
                        lx = 2 * ks + off
                        gx, gy = x0 + lx, y0 + rows
                        mask = ((rows >= h + 1) & (rows <= LY - 2 - h)
                                & (lx >= h + 1) & (lx <= L - 2 - h))
                        if face and variant != "noiota":
                            mask &= (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H)
                        own = u[s, p]
                        if arith:
                            new = (rh[s, p] + a * (f32(6.0) * own)) * crec
                            u[s, p] = np.where(mask, new, own)
                            continue
                        red_keep = keep and p == 1

                        def other(t):
                            return ub[t] if red_keep else u[t, 1 - p]

                        o = other(s)
                        rr = np.broadcast_to(rows, lx.shape)
                        kx = np.broadcast_to(ks, lx.shape)
                        xp = o[rr, np.minimum(kx + off, HW - 1)]
                        xm = o[rr, np.maximum(kx + off - 1, 0)]
                        yp = o[np.minimum(rr + 1, LY - 1), kx]
                        ym = o[np.maximum(rr - 1, 0), kx]
                        zp, zm = other(sp), other(sm)
                        if splice and face:
                            xp = np.where(gx == W - 1, own, xp)
                            xm = np.where(gx == 0, sx * own, xm)
                            yp = np.where(gy == H - 1, sy * own, yp)
                            ym = np.where(gy == 0, sy * own, ym)
                        if splice and q == D - 1:
                            zp = sz * own
                        if splice and q == 0:
                            zm = sz * own
                        if variant == "noroll":
                            xp = xm = yp = ym = own
                        if variant == "nozn":
                            zp = zm = own
                        t = ((((xp + xm) + yp) + ym) + zp) + zm
                        new = (rh[s, p] + a * t) * crec
                        u[s, p] = np.where(mask, new, own)
                        if keep and p == 0:
                            ub[s] = np.where(mask, new * kb[s], ub[s])

                write(zlo, read(zlo))
                for j in range(zlo, zend + 1):
                    pending = read(j + 1) if j + 1 <= zhi else None
                    for h in range(2 * nsw):
                        if h == 2 * nsw - 1 and pending is not None:
                            write(j + 1, pending)
                        lo, hi = half_planes(D, zs, ze, nsw, h)
                        if lo <= j - 1 - h <= hi:
                            update(h, j - 1 - h)
                    q = j - M
                    if zs <= q < ze:
                        win = _unsplit(u[(q - zlo) % R], y0, q)[M:M + tile[1],
                                                               M:M + tile[0]]
                        ys = slice(y0 + M, min(y0 + M + tile[1], H))
                        xs = slice(x0 + M, min(x0 + M + tile[0], W))
                        out[q, ys, xs] = win[:ys.stop - ys.start,
                                             :xs.stop - xs.start]
    return out
