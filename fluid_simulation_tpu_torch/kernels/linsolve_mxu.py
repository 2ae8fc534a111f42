"""ROADMAP B23: the tensor-core probe's solve (``csrc/rbgs_mxu.cu``), the
empty-scene b = 0 RBGS solve with the x-neighbour pair from an FP64
tensor-core product, and its plain torch version.

Port of ``tools/exp_solve_mxu.py::make_mxu_solve`` (:31): ``acc``
red-black sweeps of ``f = (prev + a*s) * (1/c)`` on a padded (D+2, H+2,
W+2) f32 field, ``s = ((((xs + y+) + y-) + z+) + z-)`` with the x pair
``xs = f.reshape(D2*H2, W2) @ Bx`` for the band matrix ``Bx[w', k] = (w'
== k) | (w' == k + 2)``, red (padded z + y + x even) then black, and the six
ghost faces copied from their edge cells after every sweep (b = 0: every
sign +1; edges and corners untouched). It is bitwise to the resident solve,
``kernels.linsolve.rbgs_solve(0, ..., packed=False)`` (K1), the base the
probe times it against.

The kernel computes the band's three non-zero 8 x 4 x 8 blocks per output
tile with ``mma.sync`` in f64 (exact: every product is f * 1 or f * 0); the
plain version takes the dense product in f64, rounded to f32 once, as the
tool's f32 dot rounds the two-term sum once. The probe that times it is
``fluid_simulation_tpu_torch/tools/exp_solve_mxu.py``; no route of the wind
tunnel calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_simulation_tpu_torch.kernels import LAUNCHES, _build

A, C = 1.0, 6.0   # the tool's coefficients (exp_solve_mxu.py:137-138)


def _coeffs(a, c):
    """``a`` and ``1/c`` rounded to f32, as the tool rounds them (:42-43)."""
    return float(np.float32(a)), float(np.float32(1.0) / np.float32(c))


def band_flops(shape, acc: int):
    """(band, dense) tensor-core flops of one solve on the padded
    ``shape``: the kernel's 3 k-steps of 8 x 8 x 4 per 8 x 8 tile of each
    half-sweep's interior, against the tool's dense (D2*H2, W2) @ (W2, W)."""
    D2, H2, W2 = shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    tiles = D * -(-H // 8) * -(-W // 8)
    band = 2 * acc * tiles * 3 * 2 * 8 * 8 * 4
    dense = 2 * acc * 2 * D2 * H2 * W2 * W
    return band, dense


def rbgs_solve_mxu_plain(field: torch.Tensor, prev: torch.Tensor,
                         a: float = A, c: float = C,
                         acc: int = 15) -> torch.Tensor:
    """The tool's kernel body in plain torch (module docstring)."""
    _check(field, prev, acc)
    D2, H2, W2 = field.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    a32, crec = _coeffs(a, c)
    dev = field.device
    iw = torch.arange(W2, device=dev).reshape(W2, 1)
    kw = torch.arange(W, device=dev).reshape(1, W)
    bx = ((iw == kw) | (iw == kw + 2)).to(torch.float64)
    iz, iy, ix = torch.meshgrid(*(torch.arange(n, device=dev)
                                  for n in (D, H, W)), indexing="ij")
    red = ((iz + iy + ix) % 2) == 1
    prev_i = prev[1:-1, 1:-1, 1:-1]
    out = field.clone()

    def half(sel):
        f = out
        xs = (f.reshape(D2 * H2, W2).to(torch.float64) @ bx).to(
            torch.float32).reshape(D2, H2, W)[1:-1, 1:-1, :]
        s = ((((xs + f[1:-1, 2:, 1:-1]) + f[1:-1, :-2, 1:-1])
              + f[2:, 1:-1, 1:-1]) + f[:-2, 1:-1, 1:-1])
        upd = (prev_i + a32 * s) * crec
        out[1:-1, 1:-1, 1:-1] = torch.where(sel, upd, f[1:-1, 1:-1, 1:-1])

    for _ in range(acc):
        half(red)
        half(~red)
        out[1:-1, 1:-1, 0] = out[1:-1, 1:-1, 1]
        out[1:-1, 1:-1, W + 1] = out[1:-1, 1:-1, W]
        out[1:-1, 0, 1:-1] = out[1:-1, 1, 1:-1]
        out[1:-1, H + 1, 1:-1] = out[1:-1, H, 1:-1]
        out[0, 1:-1, 1:-1] = out[1, 1:-1, 1:-1]
        out[D + 1, 1:-1, 1:-1] = out[D, 1:-1, 1:-1]
    return out


def rbgs_solve_mxu(field: torch.Tensor, prev: torch.Tensor, a: float = A,
                   c: float = C, acc: int = 15) -> torch.Tensor:
    """The solve on padded ``field`` with right-hand side ``prev`` as a new
    tensor. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (2 * acc half-sweep launches, one count) or raises."""
    _check(field, prev, acc)
    if not _build.on_card(field):
        return rbgs_solve_mxu_plain(field, prev, a, c, acc)
    name = "rbgs_solve_mxu"
    _build.check_operands(name, (field, prev), (None, field.shape))
    out = field.clone()
    _launch(out, prev, a, c, acc)
    LAUNCHES[name] += 1
    return out


def _check(field, prev, acc):
    if field.ndim != 3 or min(field.shape) < 3 or acc < 0:
        raise ValueError(f"rbgs_solve_mxu: bad padded shape "
                         f"{tuple(field.shape)} or acc {acc}")
    if tuple(prev.shape) != tuple(field.shape):
        raise ValueError(f"rbgs_solve_mxu: prev {tuple(prev.shape)} is not "
                         f"shaped like the field {tuple(field.shape)}")


def _launch(out, prev, a, c, acc):
    D, H, W = (n - 2 for n in out.shape)
    a32, crec = _coeffs(a, c)
    ptr, dev = _build.ptr, out.get_device()
    for _ in range(acc):
        for color in (0, 1):
            _build.launch("fst_rbgs_half_mxu", dev, ptr(out), ptr(prev), D, H,
                          W, a32, crec, color)
