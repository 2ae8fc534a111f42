"""Linear solver (6-neighbour relaxation) and diffusion
(``fluid_simulation_tpu/ops/linsolve.py``).

The reference runs ``acc`` in-place Gauss-Seidel sweeps with ``setBounds``
after every sweep (simulation.cpp:251-273). Three deterministic orderings:

- ``jacobi``:       f_new = (prev + a*sum6(f_old)) / c, fully parallel;
- ``rbgs``:         red-black Gauss-Seidel, two parallel half-sweeps; on a
                    CUDA tensor with ``use_pallas`` it runs the hand-written
                    kernel (``kernels/linsolve.py``);
- ``gs_wavefront``: hyperplane (x+y+z = const) ordering, numerically
                    identical to the 1-thread reference sweep (goldens).

The per-cell update keeps the reference's operand order
(simulation.cpp:263-269): ``(prev + a*((x+1)+(x-1)+(y+1)+(y-1)+(z+1)+(z-1)))
* (1/c)`` with the reciprocal precomputed in f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fluid_simulation_tpu_torch.ops.bounds import write_faces_
from fluid_simulation_tpu_torch.scene.masks import SceneMasks, red_parity


def as_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to f32 and then to ``dtype``, as a Python float: the
    value the JAX package gets from ``jnp.asarray(np.float32(x), dtype)``.
    Torch applies a Python scalar at the op's compute precision, so the
    rounding has to happen here."""
    return float(torch.tensor(float(np.float32(x)), dtype=dtype))


def neighbor_sum(f: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbours over the interior, in the reference's
    left-associated add order (simulation.cpp:266-268)."""
    return (
        (((f[1:-1, 1:-1, 2:] + f[1:-1, 1:-1, :-2])
          + f[1:-1, 2:, 1:-1]) + f[1:-1, :-2, 1:-1])
        + f[2:, 1:-1, 1:-1]
    ) + f[:-2, 1:-1, 1:-1]


def _update(f, prev_i, a, c_recip):
    return (prev_i + a * neighbor_sum(f)) * c_recip


def _wavefront_stages(interior_shape, device):
    """Flat padded indices of the interior cells of each hyperplane
    x+y+z = s (1-based), for s = 3 .. W+H+D in order."""
    D, H, W = interior_shape
    z, y, x = torch.meshgrid(torch.arange(1, D + 1), torch.arange(1, H + 1),
                             torch.arange(1, W + 1), indexing="ij")
    csum = (z + y + x).reshape(-1)
    flat = ((z * (H + 2) + y) * (W + 2) + x).reshape(-1)
    order = torch.argsort(csum, stable=True)
    counts = torch.bincount(csum, minlength=W + H + D + 1)[3:].tolist()
    return [s.to(device) for s in torch.split(flat[order], counts)]


def relax(b: int, f: torch.Tensor, prev: torch.Tensor, a: float, c: float,
          keep: Optional[torch.Tensor] = None, acc: int = 15,
          solver: str = "rbgs",
          wall_mode: str = "reference") -> torch.Tensor:
    """``acc`` sweeps of ``f = (prev + a*sum6(f))/c``, each followed by the
    ghost faces of ``b`` and then the ``keep`` multiply (``None`` for an
    empty scene). Plain torch on any device; works on its own clone of
    ``f``, in place, and returns it."""
    dtype = f.dtype
    a = as_scalar(a, dtype)
    c_recip = as_scalar(np.float32(1.0) / np.float32(c), dtype)
    f = f.clone()
    prev_i = prev[1:-1, 1:-1, 1:-1]
    interior = f[1:-1, 1:-1, 1:-1]

    if solver == "jacobi":
        def sweep():
            interior.copy_(_update(f, prev_i, a, c_recip))
    elif solver == "rbgs":
        red = red_parity(interior.shape, f.device)

        def sweep():
            interior.copy_(torch.where(red, _update(f, prev_i, a, c_recip),
                                       interior))
            interior.copy_(torch.where(red, interior,
                                       _update(f, prev_i, a, c_recip)))
    elif solver == "gs_wavefront":
        flat, prev_flat = f.view(-1), prev.reshape(-1)
        sy, sz = f.shape[2], f.shape[1] * f.shape[2]
        # per stage: its cells, their six neighbours in the reference's add
        # order (one gather), and their rhs (prev does not change)
        offs = torch.tensor([1, -1, sy, -sy, sz, -sz],
                            device=f.device).reshape(6, 1)
        stages = [(idx, idx + offs, prev_flat[idx])
                  for idx in _wavefront_stages(interior.shape, f.device)]

        def sweep():
            # only the hyperplane's cells change in a stage, so updating
            # them alone equals the full-array select of the JAX package
            for idx, nbr, prev_s in stages:
                g = flat[nbr]
                s = ((((g[0] + g[1]) + g[2]) + g[3]) + g[4]) + g[5]
                flat[idx] = (prev_s + a * s) * c_recip
    else:
        raise ValueError(f"unknown solver {solver!r}")

    for _ in range(acc):
        sweep()
        write_faces_(f, b, wall_mode)
        if keep is not None:
            f.mul_(keep)
    return f


def linear_solver(
    b: int,
    f: torch.Tensor,
    prev: torch.Tensor,
    a: float,
    c: float,
    masks: SceneMasks,
    acc: int = 15,
    solver: str = "rbgs",
    wall_mode: str = "reference",
    use_pallas: bool = False,
    empty_scene: bool = False,
) -> torch.Tensor:
    """Run ``acc`` relaxation sweeps with boundary conditions after each
    (simulation.cpp:271). With ``use_pallas`` and ``solver='rbgs'`` this is
    a kernel wrapper, which launches on a CUDA tensor or raises: the
    streamed solve on big grids (``kernels.linsolve_stream.streams``), the
    resident one otherwise."""
    keep = None if empty_scene else (
        masks.keep_vel if b in (1, 2, 3) else masks.keep_scalar)
    if use_pallas and solver == "rbgs":
        from fluid_simulation_tpu_torch.kernels import linsolve_stream
        from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
        fn = (linsolve_stream.rbgs_solve_stream
              if linsolve_stream.streams(f.shape) else rbgs_solve)
        return fn(b, f, prev, a, c, acc=acc, wall_mode=wall_mode, keep=keep)
    return relax(b, f, prev, a, c, keep, acc=acc, solver=solver,
                 wall_mode=wall_mode)


def diffusion_coeffs(width: int, height: int, depth: int, dt: float,
                     diff: float):
    """``a = dt*diff*W*H*D`` and ``c = 1+6a`` in f32 with the reference's
    evaluation order (simulation.cpp:282-283)."""
    a = np.float32(dt) * np.float32(diff)
    a = a * np.float32(width) * np.float32(height) * np.float32(depth)
    c = np.float32(1.0) + np.float32(6.0) * a
    return float(a), float(c)


def diffuse(
    b: int,
    f: torch.Tensor,
    prev: torch.Tensor,
    masks: SceneMasks,
    dt: float,
    diff: float,
    acc: int = 15,
    solver: str = "rbgs",
    wall_mode: str = "reference",
    use_pallas: bool = False,
    empty_scene: bool = False,
) -> torch.Tensor:
    """Diffusion (simulation.cpp:278-284); the caller chooses the
    coefficient, as in the reference."""
    D2, H2, W2 = f.shape
    a, c = diffusion_coeffs(W2 - 2, H2 - 2, D2 - 2, dt, diff)
    return linear_solver(b, f, prev, a, c, masks, acc=acc, solver=solver,
                         wall_mode=wall_mode, use_pallas=use_pallas,
                         empty_scene=empty_scene)
