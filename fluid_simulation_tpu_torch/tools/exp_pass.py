"""The streamed pass kernel's production forms on the card, timed as
CUDA-graph replays beside their plain versions and their bounds.

    python -m fluid_simulation_tpu_torch.tools.exp_pass [--device cuda]
        [--shape W H D] [--n 10]

The forms the big-grid route launches (``kernels/linsolve_stream.py``):
sweep 1 on the padded field, and one pass of 1 and of 2 sweeps of the
carry, on an empty scene and with a keep mask. Each row is a chain
``c = row(c)`` from ``c = 0.1`` everywhere, with the rhs ``r = 1.5c +
0.25``, b = 1, reference walls, a = 1e-4 and c = 1.0006 (``exp_hbm2``'s
production call); sweep 1 reads a padded field of 0.1 whatever ``c`` is.
The keep mask is the interior of ``keep_vel`` of the bench's sphere at the
bench's big grids (``scene.primitives.big_sphere``), elsewhere of a sphere
of radius min(W, H, D)/4 at the centre. A keep row runs the pass as the
step does: the blocks its mask's table clears (``linsolve_stream.
march_table``, built at the row's first call) take the keep-free form.

A row prints its µs per call (``tools/_timing.replay_slope``: the chains
of n and 3n calls each one captured graph, the best of 3 of
``(t(3n) - t(n)) / 2n``), its plain version's, its bound, the ratio of
the two, and the blocks of the form an SM holds at once
(``linsolve_stream.march_blocks_per_sm``). The bound is the bytes the call
must move at 3.35 TB/s: a pass reads the carry, the rhs and the keep once
and writes the carry once; sweep 1 reads the padded field and the rhs and
writes the carry.

``--device cpu`` runs every row's plain version on the host clock at
whatever ``--shape`` is given (a test runs it tiny); it prints no bound.
"""

from __future__ import annotations

import torch

from fluid_simulation_tpu_torch.kernels import linsolve_stream as ls
from fluid_simulation_tpu_torch.scene.masks import build_masks
from fluid_simulation_tpu_torch.scene.primitives import (
    BIG_SPHERES, add_sphere, big_sphere, empty_obstacles)
from fluid_simulation_tpu_torch.tools import exp_hbm, exp_hbm2
from fluid_simulation_tpu_torch.tools._timing import (
    HBM_BYTES_PER_S, clock_line)

B, A, C = exp_hbm2.PASS_B, exp_hbm2.PASS_A, exp_hbm2.PASS_C


def keep_mask(shape, device):
    """The interior keep mask of the rows' sphere on a (W, H, D) grid."""
    W, H, D = shape
    obs = (big_sphere(W, H, D) if (W, H, D) in BIG_SPHERES else
           add_sphere(empty_obstacles(W, H, D), W // 2, H // 2, D // 2,
                      min(W, H, D) / 4))
    return build_masks(obs, device=device).keep_vel[1:-1, 1:-1, 1:-1]


def rows(device="cuda", shape=(256, 256, 256)):
    """``(c0, [(name, kernel, plain, bound bytes, form)])``: the carry and
    each form as a map of it (``shape`` is (W, H, D)); ``form`` is the
    form's ``(nsw, keep, padded)``."""
    W, H, D = shape
    c0 = torch.full((D, H, W), 0.1, device=device)
    r = c0 * 1.5 + 0.25
    field = torch.full((D + 2, H + 2, W + 2), 0.1, device=device)
    keep = keep_mask(shape, device)
    A_ = c0.numel() * c0.element_size()
    out = [("sweep1", lambda c: ls.sweep1(field, r, A, C),
            lambda c: ls.sweep1_plain(field, r, A, C),
            field.numel() * field.element_size() + 2 * A_, (1, False, True))]
    for nsw in ls.KERNEL_NSW:
        for k, tag in ((None, ""), (keep, " keep")):
            out.append((
                f"pass nsw={nsw}{tag}",
                lambda c, k=k, n=nsw: ls.sweep_pass(c, r, k, B, A, C, n),
                lambda c, k=k, n=nsw: ls.pass_plain(c, r, k, B, A, C, n),
                (3 if k is None else 4) * A_, (nsw, k is not None, False)))
    return c0, out


def main(argv=None) -> int:
    args = exp_hbm.parse(argv, __doc__)
    device = torch.device(args.device)
    W, H, D = args.shape
    print(f"exp_pass {W}x{H}x{D}: {clock_line('exp_pass', device)}, "
          f"n = {args.n}", flush=True)
    c0, forms = rows(device, tuple(args.shape))
    for name, kernel, plain, nbytes, form in forms:
        sec = exp_hbm.measure(kernel, c0, args.n, device)
        psec = exp_hbm.measure(plain, c0, args.n, device)
        line = (f"{name:18s} {sec * 1e6:10.2f} us  plain "
                f"{psec * 1e6:11.2f} us")
        if device.type == "cuda":
            bound = nbytes / HBM_BYTES_PER_S
            line += (f"  bound {bound * 1e6:9.2f} us ({nbytes / 1e6:.2f} "
                     f"MB)  {sec / bound:6.3f} x bound  "
                     f"{ls.march_blocks_per_sm(*form, device=device)} "
                     f"blocks/SM")
        else:
            line += "  (host clock; no bound)"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
