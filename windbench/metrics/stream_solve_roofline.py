"""stream_solve_roofline: the streamed solve's share of its bytes bound.

The entry point is ``kernels.linsolve_stream.rbgs_solve_stream``, which the
big-grid route calls for each diffusion. A call's bound reads the padded
field, the interior of the right-hand side and, with obstacles, the
interior of the keep mask once, and writes the padded field once, at the
H100's published 3.35 TB/s. The share is the bound of every call in the
traced frames over the device time of the kernels each call launched. The
count is of the entry point's work, whatever passes run behind it. A cell
whose traced frames made no streamed solve reads nothing.
"""

PEAK_BYTES_PER_S = 3.35e12
ENTRIES = ("fluid_simulation_tpu_torch.kernels.linsolve_stream:"
           "rbgs_solve_stream",)


def bytes_moved(D: int, H: int, W: int, keep: bool) -> int:
    padded, interior = (D + 2) * (H + 2) * (W + 2), D * H * W
    return 4 * (2 * padded + interior + (interior if keep else 0))


def call_bytes(fname, args, kwargs) -> int:
    """``rbgs_solve_stream(b, field, prev, a, c, acc, wall_mode, keep)``."""
    keep = kwargs["keep"] if "keep" in kwargs else (
        args[7] if len(args) > 7 else None)
    D, H, W = (n - 2 for n in args[1].shape)
    return bytes_moved(D, H, W, keep is not None)


def read(run):
    got = run.entry("stream_solve_roofline")
    if got is None or got[1] <= 0:
        return None
    nbytes, seconds = got
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
