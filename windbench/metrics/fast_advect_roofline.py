"""fast_advect_roofline: fast advection's velocity samples as a share of
their bytes bound.

The entry points are ``ops.advect.backtrace`` and ``ops.advect.gather``,
which fast's velocity branch of the step calls once and three times: one
backtrace through the projected velocity, then each saved component
sampled there. The bound counts only what the sampling has to move, each
once, at 3.35 TB/s: the backtrace reads three velocity interiors; a gather
reads its padded ``prev`` and writes one interior. The backtrace's
coordinates are the calls' own intermediate data, which a sampler that
computes them where it samples never stores, so they are not counted. At
512x256x256 that is 402,653,184 B for the backtrace and 271,073,312 for
each gather, 1,215,873,120 B a step, 0.3629 ms. The share is the bound of
every call in the traced frames over the device time of the kernels each
call launched. A sampler that replaces both calls keeps one of these entry
points, or an entry point this reader wraps, doing the three samples. On
the card fast advects its density in one ``ops.advect.advect`` call, whole
in one kernel, which calls neither entry point; a cell whose traced frames
made no such call (split, and compat on the card) reads nothing.
"""

PEAK_BYTES_PER_S = 3.35e12
ENTRIES = ("fluid_simulation_tpu_torch.ops.advect:backtrace",
           "fluid_simulation_tpu_torch.ops.advect:gather")


def backtrace_bytes(D: int, H: int, W: int) -> int:
    return 4 * 3 * D * H * W


def gather_bytes(D: int, H: int, W: int) -> int:
    return 4 * ((D + 2) * (H + 2) * (W + 2) + D * H * W)


def call_bytes(fname, args, kwargs) -> int:
    """``backtrace(vx_i, vy_i, vz_i, dt, W, H, D, dtype)``: interiors;
    ``gather(prev, xb, yb, zb, sample)``: ``prev`` one padded field."""
    if fname == "backtrace":
        return backtrace_bytes(*args[0].shape)
    D, H, W = (n - 2 for n in args[0].shape)
    return gather_bytes(D, H, W)


def read(run):
    got = run.entry("fast_advect_roofline")
    if got is None or got[1] <= 0:
        return None
    nbytes, seconds = got
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
