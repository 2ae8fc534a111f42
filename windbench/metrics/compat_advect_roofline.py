"""compat_advect_roofline: compat advection's share of its bytes bound.

The entry point is ``ops.advect.advect``, which a compat step calls four
times: the chained velocity components ``b`` 1-3, then density (0). Each
call backtraces, samples and sets the bounds (``backtrace``, ``gather``
and ``set_bounds`` run inside it, so they are no entry points of their
own). A call's bound reads its padded field ``prev`` once, the interiors
of the velocity components that the backtrace takes from the other fields
once (two for a velocity component, whose own comes from ``prev``; three
for density), and in obstacle scenes ``fluid_i`` and the padded keep mask
once, and writes the padded result once, at 3.35 TB/s. The share is the
bound of every call in the traced frames over the device time of the
kernels each call launched. A cell whose traced frames made no compat
advection reads nothing (split); fast advects only its density through
``advect``.
"""

PEAK_BYTES_PER_S = 3.35e12
ENTRIES = ("fluid_simulation_tpu_torch.ops.advect:advect",)


def bytes_moved(D: int, H: int, W: int, velocity: bool,
                masked: bool) -> int:
    interior = D * H * W
    padded = (D + 2) * (H + 2) * (W + 2)
    reads = 2 if velocity else 3
    return 4 * (2 * padded + reads * interior
                + (interior + padded if masked else 0))


def call_bytes(fname, args, kwargs) -> int:
    """``advect(b, prev, vx, vy, vz, masks, dt, wall_mode, empty_scene,
    sample)``: ``prev`` one padded field; ``empty_scene`` positional or by
    keyword, False by default."""
    b, prev = args[0], args[1]
    empty = args[8] if len(args) > 8 else kwargs.get("empty_scene", False)
    D, H, W = (n - 2 for n in prev.shape)
    return bytes_moved(D, H, W, b in (1, 2, 3), not empty)


def read(run):
    got = run.entry("compat_advect_roofline")
    if got is None or got[1] <= 0:
        return None
    nbytes, seconds = got
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
