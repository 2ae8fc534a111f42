"""advect_split_roofline: split advection's share of its bytes bound.

The entry point is ``kernels.advect_split.advect_split``, which a split
step calls for the velocity stack and for density. A call's bound reads
its padded field(s) once and what the three passes need of the velocities
once (vx over every (z, y) row of the padded grid at the interior x, vy
over every z row at the interior (y, x), vz over the interior), and writes
the advected interior of each field once, at 3.35 TB/s. The share is the
bound of every call in the traced frames over the device time of the
kernels each call launched. A cell whose traced frames made no kernel
advection reads nothing.
"""

PEAK_BYTES_PER_S = 3.35e12
ENTRIES = ("fluid_simulation_tpu_torch.kernels.advect_split:advect_split",)


def bytes_moved(D: int, H: int, W: int, fields: int = 3) -> int:
    padded, interior = (D + 2) * (H + 2) * (W + 2), D * H * W
    vel = (D + 2) * (H + 2) * W + (D + 2) * H * W + interior
    return 4 * (fields * padded + vel + fields * interior)


def call_bytes(fname, args, kwargs) -> int:
    """``advect_split(prev, vx, vy, vz, dt)``: ``prev`` one padded field or
    a stack of them."""
    prev = args[0]
    fields = 1 if prev.ndim == 3 else prev.shape[0]
    D, H, W = (n - 2 for n in args[1].shape)
    return bytes_moved(D, H, W, fields)


def read(run):
    got = run.entry("advect_split_roofline")
    if got is None or got[1] <= 0:
        return None
    nbytes, seconds = got
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
