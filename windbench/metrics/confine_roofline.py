"""confine_roofline: vorticity confinement's share of its bytes bound.

The entry point is ``kernels.vorticity.confinement``, which a step with
``vorticity`` > 0 calls once, between the velocity advection's padding and
the second projection. A call's bound moves what the confinement has to
move, each once, at 3.35 TB/s: the three padded velocities and the interior
keep mask in, the three padded outputs out. The curl and |curl| that the
kernel keeps between its launches are its own scratch, which a kernel that
recomputes them where it needs them never stores, so they are not counted.
At 512x256x256 that is 955,351,232 B a call, 0.2852 ms. The share is the
bound of every call in the traced frames over the device time of the
kernels each call launched. A cell whose traced frames made no such call
(vorticity 0) reads nothing.
"""

PEAK_BYTES_PER_S = 3.35e12
ENTRIES = ("fluid_simulation_tpu_torch.kernels.vorticity:confinement",)


def bytes_moved(D: int, H: int, W: int) -> int:
    padded, interior = (D + 2) * (H + 2) * (W + 2), D * H * W
    return 4 * (3 * padded + interior + 3 * padded)


def call_bytes(fname, args, kwargs) -> int:
    """``confinement(vx, vy, vz, keep_vel_i, eps, dt)``: ``vx`` padded."""
    D, H, W = (n - 2 for n in args[0].shape)
    return bytes_moved(D, H, W)


def read(run):
    got = run.entry("confine_roofline")
    if got is None or got[1] <= 0:
        return None
    nbytes, seconds = got
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
