"""stream_project_roofline: the streamed projection's share of its bytes
bound.

The entry points are ``kernels.project_stream.project_stream`` (empty
scene) and ``project_stream_masked`` (obstacles), which the big-grid route
calls twice a step; each returns the projected interiors (3, D, H, W) for
the padding tail. A call's bound reads what the divergence and the
gradient need of the padded velocities once (vx over the interior's y-z
rows with both x ghosts, vy with both y ghosts, vz with both z ghosts)
and, with obstacles, the interior fluid mask, and writes the three
interiors once, at 3.35 TB/s. The share is the bound of every call in the
traced frames over the device time of the kernels each call launched. A
cell whose traced frames made no streamed projection reads nothing.
"""

PEAK_BYTES_PER_S = 3.35e12
ENTRIES = tuple(f"fluid_simulation_tpu_torch.kernels.project_stream:{f}"
                for f in ("project_stream", "project_stream_masked"))


def bytes_moved(D: int, H: int, W: int, masked: bool) -> int:
    interior = D * H * W
    reads = D * H * (W + 2) + D * (H + 2) * W + (D + 2) * H * W
    return 4 * (reads + (interior if masked else 0) + 3 * interior)


def call_bytes(fname, args, kwargs) -> int:
    """``project_stream(vx, vy, vz, ...)`` or
    ``project_stream_masked(vx, vy, vz, fluid_i, ...)``."""
    D, H, W = (n - 2 for n in args[0].shape)
    return bytes_moved(D, H, W, fname == "project_stream_masked")


def read(run):
    got = run.entry("stream_project_roofline")
    if got is None or got[1] <= 0:
        return None
    nbytes, seconds = got
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
