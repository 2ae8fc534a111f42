"""pad_bounds_roofline: the padding tail's share of its bytes bound.

The entry point is ``kernels.bounds.pad_bounds``, which a split step on
the streamed route calls four times (the velocity stack after advection
and after each streamed projection, and density) and on the resident
route twice. A call's bound reads its B interiors (B, D, H, W) once and,
in obstacle scenes, ``fluid_i`` and ``keep_i`` once for all fields, and
writes the B padded fields (B, D+2, H+2, W+2) once, at 3.35 TB/s. The
share is the bound of every call in the traced frames over the device
time of the kernels each call launched. A cell whose traced frames made no
kernel padding reads nothing.
"""

PEAK_BYTES_PER_S = 3.35e12
ENTRIES = ("fluid_simulation_tpu_torch.kernels.bounds:pad_bounds",)


def bytes_moved(D: int, H: int, W: int, fields: int, masked: bool) -> int:
    interior = D * H * W
    padded = (D + 2) * (H + 2) * (W + 2)
    return 4 * (fields * (interior + padded) + (2 * interior if masked else 0))


def call_bytes(fname, args, kwargs) -> int:
    """``pad_bounds(smp, bs, wall_mode, fluid_i, keep_i)``: ``smp`` one
    interior (D, H, W) or a stack of them; masked where ``fluid_i`` is
    given."""
    smp = args[0]
    fields = 1 if smp.ndim == 3 else smp.shape[0]
    D, H, W = smp.shape[-3:]
    fluid_i = args[3] if len(args) > 3 else kwargs.get("fluid_i")
    return bytes_moved(D, H, W, fields, fluid_i is not None)


def read(run):
    got = run.entry("pad_bounds_roofline")
    if got is None or got[1] <= 0:
        return None
    nbytes, seconds = got
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
