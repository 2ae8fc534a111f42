"""device_idle: the share of the step in which the card runs nothing,
``1 - busy / wall``: busy is the union of the device operations' intervals
per step in the traced segment, wall the untraced window's wall time per
step in the same run."""

from windbench.harness import busy_us


def read(run):
    prof = run.profile
    busy_ms = busy_us((s, e) for _, s, e in prof["device"]) / 1e3
    busy_ms /= prof["steps"]
    return 100.0 * (1.0 - busy_ms / run.window["wall_ms_per_step"])
