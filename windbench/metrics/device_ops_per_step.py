"""device_ops_per_step: device operations per step in the traced segment
(every kernel and copy the profiler records on the card, the frames'
stats readback included)."""


def read(run):
    return len(run.profile["device"]) / run.profile["steps"]
