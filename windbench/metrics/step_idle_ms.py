"""step_idle_ms: device idle ms a step that began inside the program's own
``fst.step`` span: the gaps between the traced frames' device operations
(their union) whose start falls while a step span is open, each whole.
Gaps that begin in the frame's readback or between steps fall outside. A
run with no device operation reads nothing.

Predicted (t512 sphere / t512 empty / t128): 0.4-1.0 / 0.3-0.7 / 1.6-2.5
ms a step, within the cell's whole idle (1.24 / 0.86 / ~2.5 ms)."""

from windbench.program_spans import Steps


def read(run):
    prof = run.profile
    steps = Steps(prof["host"])
    if not steps or not prof["device"]:
        return None
    idle, end = 0.0, None
    for s, e in sorted((s, e) for _, s, e in prof["device"]):
        if end is not None and s > end and steps.end_of(end) is not None:
            idle += s - end
        end = e if end is None else max(end, e)
    return idle / 1e3 / len(steps)
