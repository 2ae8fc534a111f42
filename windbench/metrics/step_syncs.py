"""step_syncs: the blocking calls a step (the set ``host_ms_per_step`` and
``step_host_ms`` leave out: stream, device and event synchronises,
synchronous copies) started inside the program's own ``fst.step`` span:
each holds the host until the card has caught up.

Predicted: 1.0 a step in every cell (the ``nan`` scalar that
``simulation_step`` copies to the card for its stats)."""

from windbench.metrics.host_ms_per_step import BLOCKING
from windbench.program_spans import Steps


def read(run):
    host = run.profile["host"]
    steps = Steps(host)
    if not steps:
        return None
    return steps.count(host, BLOCKING) / len(steps)
