"""gather_host_ms: the host's own time a step inside the program's
``fst.gather`` spans (each trilinear sample of compat or fast advection,
``ops/advect.gather``), less the blocking calls inside them (the set
``step_host_ms`` leaves out): what the gathers cost the host to build and
launch their ops, the profiler's own cost per recorded op included. A
program without the span reads nothing.

Predicted (t128 compat): 1.5-4 ms/step, about a third of ``step_host_ms``
there."""

from windbench.metrics.gather_launches import Gathers
from windbench.metrics.host_ms_per_step import BLOCKING
from windbench.program_spans import Steps


def read(run):
    host = run.profile["host"]
    steps, gathers = Steps(host), Gathers(host)
    if not steps or not gathers:
        return None
    own = sum(e - s for s, e in gathers.spans)
    for n, s, e in host:
        if n in BLOCKING:
            end = gathers.end_of(s)
            if end is not None:
                own -= min(e, end) - s
    return own / 1e3 / len(steps)
