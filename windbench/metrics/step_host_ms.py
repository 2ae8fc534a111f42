"""step_host_ms: the host's own time a step inside the program's own
``fst.step`` span (``simulation_step``), less the blocking calls inside it
(the same set ``host_ms_per_step`` leaves out). What remains is what the
kernel wrappers and glue ops cost the host to check, allocate and launch a
step, the profiler's own cost per recorded op included. Unlike
``host_ms_per_step`` it leaves out the benchmark's own call into the
tunnel.

Predicted (t512 sphere / t512 empty / t128): 5.0-7.8 / 4.5-5.0 / 3.0-4.8
ms/step, within 10 % under ``host_ms_per_step`` where both read."""

from windbench.metrics.host_ms_per_step import BLOCKING
from windbench.program_spans import Steps


def read(run):
    host = run.profile["host"]
    steps = Steps(host)
    if not steps:
        return None
    own = sum(e - s for s, e in steps.spans)
    for n, s, e in host:
        if n in BLOCKING:
            end = steps.end_of(s)
            if end is not None:
                own -= min(e, end) - s
    return own / 1e3 / len(steps)
