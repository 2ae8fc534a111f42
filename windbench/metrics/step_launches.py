"""step_launches: runtime calls a step that enqueue work on the card
(``program_spans.ENQUEUE``: kernel launches, asynchronous copies and sets)
started inside the program's own ``fst.step`` span: what the step's glue
asks of the launch path. The frame's stats readback is outside it.

Predicted (t512 sphere / t512 empty / t128): 140 / 137 / ~220 a step,
``device_ops_per_step`` less the frame readback's stack and copy (2 a t512
step)."""

from windbench.program_spans import ENQUEUE, Steps


def read(run):
    host = run.profile["host"]
    steps = Steps(host)
    if not steps:
        return None
    return steps.count(host, ENQUEUE) / len(steps)
