"""confine_launches: runtime calls a step that enqueue work on the card
(``program_spans.ENQUEUE``) started inside the program's ``fst.confine``
span, the step's vorticity confinement (``kernels/vorticity.confinement``
on the card): what the confinement asks of the launch path. A program or a
cell without the span (vorticity 0) reads nothing.

Predicted (t512 no-slip with vorticity): 3 a step, the zero fill of the
|curl| scratch's ghost shell, the curl launch and the update launch."""

from windbench.program_spans import ENQUEUE, Steps

CONFINE = "fst.confine"


class Confines(Steps):
    """The ``fst.confine`` spans of ``host`` rows, in order: one step opens
    one, and it never overlaps another."""

    def __init__(self, host):
        self.spans = sorted((s, e) for n, s, e in host if n == CONFINE)
        self._starts = [s for s, _ in self.spans]


def read(run):
    host = run.profile["host"]
    steps, confines = Steps(host), Confines(host)
    if not steps or not confines:
        return None
    return confines.count(host, ENQUEUE) / len(steps)
