"""gather_launches: runtime calls a step that enqueue work on the card
(``program_spans.ENQUEUE``) started inside the program's ``fst.gather``
spans, each trilinear sample of compat or fast advection
(``ops/advect.gather``): what the gathers ask of the launch path. The plain
gather at ``advect_window`` 0 launches one op per index, corner and lerp
term; the trilinear kernel one a sample. A program without the span reads
nothing.

Predicted (t128 compat): 248 a step, 62 a gather (three floors, three
casts to int64 and three back, three fractions, five ops of the flat base
and its clamp, eight index adds, eight gathers, 28 lerp ops)."""

from windbench.program_spans import ENQUEUE, Steps

GATHER = "fst.gather"


class Gathers(Steps):
    """The ``fst.gather`` spans of ``host`` rows, in order: one gather's
    span never overlaps another's."""

    def __init__(self, host):
        self.spans = sorted((s, e) for n, s, e in host if n == GATHER)
        self._starts = [s for s, _ in self.spans]


def read(run):
    host = run.profile["host"]
    steps, gathers = Steps(host), Gathers(host)
    if not steps or not gathers:
        return None
    return gathers.count(host, ENQUEUE) / len(steps)
