"""What the readers of the program's own spans share: the ``fst.step``
spans that ``fluid_simulation_tpu_torch`` opens around each step, found in
the traced frames' host rows, and whether a host call started inside one.

A program without those spans leaves ``Steps`` empty, and each reader then
returns nothing."""

import bisect

STEP = "fst.step"
# runtime and driver calls that enqueue work on the card
ENQUEUE = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


class Steps:
    """The ``fst.step`` spans of ``host`` rows (name, start us, end us), in
    order; one step's span never overlaps another's."""

    def __init__(self, host):
        self.spans = sorted((s, e) for n, s, e in host if n == STEP)
        self._starts = [s for s, _ in self.spans]

    def __len__(self):
        return len(self.spans)

    def end_of(self, t: float):
        """The end of the step span open at ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][1]
        return None

    def count(self, host, names) -> int:
        """Host rows named in ``names`` that started inside a step."""
        return sum(1 for n, s, _ in host
                   if n in names and self.end_of(s) is not None)
