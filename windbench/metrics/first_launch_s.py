"""first_launch_s: host seconds of the program's own ``fst.first_launch``
spans, summed: the first call of each C entry point in the process
(``kernels/_build``'s entry table), its lazy module load included, the
library's load (``library_load_s``) not. The program keeps them once a
process, by entry point, in ``utils/profiling.PROCESS_SETUP``. A program
without that record, or that launched no entry point, reads nothing.

Predicted (every cell): 0.01-0.3 s over the entries the cell's step
launches."""

import sys

PROFILING = "fluid_simulation_tpu_torch.utils.profiling"


def read(run):
    record = getattr(sys.modules.get(PROFILING), "PROCESS_SETUP", {})
    first = record.get("fst.first_launch")
    return sum(first.values()) if first else None
