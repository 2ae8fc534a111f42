"""library_load_s: host seconds of the program's own ``fst.library`` span,
``kernels/_build.library()``: the sources' hash and, where no library
for them is built yet, ``nvcc`` (``fst.library.build``), then
``ctypes.CDLL`` and the entry points' set-up (``fst.library.load``). The
program keeps it once a process in ``utils/profiling.PROCESS_SETUP``,
with ``built`` 1 where this process compiled. A program without that
record reads nothing.

Predicted (every cell): warm 0.01-0.3 s; in a checkout's first run, which
builds the library, 20-45 s (``built`` 1)."""

import sys

PROFILING = "fluid_simulation_tpu_torch.utils.profiling"


def read(run):
    record = getattr(sys.modules.get(PROFILING), "PROCESS_SETUP", {})
    return record.get("fst.library")
