"""first_step_s: host seconds of the program's own ``fst.first_step`` span,
the tunnel's first step from its call to its return with no synchronise,
as the tunnel keeps it in ``setup_s``: the kernel library's load
(``library_load_s``), each C entry point's first launch
(``first_launch_s``), torch's first use of each of its own kernels and
the caching allocator's growth to the step's working set. The first of the
benchmark's two warm-up steps. A system with no such span reads nothing.

Predicted (every cell): 0.1-1.0 s, at least ``library_load_s +
first_launch_s``."""


def read(run):
    wt = getattr(getattr(run.cell, "system", None), "wt", None)
    return getattr(wt, "setup_s", {}).get("fst.first_step")
