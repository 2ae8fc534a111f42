"""The program's spans: ``span`` names a phase of the step in the running
``torch.profiler`` trace, ``timed_span`` also keeps its host seconds, and
``trace_ctx`` records a block as a Chrome trace.

The step opens (``models/windtunnel.simulation_step``) ``fst.step`` around
each step, and inside it ``fst.inlets``, ``fst.diffuse``, ``fst.project``
(twice), ``fst.advect``, ``fst.confine`` (with vorticity),
``fst.advect_density``, ``fst.stats``, ``fst.bounds`` in whichever of them
pads or sets the bounds, ``fst.backtrace`` around each backtrace of compat
and fast (``ops/advect.backtrace``; compat 4 a step, fast 2) and
``fst.gather`` around each trilinear sample of compat and fast
(``ops/advect.gather``). The operator tool that reads them is
``tools/breakdown.py``.

Set-up opens these once, each timed with ``timed_span``:

- a tunnel's, kept in its ``WindTunnel.setup_s``: ``fst.setup`` around
  ``fst.setup.context`` (on the card only: the device's CUDA context),
  ``fst.setup.masks`` and ``fst.setup.state`` in ``WindTunnel.__init__``;
  ``fst.first_step`` around the tunnel's first step (``step`` or the first
  step of ``simulate``), which holds the step's ``fst.step``;
- the process's, kept in ``PROCESS_SETUP``: ``fst.library`` around
  ``fst.library.build`` and ``fst.library.load`` (``kernels/_build.library``)
  and one ``fst.first_launch`` around the first call of each C entry point
  (``kernels/_build``'s entry table), seconds by entry point.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()

# The process's set-up, written once by ``kernels/_build.py``: host seconds
# of ``fst.library``, ``fst.library.build`` and ``fst.library.load``,
# ``built`` (1 where this process compiled the kernel library, else 0), and
# under ``fst.first_launch`` each C entry point's first call, in seconds.
PROCESS_SETUP: Dict = {"fst.first_launch": {}}


def span(name: str):
    """A host-only span ``name`` in the running ``torch.profiler`` trace,
    for ``with``: a RecordFunction that is not a user annotation, so the
    profiler adds no device row for it, on the clock of the device's rows.
    With no profiler recording it costs one flag check."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def timed_span(name: str, into: Dict[str, float], key: Optional[str] = None):
    """``span(name)``, its host seconds always kept in ``into[key]``
    (``key`` defaults to ``name``): for work that runs once, such as a
    tunnel's set-up."""
    t0 = time.perf_counter()
    with span(name):
        yield
    into[name if key is None else key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace_ctx(path: Optional[str]):
    """``with trace_ctx('step.json'): ...`` records the block with
    ``torch.profiler`` (host ops, the ``fst.*`` spans and, with a card, the
    device's operations, on one clock) and writes it to ``path`` as a
    Chrome trace; a no-op when ``path`` is falsy."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
