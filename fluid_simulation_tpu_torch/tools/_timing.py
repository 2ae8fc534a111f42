"""Timing helpers shared by the probes: the host and CUDA-event clocks, the
JAX tools' slope, and CUDA-graph capture and replay.

Every probe row is a body of calls; its cost is JAX's slope (the JAX
tools' ``timeit``, e.g. ``tools/exp_overhead.py:27-46``): the best of 3 of
``(t(3n) - t(n)) / 2n`` after one warm-up of each length, so a fixed cost
per timed run (a synchronise, an event, a replay call) cancels.
"""

from __future__ import annotations

import subprocess
import time

import torch

# the H100's data-sheet HBM rate, against which a bytes bound is taken, and
# the range of rates csrc/hbm.cu's copy2d stream reached at 256^3 (exp_hbm2,
# PERF.md K17-hbm). That is one kernel's stream, not the card's ceiling:
# dma.cu's copy2 streams faster (PERF.md K17-dma).
HBM_BYTES_PER_S = 3.35e12
HBM_CU_COPY2D_BYTES_PER_S = (2.79e12, 2.97e12)


def rate_shares(nbytes: float, sec: float) -> str:
    """``nbytes`` moved in ``sec`` as a rate, a share of the bound's rate
    and a range of shares of hbm.cu's copy2d rate."""
    rate = nbytes / sec
    lo, hi = HBM_CU_COPY2D_BYTES_PER_S
    return (f"{rate / 1e12:.3f} TB/s: {rate / HBM_BYTES_PER_S:.3f} of the "
            f"bound, {rate / hi:.3f}-{rate / lo:.3f} of hbm.cu's copy2d")


def host_timer(fn) -> float:
    """Seconds of ``fn()`` on the host clock."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def clock_line(tool: str, device) -> str:
    """What a probe's numbers are timed on: on the card, the card's name
    and power limit as ``nvidia-smi`` gives them and "CUDA events"; on the
    CPU, the host clock. Exits, naming ``tool``, when the card is asked for
    and there is none."""
    if torch.device(device).type != "cuda":
        return "host CPU, host clock (no device metric)"
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (pass --device cpu for the "
                         f"eager arm on the host clock)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return f"{card}; CUDA events"


def event_timer(fn) -> float:
    """Seconds of ``fn()`` on the current stream, between two CUDA events
    recorded on an idle card."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _best_difference(run_n, run_3n, n: int, timer) -> float:
    """The best of 3 of ``(timer(run_3n) - timer(run_n)) / 2n`` after one
    warm-up of each."""
    timer(run_n)
    timer(run_3n)
    best = float("inf")
    for _ in range(3):
        t1 = timer(run_n)
        t3 = timer(run_3n)
        best = min(best, (t3 - t1) / (2 * n))
    return best


def slope(body, n: int = 100, timer=event_timer) -> float:
    """Marginal seconds per iteration of ``body``: the best of 3 of
    ``(t(3n) - t(n)) / 2n``, after one warm-up of each length
    (exp_overhead.py:27-46)."""
    def run(k):
        return lambda: [body() for _ in range(k)]

    return _best_difference(run(n), run(3 * n), n, timer)


def capture(body, device="cuda"):
    """``(graph, outputs)``: ``body`` captured once with
    ``torch.cuda.graph`` after three warm-up calls on a side stream. The
    outputs are the graph's own tensors, rewritten by every replay. Raises
    on the CPU, and wherever a launch cannot be captured."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"a CUDA graph needs the card, got {device}; the "
                           f"CPU runs the eager arm only")
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph, out


def replay_slope(step, x0, n: int = 10, device="cuda") -> float:
    """Seconds per call of ``step`` on the card, as the JAX tools time a
    ``jax.lax.scan`` of ``x = step(x)``: the chains of n and of 3n calls
    from ``x0`` are each captured as one CUDA graph, and their replays
    timed as ``slope`` times a body, the best of 3 of ``(t(3n) - t(n)) /
    2n``. One replay per timed run, so no call waits on the host's launch
    cost. Raises on the CPU."""
    def chain(k):
        def body():
            x = x0
            for _ in range(k):
                x = step(x)
            return x
        return body

    g1, _ = capture(chain(n), device)
    g3, _ = capture(chain(3 * n), device)
    return _best_difference(g1.replay, g3.replay, n, event_timer)
