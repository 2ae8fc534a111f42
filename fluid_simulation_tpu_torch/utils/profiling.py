"""Where a step's time goes on the card: host wall clock, device busy and idle
share, and device time by kernel, from ``torch.profiler``.

    python -m fluid_simulation_tpu_torch.utils.profiling [--steps N] [--out FILE]

profiles the slice's cells on one CUDA device (split and compat at
128x64x64, split at 256x128x128, and the split step on the plain torch
path), prints one summary line and the top device operations per cell, and
writes the numbers as JSON to ``--out``. A CPU tensor has no device metric,
so the measurement refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, Iterable, Tuple

import torch

from fluid_simulation_tpu_torch.config import SimParams


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: the time during
    which at least one device operation ran (overlaps count once)."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def step_breakdown(wt, steps: int = 20, warmup: int = 5,
                   top: int = 12) -> Dict:
    """Profile ``steps`` calls of ``wt.step()`` on a CUDA WindTunnel.

    ``wall_ms`` is host time per step ending in a synchronise, taken before
    the profiler attaches (an attached profiler slows every launch);
    ``busy_ms`` is the union of the device operations' intervals per step
    under the profiler, and ``idle`` is ``1 - busy_ms / wall_ms``.
    ``top`` lists (name, launches per step, device ms per step)."""
    if wt.device.type != "cuda":
        raise RuntimeError(f"step_breakdown needs a CUDA WindTunnel, got "
                           f"{wt.device}: a CPU run gives no device metric")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wt.simulate(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        wt.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            wt.step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: Dict[str, list] = {}
    for e in dev:
        n_us = by_name.setdefault(e.name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.time_range.elapsed_us()
    busy_ms = busy_us((e.time_range.start, e.time_range.end)
                      for e in dev) / steps / 1e3
    rows = sorted(((name, n / steps, us / steps / 1e3)
                   for name, (n, us) in by_name.items()),
                  key=lambda r: -r[2])
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1.0 - busy_ms / wall_ms,
                device_ops=len(dev) / steps, top=rows[:top])


def cells() -> Dict[str, SimParams]:
    """The slice's cells on the kernel path, as chip_smoke.py times them."""
    base = SimParams(div_stats=False, step_stats=False)
    return {
        "split 128x64x64": base.replace(mode="split"),
        "compat 128x64x64": base,
        "split 256x128x128": base.replace(mode="split", width=256,
                                          height=128, depth=128),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", help="write the breakdowns here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")
    from fluid_simulation_tpu_torch import WindTunnel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    out = {"card": card, "steps": args.steps, "cells": {}}
    todo = cells()
    todo["split 128x64x64 plain"] = todo["split 128x64x64"].replace(
        use_pallas=False)
    for label, p in todo.items():
        r = step_breakdown(WindTunnel(p, device="cuda"), steps=args.steps)
        out["cells"][label] = r
        print(f"== {label}: wall {r['wall_ms']:.4f} ms/step, device busy "
              f"{r['busy_ms']:.4f} ms/step, idle {100 * r['idle']:.1f} %, "
              f"{r['device_ops']:.1f} device ops/step", flush=True)
        for name, n, ms in r["top"]:
            print(f"   {ms:9.4f} ms/step {n:7.1f}/step  {name[:88]}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
