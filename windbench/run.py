"""Run one cell of the port's benchmark once and print its result.

    python3 -m windbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The cell is
``windbench/workloads/<cell>.json``; ``BENCHMARK.json`` says which metrics
it reports. With ``--trace 0`` the last line of standard output is a JSON
object with the cell's end-to-end metrics; with ``--trace 1`` with its
per-layer metrics, the device's busy and window seconds and a breakdown.
Each run checks what its window produced against the plain reference
(``windbench/reference``) and prints the compared numbers beside their
limits, last on standard error and last in the result.
"""

import os
import time

T0 = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of anything that compiles stay at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_ROOT, "build",
                                                       "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
    _ROOT, "build", "torch_extensions"))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from windbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"windbench: no cell {args.workload!r}; the cells are "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < chips:
        print(f"windbench: the cell needs {chips} CUDA device(s); {visible} "
              f"visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result, lines = execute(spec, args.workload, args.seed, args.seconds,
                            bool(args.trace), device)
    found = harness.forbidden_modules()
    if found:
        print(f"windbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    print(lines[0])
    for line in lines[1:]:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def execute(spec, name, seed, seconds, trace, device, **cell_kw):
    """Set-up, window, readers and check of one run on ``device``; returns
    the result object and the report lines (the frame count first, the
    compared numbers last). ``cell_kw`` goes to ``harness.Cell`` (the
    tests put another system or a smaller grid in)."""
    e2e, per_layer = harness.cell_metrics(spec, name)
    imported_s = harness.process_age_s(T0)
    cell = harness.Cell(name, device, **cell_kw)
    out = harness.window_run(cell, seed, seconds, trace,
                             per_layer if trace else (), started=T0)
    caps, steps = out["caps"], out["steps"]
    scene_s = cell.scene_setup_s
    # the program's state goes before the reference runs on the card
    cell.system = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = harness.check(cell, seed, caps)
    correct, rows = harness.verdict(cell, numbers, out["failed"])

    if trace:
        metrics = {k: {"value": v, "unit": _unit(spec, k)}
                   for k, v in out["metrics"].items()}
    else:
        values = {
            "step_ms": out["wall_s"] / steps * 1e3,
            "frame_ms_p95": float(np.percentile(out["frame_ms"], 95)),
            "setup_s": out["setup_s"],
        }
        if "memory_peak_bytes" in out:
            values["peak_mem_mib"] = out["memory_peak_bytes"] / 2 ** 20
        metrics = {k: {"value": values[k], "unit": _unit(spec, k)}
                   for k in e2e if k in values}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "host"),
           "count": 1, "memory_peak_bytes": out.get("memory_peak_bytes")}
    result = {"correct": correct, "attempted": len(out["frame_ms"]),
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
        result["breakdown"] = out["breakdown"]
    result["checks"] = rows
    lines = [f"frames {len(out['frame_ms'])}, steps {steps}, window "
             f"{out['wall_s']} s",
             f"set-up: imports {imported_s} s, scene and tunnel {scene_s} "
             "s, " + ", ".join(f"{k} {v}" for k, v in out["phases"].items())]
    lines += [f"check {k} {row['value']} limit {row['limit']}"
              for k, row in rows.items()]
    return result, lines


def _unit(spec, name):
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


if __name__ == "__main__":
    raise SystemExit(main())
