"""The readings that the check's limits are set from, for one cell on the
card: the program over many seeds, and the low-precision control (the
reference computing in bfloat16, put in the program's place) over a few,
each through the harness's own window and check, in one process.

    python3 -m windbench.calibrate --workload <cell> --seeds 1 2 3 ...
        --control-seeds 7 8 9 [--seconds 3] [--control-seconds 6]

prints one JSON line per run ({"side", "seed", numbers}) and writes them to
``chiprun_out/calibrate_<cell>.jsonl``. The benchmark's own runs never run
it. A limit sits above every program reading and below every control
reading (``PERF.md`` gives both).
"""

import argparse
import json
import os
import sys
import time

import torch

from windbench import harness


def readings(cell, seeds, seconds, side, out):
    for seed in seeds:
        t0 = time.perf_counter()
        run = harness.window_run(cell, seed, seconds, False)
        nums = harness.check(cell, seed, run["caps"])
        row = dict(side=side, seed=seed, frames=len(run["frame_ms"]),
                   failed=run["failed"], seconds=time.perf_counter() - t0,
                   **nums)
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"calibrate_{args.workload}.jsonl")
    with open(path, "a") as out:
        if args.seeds:
            cell = harness.Cell(args.workload, "cuda")
            readings(cell, args.seeds, args.seconds, "program", out)
            del cell
            torch.cuda.empty_cache()
        if args.control_seeds:
            cell = harness.Cell(args.workload, "cuda",
                                system=harness.ReferenceSystem)
            readings(cell, args.control_seeds, args.control_seconds,
                     "control_bf16", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
