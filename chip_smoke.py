#!/usr/bin/env python3
"""Drive the PyTorch port of the wind tunnel on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero without the
final ``ok`` line):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of the CUDA kernels from ``fluid_simulation_tpu_torch/csrc``;
2. each kernel against its plain torch version on the card, at the
   128x64x64 flagship shapes and at an odd small shape, random inputs from
   a NumPy seed: bitwise equality expected;
3. the split flagship: ``WindTunnel(SimParams(mode="split", ...),
   device="cuda").simulate(100)`` — finite, density > 0, divergence
   residual max < 20 and mean < 1 (bench.py's bounds), kernel launch
   counts 3/2/2/2 per step; then 3 more steps on the kernel path and on the
   plain path (``use_pallas=False``) from the same state, which must agree;
4. compat parity: 100 default compat steps at 128x64x64 against the
   reference's own print (density sum 14125.1 within 1.5 %, max 0.0505
   within 2 %), launch counts 3/2/0/0 per step;
5. split at 256x128x128 for 10 steps, finite and within the residual bounds;
6. ms/step of the kernel path and the plain path, timed with CUDA events.

Needs torch with CUDA and ``nvcc`` (``CUDA_HOME`` or ``PATH``); imports no
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

SEED = 1234
RESIDUAL_MAX, RESIDUAL_MEAN = 20.0, 1.0          # bench.py:114-115
REF_SUM, REF_MAX = 14125.1, 0.0505               # simulation.cpp:73-90 print
SUM_BAND, MAX_BAND = 0.015, 0.02                 # bench.py:194-195

KERNELS = {
    "rbgs_solve": ("fluid_simulation_tpu_torch/csrc/rbgs.cu",
                   "fluid_simulation_tpu/kernels/linsolve_pallas.py:287"),
    "project_empty": ("fluid_simulation_tpu_torch/csrc/project.cu",
                      "fluid_simulation_tpu/kernels/project_pallas.py:350"),
    "advect_split": ("fluid_simulation_tpu_torch/csrc/advect_split.cu",
                     "fluid_simulation_tpu/kernels/advect_pallas.py:611"),
    "pad_bounds": ("fluid_simulation_tpu_torch/csrc/pad_bounds.cu",
                   "fluid_simulation_tpu/kernels/bounds_pallas.py:257"),
}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.kern = {k: {"max_abs_err": 0.0} for k in KERNELS}

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:   # record the failed phase, run the others
            self.failures.append(name)
            print(f"FAILED {name}:\n{traceback.format_exc()}", flush=True)
        print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)

    def check(self, ok, msg):
        if not ok:
            raise AssertionError(msg)

    # -- helpers --------------------------------------------------------

    def rand(self, rng, shape, lo=None, hi=None):
        import numpy as np
        a = (rng.normal(size=shape) if lo is None
             else rng.uniform(lo, hi, size=shape)).astype(np.float32)
        return self.torch.tensor(a, device="cuda")

    def event_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def compare(self, name, got, want, label):
        torch = self.torch
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ok = all(a.shape == b.shape for a, b in zip(got, want)) and err == 0.0
        k = self.kern[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        print(f"   {name:14s} {label:34s} max|kernel-plain| = {err:.3g} "
              f"(bound 0: bitwise) {'ok' if ok else 'MISMATCH'}", flush=True)
        self.check(ok, f"{name} {label}: max abs err {err}")

    # -- phases -----------------------------------------------------------

    def kernels(self):
        import numpy as np
        from fluid_simulation_tpu_torch.kernels.advect_split import (
            advect_split, advect_split_plain)
        from fluid_simulation_tpu_torch.kernels.bounds import (
            pad_bounds, pad_bounds_plain)
        from fluid_simulation_tpu_torch.kernels.linsolve import (
            rbgs_solve, rbgs_solve_plain)
        from fluid_simulation_tpu_torch.kernels.project import (
            project_empty, project_empty_plain)
        from fluid_simulation_tpu_torch.ops.linsolve import diffusion_coeffs

        rng = np.random.default_rng(SEED)
        for (W, H, D), wall, flagship in (((128, 64, 64), "reference", True),
                                          ((13, 7, 5), "noslip", False)):
            pad = (D + 2, H + 2, W + 2)
            tag = f"{W}x{H}x{D} {wall}"
            a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
            f, g = self.rand(rng, pad), self.rand(rng, pad)
            b = 1 if flagship else 2
            k1 = lambda: rbgs_solve(b, f, g, a, c, 15, wall)      # noqa: E731
            p1 = lambda: rbgs_solve_plain(b, f, g, a, c, 15, wall)  # noqa: E731
            self.compare("rbgs_solve", k1(), p1(), f"{tag} b={b}")

            vel = [self.rand(rng, pad) for _ in range(3)]
            k2 = lambda: project_empty(*vel, 15, wall)             # noqa: E731
            p2 = lambda: project_empty_plain(*vel, 15, wall)       # noqa: E731
            self.compare("project_empty", k2(), p2(), tag)

            vx = self.rand(rng, pad, -20.0, 40.0)
            vy, vz = (self.rand(rng, pad, -3.0, 3.0) for _ in range(2))
            stack = self.torch.stack([self.rand(rng, pad) for _ in range(3)])
            dens = self.rand(rng, pad).abs()
            k3 = lambda: advect_split(stack, vx, vy, vz, 0.05)      # noqa: E731
            p3 = lambda: advect_split_plain(stack, vx, vy, vz, 0.05)  # noqa: E731
            self.compare("advect_split", k3(), p3(), f"{tag} stack of 3")
            self.compare("advect_split", advect_split(dens, vx, vy, vz, 0.05),
                         advect_split_plain(dens, vx, vy, vz, 0.05),
                         f"{tag} single field")

            smp3 = self.rand(rng, (3, D, H, W))
            smp1 = self.rand(rng, (1, D, H, W))
            k4 = lambda: pad_bounds(smp3, (1, 2, 3), wall)          # noqa: E731
            p4 = lambda: pad_bounds_plain(smp3, (1, 2, 3), wall)    # noqa: E731
            self.compare("pad_bounds", k4(), p4(), f"{tag} bs=(1,2,3)")
            self.compare("pad_bounds", pad_bounds(smp1, (0,), wall),
                         pad_bounds_plain(smp1, (0,), wall), f"{tag} bs=(0,)")

            if flagship:
                for name, kf, pf, reps in (("rbgs_solve", k1, p1, 20),
                                           ("project_empty", k2, p2, 20),
                                           ("advect_split", k3, p3, 50),
                                           ("pad_bounds", k4, p4, 50)):
                    ms, pms = self.event_ms(kf, reps), self.event_ms(pf, reps)
                    self.kern[name].update(ms=ms, plain_ms=pms)
                    print(f"   {name:14s} flagship shapes: kernel {ms:.4f} ms"
                          f", plain {pms:.4f} ms per call", flush=True)

    def split_flagship(self):
        torch = self.torch
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.kernels import LAUNCHES, reset_launches
        from fluid_simulation_tpu_torch.models.windtunnel import (
            simulation_step)

        wt = WindTunnel(SimParams(mode="split", div_stats=False,
                                  step_stats=False), device="cuda")
        reset_launches()
        wt.simulate(100)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        print(f"   launches over 100 steps: {counts}", flush=True)
        for name, n in counts.items():
            self.kern[name]["launches"] = n
        self.check_state(wt, "split 128x64x64")
        self.check(counts == {"rbgs_solve": 300, "project_empty": 200,
                              "advect_split": 200, "pad_bounds": 200},
                   f"split launch counts {counts} != 3/2/2/2 per step")

        start = wt.state
        kern, plain = start, start
        plain_p = wt.params.replace(use_pallas=False)
        for _ in range(3):
            kern, _ = simulation_step(kern, wt.masks, wt.params)
            plain, _ = simulation_step(plain, wt.masks, plain_p)
        err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
        print(f"   3 steps kernel path vs plain path: max abs diff {err:.3g}"
              f" (bound 0: every kernel is bitwise to its plain version)",
              flush=True)
        self.check(err == 0.0, f"kernel vs plain path differ by {err}")

    def check_state(self, wt, label):
        torch = self.torch
        s = wt.state
        finite = all(bool(torch.isfinite(f).all()) for f in s)
        dsum = wt.density_sum()
        vx, vy, vz = (f.float() for f in (s.vx, s.vy, s.vz))
        div = 0.5 * (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2]
                     + vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1]
                     + vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1]).abs()
        dmax, dmean = float(div.max()), float(div.mean())
        print(f"   {label}: finite={finite} density_sum={dsum:.6g} "
              f"div residual max={dmax:.4g} mean={dmean:.4g}", flush=True)
        self.check(finite and dsum > 0, f"{label}: non-finite or empty state")
        self.check(dmax < RESIDUAL_MAX and dmean < RESIDUAL_MEAN,
                   f"{label}: residual max {dmax} mean {dmean}")

    def compat_parity(self):
        torch = self.torch
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        from fluid_simulation_tpu_torch.kernels import LAUNCHES, reset_launches

        wt = WindTunnel(SimParams(div_stats=False, step_stats=False),
                        device="cuda")
        reset_launches()
        wt.simulate(100)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        dsum = wt.density_sum()
        dmax = wt.field_ranges()["density"][1]
        print(f"   launches over 100 steps: {counts}", flush=True)
        print(f"   density_sum={dsum:.6g} (ref {REF_SUM}, "
              f"{100 * (dsum - REF_SUM) / REF_SUM:+.3f} %), dens_max="
              f"{dmax:.6g} (ref {REF_MAX}, "
              f"{100 * (dmax - REF_MAX) / REF_MAX:+.3f} %)", flush=True)
        self.check(counts == {"rbgs_solve": 300, "project_empty": 200,
                              "advect_split": 0, "pad_bounds": 0},
                   f"compat launch counts {counts} != 3/2/0/0 per step")
        self.check(abs(dsum - REF_SUM) / REF_SUM <= SUM_BAND,
                   f"density sum {dsum} outside 1.5 % of {REF_SUM}")
        self.check(abs(dmax - REF_MAX) / REF_MAX <= MAX_BAND,
                   f"dens max {dmax} outside 2 % of {REF_MAX}")

    def real_size(self):
        from fluid_simulation_tpu_torch import SimParams, WindTunnel
        wt = WindTunnel(SimParams(width=256, height=128, depth=128,
                                  mode="split", div_stats=False,
                                  step_stats=False), device="cuda")
        wt.simulate(10)
        self.check_state(wt, "split 256x128x128, 10 steps")

    def times(self):
        from fluid_simulation_tpu_torch import WindTunnel
        from fluid_simulation_tpu_torch.utils.profiling import cells
        reps = {"split 128x64x64": 50, "compat 128x64x64": 20,
                "split 256x128x128": 10}
        for label, p in cells().items():
            n = reps[label]
            runs = {True: [], False: []}
            for use_kernels in (True, False, False, True):
                wt = WindTunnel(p.replace(use_pallas=use_kernels),
                                device="cuda")
                wt.simulate(3)   # warm up (and leave the all-zero state)
                runs[use_kernels].append(self.event_ms(wt.step, n))
            k_ms = sum(runs[True]) / 2
            p_ms = sum(runs[False]) / 2
            n_cells = p.n_cells
            print(f"   {label}: kernel path {k_ms:.4f} ms/step "
                  f"({n_cells / k_ms * 1e3:.4g} cell-updates/s; runs "
                  f"{runs[True][0]:.4f}, {runs[True][1]:.4f}), plain path "
                  f"{p_ms:.4f} ms/step ({n_cells / p_ms * 1e3:.4g} "
                  f"cell-updates/s; runs {runs[False][0]:.4f}, "
                  f"{runs[False][1]:.4f})", flush=True)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "fluid_simulation_tpu_torch")):
        print("chip_smoke.py: the fluid_simulation_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke.py: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs on a GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, here)

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}", flush=True)
    smoke = Smoke(torch)

    def build():
        from fluid_simulation_tpu_torch.kernels import _build
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.library()
        print(f"   kernels built/loaded in {time.perf_counter() - t0:.1f} s:"
              f" {lib_path}", flush=True)
        log = (lib_path.parent / "nvcc.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Function" in line:
                    print(f"   nvcc: {line.strip()}", flush=True)

    smoke.phase("build", build)
    if smoke.failures:
        print(f"chip_smoke.py: FAILED phases: {smoke.failures}",
              file=sys.stderr)
        return 1
    smoke.phase("kernels vs plain", smoke.kernels)
    smoke.phase("split flagship 128x64x64, 100 steps", smoke.split_flagship)
    smoke.phase("compat parity 128x64x64, 100 steps", smoke.compat_parity)
    smoke.phase("split 256x128x128, 10 steps", smoke.real_size)
    smoke.phase("times", smoke.times)
    if smoke.failures:
        print(f"chip_smoke.py: FAILED phases: {smoke.failures}",
              file=sys.stderr)
        return 1

    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=smoke.kern[name]["launches"],
                 max_abs_err=smoke.kern[name]["max_abs_err"],
                 ms=smoke.kern[name]["ms"],
                 plain_ms=smoke.kern[name]["plain_ms"])
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
