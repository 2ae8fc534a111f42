"""The check against its control and its faults, on the CPU at 24x12x10
(the t512_split_sphere cell's files with the grid and sphere cut down):
a run drives the harness as ``windbench.run`` does (only the look for a
card is skipped), with the timed path as the program has it (correct), with
the reference computing in bfloat16 in its place (the low-precision
control: not correct), and with the timed path broken underneath (not
correct): a step that returns its state unchanged, a field value altered
where the step produces it, a frame's stat altered. The cells run one
tunnel on one card with no batch, so there is no half batch and no
exchange between chips to leave out."""

import functools
import json

import pytest
import torch

from windbench import harness, run, traffic

SEED = 2 ** 31 + 4242


class Unchanged(harness.PortSystem):
    def step(self):
        before = self.wt.state
        stats = super().step()
        self.wt.state = before
        return stats


class AlteredField(harness.PortSystem):
    def step(self):
        stats = super().step()
        vx = self.wt.state.vx.clone()
        vx[3, 4, 5] += 0.1 * float(vx.abs().max())
        self.wt.state = self.wt.state._replace(vx=vx)
        return stats


class NanField(harness.PortSystem):
    def step(self):
        stats = super().step()
        dens = self.wt.state.dens.clone()
        dens[2, 3, 4] = float("nan")
        self.wt.state = self.wt.state._replace(dens=dens)
        return stats


class AlteredStat(harness.PortSystem):
    def step(self):
        dsum, max_div = super().step()
        return dsum * 1.01, max_div


def _run(system, trace=False):
    cfg = dict(traffic.load_json("configs", "tunnel512_split"), width=24,
               height=12, depth=10)
    wl = dict(traffic.load_json("workloads", "t512_split_sphere"),
              scene={"kind": "sphere", "center": [8, 6, 5], "radius": 3.5},
              frame_steps=3)
    return run.execute(harness.benchmark(), "t512_split_sphere", SEED, 0.6,
                       trace, torch.device("cpu"), system=system,
                       workload=wl, config=cfg)


def test_program_is_correct():
    result, lines = _run(harness.PortSystem)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(row["value"] == 0 for k, row in result["checks"].items()
               if k in harness.CHECKS)
    assert list(result)[-1] == "checks"
    assert lines[-1].startswith("check failed_frames")


def test_low_precision_control_is_not_correct():
    control = functools.partial(harness.ReferenceSystem,
                                dtype=torch.bfloat16)
    result, lines = _run(control)
    assert not result["correct"], lines
    checks = result["checks"]
    assert all(checks[k]["value"] > checks[k]["limit"]
               for k in harness.CHECKS), lines


@pytest.mark.parametrize("fault", [Unchanged, AlteredField, NanField,
                                   AlteredStat],
                         ids=lambda c: c.__name__)
def test_faults_are_not_correct(fault):
    result, lines = _run(fault)
    assert not result["correct"], lines
    json.dumps(result, allow_nan=False)


def test_traced_run_reads_host_metrics():
    result, _ = _run(harness.PortSystem, trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["scene_setup_s"]["value"] > 0
    assert metrics["host_ms_per_step"]["value"] > 0
    # the plain path on the host launches no streamed kernel: nothing to read
    assert "stream_solve_roofline" not in metrics
