"""Every data file loads and names only what the harness knows, and
BENCHMARK.json agrees with the files it names."""

import dataclasses
import json
import re
from pathlib import Path

import pytest

from fluid_simulation_tpu_torch.config import SimParams
from windbench import harness, traffic

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
FIELDS = {f.name for f in dataclasses.fields(SimParams)}
META = {"source", "assumed", "reduced", "guarantees", "deployment",
        "reference"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_names_simparams_fields(path):
    cfg = json.loads(path.read_text())
    assert set(cfg) - META == FIELDS and "reference" in cfg
    SimParams(**{k: cfg[k] for k in FIELDS})
    assert len(cfg["source"]) <= 200
    for key, value in cfg["guarantees"].items():
        assert cfg[key] == value, key
    # the mode is held by the reference the configuration names (below)
    assert cfg["guarantees"] == {"dtype": "float32", "solver": "rbgs",
                                 "acc": 15, "mode": cfg["mode"]}
    assert set(cfg["reduced"]) <= FIELDS


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_names_a_reference_that_computes_it(path):
    cfg = json.loads(path.read_text())
    assert (ROOT / "reference" / f"{cfg['reference']}.py").is_file()
    harness.reference(cfg).params_of(cfg)


@pytest.mark.parametrize("path", sorted((ROOT / "workloads").glob("*.json")),
                         ids=lambda p: p.stem)
def test_workload_names_known_parts(path):
    wl = json.loads(path.read_text())
    assert (ROOT / "configs" / f"{wl['config']}.json").exists()
    assert (ROOT / "scenes" / f"{wl['scene']['kind']}.py").exists()
    assert set(wl["limits"]) == set(harness.CHECKS)
    assert all(0 < v < 1 for v in wl["limits"].values())
    assert set(wl["init"]) == set(traffic.FIELDS)
    assert isinstance(wl["frame_steps"], int) and wl["frame_steps"] >= 1
    cfg = traffic.load_json("configs", wl["config"])
    obs = traffic.scene(wl["scene"], cfg)
    assert obs.shape == (cfg["depth"] + 2, cfg["height"] + 2,
                         cfg["width"] + 2)


def test_benchmark_names_its_files():
    assert SPEC["command"] == ["python3", "-m", "windbench.run"]
    assert SPEC["paths"] == ["windbench"]
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT.parent / c["file"]).read_text())
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
        assert c["file"] == f"windbench/configs/{c['name']}.json"
    for w in SPEC["workloads"]:
        wl = traffic.load_json("workloads", w["name"])
        assert (w["config"], w["traffic"], w["why"]) == (
            wl["config"], wl["traffic"], wl["why"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        mine, layers = harness.cell_metrics(SPEC, cell)
        assert "setup_s" in mine and len(mine) >= 2 and layers


def test_seeded_state_repeats_per_seed():
    cfg = traffic.load_json("configs", "tunnel128_split")
    obs = traffic.scene({"kind": "sphere", "center": [4, 3, 3],
                         "radius": 2}, dict(cfg, width=9, height=6, depth=5))
    init = traffic.load_json("workloads", "t128_split_sphere")["init"]
    seed = 2 ** 31 + 12345
    a = traffic.initial_state(obs, init, seed, "cpu")
    b = traffic.initial_state(obs, init, seed, "cpu")
    c = traffic.initial_state(obs, init, seed + 1, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    solid = obs >= 0.5
    assert all(float(f[solid].abs().max()) == 0 for f in a)
    assert traffic.capture_points(seed, 2) == traffic.capture_points(seed, 2)
