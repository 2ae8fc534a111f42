"""The launch-overhead probe (``fluid_simulation_tpu_torch/tools/
exp_overhead.py``, ROADMAP B23) and its tiny kernel's plain version
(``kernels/probe.py``) on the CPU.

``add_one_plain`` is held bitwise to the JAX probe's tiny kernel body
(``tools/exp_overhead.py:49-50``, ``x + 1.0``, as XLA computes it). The
slope helper is held to JAX's formula on a stubbed clock. The probe runs
its eager arm here at a tiny size on the host clock; its graph arm needs
the card and raises here, and its host split's launches are held to their
C entry points' signatures.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluid_simulation_tpu_torch.kernels import _build
from fluid_simulation_tpu_torch.kernels.probe import add_one, add_one_plain
from fluid_simulation_tpu_torch.ops.advect import trilinear_gather
from fluid_simulation_tpu_torch.tools import exp_overhead

torch.set_num_threads(1)

TINY = ("--device", "cpu", "--shape", "8", "4", "4", "--n", "2", "--acc",
        "2")


@pytest.mark.parametrize("seed", [0, 1])
def test_add_one_matches_jax(seed):
    x = np.random.default_rng(seed).normal(size=(8, 128)).astype(np.float32)
    x[0, :4] = (-1.0, -0.0, 3.0e38, 1e-45)
    want = np.asarray(jnp.asarray(x) + 1.0)
    np.testing.assert_array_equal(add_one_plain(torch.tensor(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(add_one(torch.tensor(x)).numpy(), want)


class StubClock:
    """A timer that runs ``fn`` and returns a fixed overhead plus ``per``
    seconds per body call, with the given noise on successive calls."""

    def __init__(self, per, overhead, noise):
        self.calls, self.per, self.overhead = 0, per, overhead
        self.noise = list(noise)

    def body(self):
        self.calls += 1

    def timer(self, fn):
        before = self.calls
        fn()
        return (self.overhead + self.per * (self.calls - before)
                + self.noise.pop(0))


def test_slope_is_the_best_of_three_differences():
    # warm-up pair, then three (t(n), t(3n)) pairs; the middle pair's
    # noise makes the smallest difference
    clock = StubClock(2e-6, 5e-3, [9.0, 9.0, 0.0, 0.0, 2e-5, 0.0, 0.0, 0.0])
    got = exp_overhead.slope(clock.body, n=10, timer=clock.timer)
    assert clock.calls == 4 * (10 + 30)
    assert got == pytest.approx(2e-6 - 2e-5 / 20, rel=1e-9)
    flat = StubClock(3e-6, 1.0, [0.0] * 8)
    assert exp_overhead.slope(flat.body, n=7, timer=flat.timer) == \
        pytest.approx(3e-6, rel=1e-9)


def test_graph_arm_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="needs the card"):
        exp_overhead.capture(lambda: torch.zeros(1), "cpu")


def test_probe_runs_its_eager_rows_on_the_cpu(capsys):
    assert exp_overhead.main(list(TINY)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("host CPU, host clock (no device metric)")
    rows = lines[1:]
    assert [r.split(" eager")[0].strip() for r in rows] == [
        "(a) add_one xK=1", "(a) add_one xK=4", "(a) add_one xK=16",
        "(b) rbgs_solve acc=2 xK=1", "(b) rbgs_solve acc=2 xK=3",
        "(b) rbgs_solve acc=1", "(b) rbgs_solve acc=5",
        "(b) rbgs_solve acc=2", "(c) torch f*1.0001+0.0001",
        "(d) pre-advection chain K1 x3 + K2", "(d) pre-advection prestep"]
    assert all(r.endswith("graph: none on the host") for r in rows)


def test_probe_rows_compute_what_they_name():
    """On the CPU every row runs its plain versions: the tiny chain adds
    K, and the prestep equals the chain it stands for."""
    rows = {r.name: r.body for r in exp_overhead.rows("cpu", (8, 4, 4), 2)}
    assert torch.equal(rows["(a) add_one xK=16"](),
                       torch.full((8, 128), 16.0))
    chain = rows["(d) pre-advection chain K1 x3 + K2"]()
    fused = rows["(d) pre-advection prestep"]()
    for a, b in zip(chain, fused):
        assert torch.equal(a, b)
    once = rows["(b) rbgs_solve acc=2 xK=1"]()
    assert once.shape == (6, 6, 10) and bool(torch.isfinite(once).all())


def test_probe_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_overhead.main(["--n", "1"])


def test_host_split_launches_match_their_entry_points():
    """The host split's launches carry their C entry points' arguments in
    order, each beside a no-op of the same signature; on the host their
    wrappers run the plain versions, their allocations give the output's
    shape, and their checks refuse a tensor off the card as the port's
    do."""
    add1, k9 = exp_overhead.launches("cpu", (16, 8, 8))
    for launch in (add1, k9):
        sig = _build.SIGNATURES[launch.entry]
        assert _build.SIGNATURES[launch.noop] == sig
        assert len(launch.ptrs) + len(launch.args) + 1 == len(sig)
        assert launch.alloc().shape == launch.ptrs[-1].shape
        with pytest.raises(ValueError, match="operand 0 on cpu"):
            launch.checks()
    assert torch.equal(add1.call(), torch.ones(8, 128))
    prev, xb, yb, zb, _ = k9.ptrs
    assert torch.equal(k9.call(), trilinear_gather(prev, xb, yb, zb))
    assert k9.args == (8, 8, 16)
