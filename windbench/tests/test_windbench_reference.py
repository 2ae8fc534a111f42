"""The frozen reference step against the port's plain step on the CPU at
24x12x10, with a sphere and empty, over two steps from the seeded state:
bitwise, on the resident route and on the streamed one (its plain versions,
with the route's size gate lowered)."""

import pytest
import torch

from fluid_simulation_tpu_torch import FluidState, SimParams, WindTunnel
from fluid_simulation_tpu_torch.kernels import linsolve_stream
from windbench import traffic
from windbench.reference import step as ref

W, H, D = 24, 12, 10
SCENES = {"sphere": {"kind": "sphere", "center": [8, 6, 5], "radius": 3.5},
          "empty": {"kind": "empty"}}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("use_pallas, streamed", [(False, False),
                                                  (True, False),
                                                  (True, True)])
def test_reference_equals_port_plain_step(scene, use_pallas, streamed,
                                          monkeypatch):
    if streamed:
        monkeypatch.setattr(linsolve_stream, "STREAM_MIN_CELLS", 1)
    cfg = dict(traffic.load_json("configs", "tunnel128_split"), width=W,
               height=H, depth=D)
    p = SimParams(**{k: cfg[k] for k in SimParams.__dataclass_fields__})
    p = p.replace(use_pallas=use_pallas)
    obs = traffic.scene(SCENES[scene], cfg)
    init = traffic.load_json("workloads", "t128_split_sphere")["init"]
    state = traffic.initial_state(obs, init, 2 ** 31 + 99, "cpu")
    wt = WindTunnel(p, obstacles=obs, device="cpu")
    wt.state = FluidState(*state)
    m = ref.build_masks(obs)
    rp = ref.params_of(cfg)
    for _ in range(2):
        st = wt.step()
        state, (dsum, max_div) = ref.step(state, m, rp)
        for got, want in zip(wt.state, state):
            assert torch.equal(got, want)
        assert float(st.density_sum) == float(dsum)
        assert float(st.max_divergence) == float(max_div)
