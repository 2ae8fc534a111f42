"""fluid_simulation_tpu_torch — the wind tunnel in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100.

A port of ``fluid_simulation_tpu`` (the JAX package, which stays the
reference): the same padded ``(D+2, H+2, W+2)`` state, the same step and
the same ``SimParams``. Plain torch runs everywhere; on a CUDA device the
solves, projections, split advection and padding run the kernels in
``csrc/``, built with ``nvcc`` at first use.

Quick start::

    from fluid_simulation_tpu_torch import WindTunnel, SimParams
    wt = WindTunnel(SimParams(mode="split"), device="cuda")
    final_state, stats = wt.simulate(steps=100)
"""

from fluid_simulation_tpu_torch.config import SimParams
from fluid_simulation_tpu_torch.models.windtunnel import (
    FluidState,
    WindTunnel,
    init_state,
    simulate,
    simulation_step,
)

__version__ = "0.1.0"

__all__ = [
    "SimParams",
    "WindTunnel",
    "FluidState",
    "init_state",
    "simulation_step",
    "simulate",
]
