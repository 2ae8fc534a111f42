"""Models: the wind tunnel."""

from fluid_simulation_tpu_torch.models.windtunnel import (
    FluidState, StepStats, WindTunnel, init_state, simulate, simulation_step)

__all__ = ["FluidState", "StepStats", "WindTunnel", "init_state", "simulate",
           "simulation_step"]
