"""Composable solver operators in plain torch (the JAX package's ``ops``)."""

from fluid_simulation_tpu_torch.ops.advect import advect, backtrace, trilinear_gather
from fluid_simulation_tpu_torch.ops.bounds import set_bounds
from fluid_simulation_tpu_torch.ops.linsolve import diffuse, linear_solver
from fluid_simulation_tpu_torch.ops.project import project

__all__ = ["advect", "backtrace", "trilinear_gather", "set_bounds",
           "diffuse", "linear_solver", "project"]
