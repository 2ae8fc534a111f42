"""Sharding: device meshes and the z-slab sharded wind tunnel
(``fluid_simulation_tpu/parallel``).

The JAX package decomposes the domain over a mesh of chips with
``shard_map``, one program over the mesh. The port is one program too: each
z rank's slab is a tensor on that rank's device, and the collectives are
tensor copies between the ranks' tensors. One card may hold every rank (the
kernels then run once per rank), and a machine with several cards gives each
rank its own, with no change to the step.
"""

from fluid_simulation_tpu_torch.parallel.mesh import make_mesh
from fluid_simulation_tpu_torch.parallel.sharded import (
    ShardedWindTunnel, simulate_sharded, split_padded, stitch_padded)

__all__ = ["make_mesh", "ShardedWindTunnel", "simulate_sharded",
           "split_padded", "stitch_padded"]
