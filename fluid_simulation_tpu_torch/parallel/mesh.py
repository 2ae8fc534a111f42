"""Device meshes (``fluid_simulation_tpu/parallel/mesh.py``).

A mesh here is a ``(batch, z)`` array of ``torch.device``s and its axis
names. The sharded wind tunnel is one program over that list: each z rank's
slab is a tensor on its device, and the collectives are tensor copies
between them. Several ranks may share one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceMesh(NamedTuple):
    devices: np.ndarray            # (batch, z) of torch.device
    axis_names: Tuple[str, str]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)


def cuda_devices():
    """Every visible card, in order; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to run "
                           "the sharded step in plain torch on the host")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, batch: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ``('batch', 'z')`` mesh over the first ``n_devices`` devices (every
    visible card unless ``devices`` lists them; a device may repeat).

    ``batch=1`` still creates the axis (size 1), as in the JAX package. A
    batch axis larger than 1 (design sweeps over a sharded tunnel) is not
    ported yet."""
    devs = [torch.device(d) for d in
            (devices if devices is not None else cuda_devices())]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    if batch != 1:
        raise NotImplementedError(
            f"batch={batch}: a batch axis over the sharded tunnel is not "
            f"ported yet (ROADMAP A12)")
    arr = np.empty((batch, n // batch), dtype=object)
    for k, d in enumerate(devs):
        arr.flat[k] = d
    return DeviceMesh(arr, ("batch", "z"))
