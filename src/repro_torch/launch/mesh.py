"""Meshes (the port of ``repro.launch.mesh``).

A ``Mesh`` is a value: axis names, a shape and the device type it lives
on. Reasoning about shardings (``distributed.sharding``, the steps'
``in_shardings``) reads only its names and sizes, so building one binds no
device and starts no process group; ``Mesh.device_mesh()`` builds the
``torch.distributed`` ``DeviceMesh`` for a run of one process per device.

    production, single-pod : (16, 16)     ("data", "model")
    production, multi-pod  : (2, 16, 16)  ("pod", "data", "model")
    host                   : one device per process of this run
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]          # the reference's ``devices.shape``
    device_type: str = "cuda"

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} do not match "
                             f"the shape {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def device_mesh(self):
        """The ``DeviceMesh`` over ranks 0 .. size - 1 in this shape, with
        these axis names. Needs a process group of ``size`` ranks, one per
        device (``torch.distributed.init_process_group``)."""
        from torch.distributed.device_mesh import DeviceMesh
        return DeviceMesh(self.device_type,
                          torch.arange(self.size).reshape(self.shape),
                          mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 cards) or 2x16x16 multi-pod (512 cards)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model_parallel: int = 1,
                   device: Union[str, torch.device, None] = None) -> Mesh:
    """The devices of this run, the model axis clamped to them as the
    reference clamps it. The port runs one process per device, so that is
    the process group's world size, or the one device of a process that
    started none, however many cards the host holds."""
    dev = resolve_device(device)
    dist = torch.distributed
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    mp = max(1, min(model_parallel, n))
    return Mesh(("data", "model"), (n // mp, mp), dev.type)


def mesh_info(mesh: Mesh) -> Tuple[int, Dict[str, int]]:
    return mesh.size, mesh.sizes
