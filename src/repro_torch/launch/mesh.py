"""Meshes (the port of ``repro.launch.mesh``).

A ``Mesh`` is a value: axis names, a shape and the device type it lives
on. Reasoning about shardings (``distributed.sharding``, the steps'
``in_shardings``) reads only its names and sizes, so building one binds no
device and starts no process group; ``Mesh.device_mesh()`` builds the
``torch.distributed`` ``DeviceMesh`` for a run of one process per device.

    production, single-pod : (16, 16)     ("data", "model")
    production, multi-pod  : (2, 16, 16)  ("pod", "data", "model")
    host                   : one device per process of this run

A run on a host mesh of more than one device is a process group of one
process per device (``init_from_env``; ``run_ranks`` starts one on this
host, each rank on ``local_device``).
"""
from __future__ import annotations

import math
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

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


def local_device(mesh: Mesh) -> torch.device:
    """This rank's device on ``mesh``: the CPU, or the card that its rank
    takes among the host's cards (every rank on a host of one card shares
    ``cuda:0``)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    dist = torch.distributed
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device(mesh.device_type,
                        rank % torch.cuda.device_count())


# the environment of a rank that ``run_ranks`` starts: its rank, the
# world size and the file its process group meets at
RANK_ENV, WORLD_ENV, STORE_ENV = "RANK", "WORLD_SIZE", "REPRO_RANK_STORE"


def init_from_env(timeout_s: float = 300.0) -> int:
    """Join the gloo group that this process's environment names (a rank
    of ``run_ranks``); returns the world size, 1 outside a group."""
    dist = torch.distributed
    world = int(os.environ.get(WORLD_ENV, "1"))
    if world > 1 and not dist.is_initialized():
        import datetime
        dist.init_process_group(
            "gloo", init_method=f"file://{os.environ[STORE_ENV]}",
            rank=int(os.environ[RANK_ENV]), world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return world


def run_ranks(cmd: Sequence[str], world: int, timeout_s: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[Tuple[int, str, str]]:
    """Run ``cmd`` as ``world`` processes of one gloo group on this host
    (ranks 0 .. world - 1, meeting at a file store in a fresh temporary
    directory) and return each rank's (exit code, stdout, stderr). Once
    a rank fails or ``timeout_s`` passes, the ranks still running are
    killed (a rank left waiting in a collective would wait out the
    group's timeout); a killed rank's exit code is negative."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        base = {**(os.environ if env is None else env),
                WORLD_ENV: str(world),
                STORE_ENV: os.path.join(tmp, "store")}
        outs = [(open(os.path.join(tmp, f"{r}.out"), "w+"),
                 open(os.path.join(tmp, f"{r}.err"), "w+"))
                for r in range(world)]
        procs = [subprocess.Popen(list(cmd), cwd=cwd, stdout=o, stderr=e,
                                  env={**base, RANK_ENV: str(r)})
                 for r, (o, e) in enumerate(outs)]
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.poll() not in (None, 0) for p in procs)):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        result = []
        for p, (o, e) in zip(procs, outs):
            o.seek(0)
            e.seek(0)
            result.append((p.returncode, o.read(), e.read()))
            o.close()
            e.close()
        return result
