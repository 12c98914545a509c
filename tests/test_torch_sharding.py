"""The port's sharding layer against the JAX package's, at full width.

The reference runs in a subprocess on 512 fake host devices
(``--xla_force_host_platform_device_count=512``, as its dry run does): it
builds ``make_step`` for every applicable (arch x ``SHAPES``) cell on both
production meshes, (16, 16) and (2, 16, 16), 64 bundles, and dumps every
leaf of ``in_shardings`` and ``out_shardings`` in flatten order, its
``PartitionSpec`` and ``shard_shape``, with the shape and dtype of every
``abstract_inputs`` leaf. The port's ``make_step`` on
``make_production_mesh`` must give the same specs and shard shapes leaf for
leaf, and the same abstract shapes and dtypes (meta tensors). No device is
needed: both sides only reason about shardings.

Unit cases: ``logical_to_spec`` (the "pod" axis dropped on one pod,
trailing axes dropped until the dim divides, no mesh axis used twice),
``use_mesh`` nesting, ``constrain`` (the identity without a mesh or on one
device, an error on a larger mesh), ``placements()``, and the host mesh
and its ``DeviceMesh`` in a one-process gloo group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import (SHAPES, all_arch_names, get_config,
                                 kv_cache_specs, shape_applicable)
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.distributed.sharding import PartitionSpec as PS
from repro_torch.distributed.sharding import (active_mesh, constrain,
                                              logical_to_spec, use_mesh)
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, mesh_info)
from repro_torch.launch.steps import make_step
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]

# the reference's bundles: the out-shape tree mirrors out_shardings' (the
# train step's parameters, optimizer state and two scalars; a serving
# step's last-token logits and cache)
REFERENCE = r"""
import json, sys
import jax
import jax.numpy as jnp
from repro.configs.base import (SHAPES, all_arch_names, get_config,
                                kv_cache_specs, shape_applicable)
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import make_step

def spec(s):
    return [e if e is None or isinstance(e, str) else list(e) for e in s]

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in all_arch_names():
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            b = make_step(cfg, mesh, shape)
            B, V = shape.global_batch, cfg.vocab_size
            if shape.kind == "train":
                scalar = jax.ShapeDtypeStruct((), jnp.float32)
                outs = (b.abstract_inputs[0], b.abstract_inputs[1],
                        {"loss": scalar, "grad_norm": scalar})
            else:
                cache = (kv_cache_specs(cfg, B, shape.seq_len)
                         if shape.kind == "prefill"
                         else b.abstract_inputs[1]["cache"])
                outs = (jax.ShapeDtypeStruct((B, 1, V), cfg.dtype), cache)
            ins = jax.tree.leaves(b.abstract_inputs)
            in_sh = jax.tree.leaves(b.in_shardings)
            out_sh = jax.tree.leaves(b.out_shardings)
            outs = jax.tree.leaves(outs)
            assert len(ins) == len(in_sh) and len(outs) == len(out_sh)
            out[f"{int(multi)}/{arch}/{name}"] = {
                "in": [[list(x.shape), str(x.dtype), spec(s.spec),
                        list(s.shard_shape(x.shape))]
                       for x, s in zip(ins, in_sh)],
                "out": [[list(x.shape), spec(s.spec),
                         list(s.shard_shape(x.shape))]
                        for x, s in zip(outs, out_sh)],
                "donate": list(b.donate_argnums)}
json.dump(out, sys.stdout)
"""

CELLS = [(multi, arch, name)
         for multi in (False, True) for arch in all_arch_names()
         for name, shape in SHAPES.items()
         if shape_applicable(get_config(arch), shape)[0]]


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout)


def _spec(s):
    return [e if e is None or isinstance(e, str) else list(e) for e in s]


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def test_reference_has_every_cell(reference):
    assert len(CELLS) == 64
    assert sorted(reference) == sorted(f"{int(m)}/{a}/{n}"
                                       for m, a, n in CELLS)


@pytest.mark.parametrize("multi,arch,name", CELLS,
                         ids=[f"{'multi' if m else 'single'}-{a}-{n}"
                              for m, a, n in CELLS])
def test_specs_match_reference(reference, multi, arch, name):
    want = reference[f"{int(multi)}/{arch}/{name}"]
    mesh = make_production_mesh(multi_pod=multi)
    cfg, shape = get_config(arch), SHAPES[name]
    b = make_step(cfg, mesh, shape)
    ins = tree_leaves(b.abstract_inputs)
    in_sh = tree_leaves(b.in_shardings)
    B, V = shape.global_batch, cfg.vocab_size
    if shape.kind == "train":
        scalar = torch.empty((), device="meta")
        outs = (b.abstract_inputs[0], b.abstract_inputs[1],
                {"loss": scalar, "grad_norm": scalar})
    else:
        cache = ({k: torch.empty(s, dtype=d, device="meta") for k, (s, d)
                  in kv_cache_specs(cfg, B, shape.seq_len).items()}
                 if shape.kind == "prefill"
                 else b.abstract_inputs[1]["cache"])
        outs = (torch.empty((B, 1, V), dtype=cfg.dtype, device="meta"),
                cache)
    outs = tree_leaves(outs)
    out_sh = tree_leaves(b.out_shardings)
    got = {"in": [[list(x.shape), _dtype(x), _spec(s.spec),
                   list(s.shard_shape(x.shape))]
                  for x, s in zip(ins, in_sh)],
           "out": [[list(x.shape), _spec(s.spec),
                    list(s.shard_shape(x.shape))]
                   for x, s in zip(outs, out_sh)],
           "donate": list(b.donate_argnums)}
    assert all(x.device.type == "meta" for x in ins)
    assert len(got["in"]) == len(want["in"])
    assert len(got["out"]) == len(want["out"])
    for i, (g, w) in enumerate(zip(got["in"], want["in"])):
        assert g == w, (i, g, w)
    for i, (g, w) in enumerate(zip(got["out"], want["out"])):
        assert g == w, (i, g, w)
    assert got["donate"] == want["donate"]


def test_logical_to_spec_rules():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert mesh_info(multi) == (512, {"pod": 2, "data": 16, "model": 16})
    # "pod" is dropped where the mesh has no such axis
    assert logical_to_spec(("batch", "embed"), single) == PS("data", None)
    assert logical_to_spec(("batch", "embed"), multi) == PS(("pod", "data"),
                                                            None)
    # trailing axes dropped until the dim divides: 2 rows over pod x data
    # (32) keep pod (2); 1 row keeps nothing; 8 heads over 16 stay whole
    assert logical_to_spec(("batch",), multi, shape=(2,)) == PS("pod")
    assert logical_to_spec(("batch",), multi, shape=(1,)) == PS(None)
    assert logical_to_spec(("batch",), multi, shape=(64,)) == PS(
        ("pod", "data"))
    assert logical_to_spec(("kv_heads", None), single,
                           shape=(8, 128)) == PS(None, None)
    # a mesh axis is used once: mlp and vocab both want "model"
    assert logical_to_spec(("mlp", "vocab"), single) == PS("model", None)
    assert logical_to_spec(("batch", "opt_state"), multi) == PS(
        ("pod", "data"), None)
    # no mesh: the three production axis names, nothing divided
    assert logical_to_spec(("batch", "heads")) == PS(("pod", "data"),
                                                     "model")


def test_use_mesh_nests_and_restores():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert active_mesh() is None
    with use_mesh(single):
        assert active_mesh() is single
        assert logical_to_spec(("batch", "embed")) == PS("data", None)
        with use_mesh(multi, rules={"embed": "model"}):
            assert active_mesh() is multi
            assert logical_to_spec(("batch", "embed")) == PS(
                ("pod", "data"), "model")
        assert active_mesh() is single
        assert logical_to_spec(("batch", "embed")) == PS("data", None)
    assert active_mesh() is None


def test_constrain_identity_and_refusal():
    x = torch.ones(4, 8)
    assert constrain(x, "batch", "embed") is x
    with use_mesh(make_host_mesh(4, device="cpu")):
        assert make_host_mesh(4, device="cpu").shape == (1, 1)
        assert constrain(x, "batch", "embed") is x
    with use_mesh(make_production_mesh()):
        with pytest.raises(NotImplementedError, match="256 devices"):
            constrain(x, "batch", "mlp")


def test_placements_on_multi_pod():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    sh = NamedSharding(mesh, PS(("pod", "data"), None, "model"))
    assert sh.placements() == [Shard(0), Shard(0), Shard(2)]
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
    assert NamedSharding(mesh, PS()).placements() == [Replicate()] * 3
    assert NamedSharding(mesh, PS(None, "data")).placements() == [
        Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        NamedSharding(mesh, PS(("data", "pod"))).placements()
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((48, 3, 32))


# one gloo process on the CPU: the host mesh is sized by the process
# group, and ``Mesh.device_mesh()`` builds its DeviceMesh
GLOO = r"""
import socket
import sys
import torch.distributed as dist

sys.path.insert(0, sys.argv[1])
from repro_torch.launch.mesh import make_host_mesh

with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=1, rank=0)
try:
    mesh = make_host_mesh(2, device="cpu")
    dm = mesh.device_mesh()
    assert mesh.shape == (1, 1), mesh
    assert dm.mesh_dim_names == ("data", "model"), dm.mesh_dim_names
    assert tuple(dm.mesh.shape) == (1, 1), dm.mesh
    assert dm.device_type == "cpu"
finally:
    dist.destroy_process_group()
print("ok")
"""


def test_host_mesh_in_a_process_group():
    run = subprocess.run([sys.executable, "-c", GLOO, str(ROOT / "src")],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert run.returncode == 0, run.stdout + run.stderr[-4000:]
    assert run.stdout.strip().endswith("ok")


def test_mesh_shapes():
    assert make_production_mesh().shape == (16, 16)
    assert make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    m = make_host_mesh(device="cpu")
    assert (m.axis_names, m.shape, m.size, m.device_type) == (
        ("data", "model"), (1, 1), 1, "cpu")
    with pytest.raises(ValueError):
        Mesh(("data",), (2, 2))
