"""The port's dry run against the reference's compiled cells.

The reference runs in a subprocess on 8 fake host devices
(``--xla_force_host_platform_device_count=8``) on a (data 2, model 4) mesh
built with ``AxisType.Auto`` axes: the frozen ``make_production_mesh``
builds ``Explicit`` axes in this JAX, and its first sharding constraint
raises (pinned below). For reduced qwen2.5-14b, qwen3-moe-30b-a3b and
mamba2-130m, train, prefill and decode (``ShapeConfig("t", 64, 8, kind)``),
it lowers and compiles the step once with ``exact_costs`` and
``unroll_stack``: at two layers (two trips of one period) that is the
program that ``probe_costs`` extrapolates from, C(1) + (2 - 1) (C(2) -
C(1)) = C(2), so its counts are ``probe_costs``'s (one cell calls
``probe_costs`` itself to show it), and its ``memory_analysis()`` holds
the arguments and outputs of the plain step (the inputs and outputs do
not depend on those two flags).

Gates, per cell:
  memory   the port's ``argument_size_in_bytes``, ``output_size_in_bytes``
           and ``alias_size_in_bytes`` equal the reference's exactly;
  FLOPs    the port's global count equals, exactly, the FLOPs of the
           ``dot`` ops of the reference's lowered (global, unpartitioned)
           program whose contraction is longer than 1, each called
           computation counted as often as it is called. A product with
           no contraction (an outer product) is a ``dot`` in XLA and an
           elementwise multiply in torch's einsum, which
           ``FlopCounterMode`` does not count. One cell differs, by a
           stated amount: mamba2's train step, in its backward (the
           prefill cell, the same forward, is exact): JAX transposes
           each product of the SSD chunk's einsums, those without a
           contraction too, into dots, where torch's backward of a
           multiply is a multiply and a sum;
  bytes    the two count different programs (the port the eager step's
           aten ops, XLA its HLO ops, which materialize broadcasts,
           converts and transposes that torch runs as views or inside an
           op), so each cell's ratio to XLA's ``bytes accessed`` of the
           lowered program is held within 1% of its measured value.
Per device the port's FLOPs (global over 8) are at most the dot FLOPs of
XLA's partitioned program (fewer where the partitioner replicates a
product), and those at most XLA's own count, ``probe_costs``'s, which adds
elementwise ops. Printed beside the gates (run with ``-s``): those
ratios; the port's bytes against the compiled program's; and the
collective bytes by op against the reference's HLO totals, with the
reference's largest collectives by the source op that XLA records.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-14b", "qwen3-moe-30b-a3b", "mamba2-130m")
KINDS = ("train", "prefill", "decode")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# reference dot FLOPs less the port's (see the module docstring)
FLOP_GAP = {"mamba2-130m/train": 7077888}
# the port's global bytes over XLA's bytes accessed of the lowered program
BYTES_RATIO = {
    "qwen2.5-14b/train": 0.6380, "qwen2.5-14b/prefill": 0.6302,
    "qwen2.5-14b/decode": 0.6768, "qwen3-moe-30b-a3b/train": 0.6211,
    "qwen3-moe-30b-a3b/prefill": 0.5798, "qwen3-moe-30b-a3b/decode": 0.7195,
    "mamba2-130m/train": 0.6945, "mamba2-130m/prefill": 0.5990,
    "mamba2-130m/decode": 0.4067}

REFERENCE = r"""
import collections, dataclasses, json, math, re, sys
import jax
jax.devices()
from jax.sharding import AxisType
from repro.configs.base import ShapeConfig, get_config
from repro.distributed.sharding import use_mesh
from repro.launch.steps import make_step
import repro.launch.dryrun as d

SHAPE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
DOT = re.compile(r"=\s*\w+\[([\d,]*)\]\S*\s+dot\(%?([\w.\-]+),"
                 r".*lhs_contracting_dims=\{([\d,]*)\}")
CALL = re.compile(r"\s(?:call|fusion)\(.*(?:to_apply|calls)=%?([\w.\-]+)")
HEAD = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")


def dims(s):
    return [int(x) for x in s.split(",") if x]


def dot_flops(text):
    # 2 * |result| * |contraction| over the dots whose contraction is
    # longer than 1, each computation as often as it is called
    comps, entry, cur = {}, None, None
    for line in text.splitlines():
        if cur is None:
            m = HEAD.match(line)
            if m and not line.startswith("HloModule"):
                cur = comps[m.group(1)] = ({}, [], [])
                entry = m.group(1) if line.startswith("ENTRY") else entry
            continue
        if line.startswith("}"):
            cur = None
            continue
        for rx, i in ((SHAPE, 0), (DOT, 1), (CALL, 2)):
            m = (rx.match if i == 0 else rx.search)(line)
            if m and i == 0:
                cur[0][m.group(1)] = dims(m.group(2))
            elif m:
                cur[i].append(m.groups() if i == 1 else m.group(1))

    def total(name):
        shapes, dots, calls = comps[name]
        n = 0
        for out, lhs, con in dots:
            k = math.prod(shapes[lhs][j] for j in dims(con))
            n += 2 * math.prod(dims(out)) * k if k > 1 else 0
        return n + sum(total(c) for c in calls)
    return total(entry)


def by_source(text):
    # the reference's collective bytes by the source op XLA records
    acc = collections.Counter()
    for line in text.splitlines():
        s = line.strip()
        for op in d._COLLECTIVES:
            if "=" in s and (f" {op}(" in s or f" {op}-start(" in s):
                lhs = (s.split("=", 1)[0] + "="
                       + s.split("=", 1)[1].split(op)[0])
                src = re.search(r'op_name="([^"]*)"', s)
                src = src.group(1).rsplit("/", 2)[-2:] if src else ["?"]
                acc[f"{op} {'/'.join(src)}"] += (
                    d._shape_bytes(lhs) * (2.0 if op == "all-reduce" else 1.0))
                break
    return acc.most_common(4)


mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[1].split(","):
    cfg = get_config(arch).reduced()
    exact = dataclasses.replace(cfg, exact_costs=True, unroll_stack=True)
    for kind in sys.argv[2].split(","):
        shape = ShapeConfig("t", 64, 8, kind)
        with mesh, use_mesh(mesh):
            b = make_step(exact, mesh, shape)
            lo = jax.jit(b.fn, in_shardings=b.in_shardings,
                         out_shardings=b.out_shardings,
                         donate_argnums=b.donate_argnums
                         ).lower(*b.abstract_inputs)
            c = lo.compile()
            mem = c.memory_analysis()
            first = lambda x: x[0] if isinstance(x, (list, tuple)) else x
            cost, lcost = first(c.cost_analysis()), first(lo.cost_analysis())
            coll = d.collective_bytes(c.as_text())
        out[f"{arch}/{kind}"] = {
            "args": mem.argument_size_in_bytes,
            "out": mem.output_size_in_bytes,
            "alias": mem.alias_size_in_bytes,
            "temp": mem.temp_size_in_bytes,
            "flops": d._first(cost, "flops"),
            "bytes": d._first(cost, "bytes accessed", "bytes_accessed"),
            "global_bytes": d._first(lcost, "bytes accessed"),
            "global_dot_flops": dot_flops(lo.as_text(dialect="hlo")),
            "dot_flops": dot_flops(c.as_text()),
            "coll": coll, "coll_by_source": by_source(c.as_text())}
probe = d.probe_costs(get_config("qwen2.5-14b").reduced(),
                      ShapeConfig("t", 64, 8, "decode"), mesh)
out["probe/qwen2.5-14b/decode"] = {"flops": probe[0], "bytes": probe[1],
                                   "coll": probe[2]}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", REFERENCE, ",".join(ARCHS),
                          ",".join(KINDS)], env=env, capture_output=True,
                         text=True, timeout=110, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout)


def test_single_compile_is_probe_costs(reference):
    """At two layers the depth probe's extrapolation is its second probe:
    the one compile's counts are ``probe_costs``'s."""
    one, probe = (reference["qwen2.5-14b/decode"],
                  reference["probe/qwen2.5-14b/decode"])
    assert probe["flops"] == one["flops"] and probe["bytes"] == one["bytes"]
    for op in COLLECTIVES:
        assert probe["coll"][op]["bytes"] == one["coll"][op]["bytes"], op


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_memory_and_costs_against_reference(reference, arch, kind):
    key = f"{arch}/{kind}"
    ref = reference[key]
    mesh = Mesh(("data", "model"), (2, 4))
    cell = dryrun.price(get_config(arch).reduced(),
                        ShapeConfig("t", 64, 8, kind), mesh)
    mem = cell["memory"]
    assert mem["argument_size_in_bytes"] == ref["args"]
    assert mem["output_size_in_bytes"] == ref["out"]
    assert mem["alias_size_in_bytes"] == ref["alias"]
    flops = cell["flops_per_device"] * mesh.size
    nbytes = cell["bytes_per_device"] * mesh.size
    coll = cell["collectives"]
    print(f"\n{key}: FLOPs {flops:.0f} / dots {ref['global_dot_flops']}; "
          f"per device / partitioned dots "
          f"{cell['flops_per_device'] / ref['dot_flops']:.4f}, / XLA flops "
          f"{cell['flops_per_device'] / ref['flops']:.4f}; bytes / lowered "
          f"{nbytes / ref['global_bytes']:.4f}, per device / compiled "
          f"{cell['bytes_per_device'] / ref['bytes']:.4f}; temp "
          f"{mem['temp_size_in_bytes']} / {ref['temp']}; collective bytes "
          f"{coll['total_bytes']:.0f} / {ref['coll']['total_bytes']:.0f} ("
          f"{coll['total_bytes'] / ref['coll']['total_bytes']:.3f}): "
          + ", ".join(f"{op} {coll[op]['bytes']:.0f}/"
                      f"{ref['coll'][op]['bytes']:.0f}" for op in COLLECTIVES)
          + "; the reference's largest: "
          + ", ".join(f"{src} {b:.0f}" for src, b in ref["coll_by_source"]))
    assert ref["global_dot_flops"] - flops == FLOP_GAP.get(key, 0)
    # per device the port leaves out what the partitioner replicates, and
    # XLA's own count (``probe_costs``'s) adds elementwise ops
    assert cell["flops_per_device"] <= ref["dot_flops"] <= ref["flops"]
    assert nbytes / ref["global_bytes"] == pytest.approx(BYTES_RATIO[key],
                                                         rel=1e-2)


PINNED = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
jax.devices()
from repro.configs.base import ShapeConfig, get_config
from repro.launch.mesh import make_production_mesh
import repro.launch.dryrun as d
mesh = make_production_mesh()
print([str(t) for t in mesh.axis_types])
try:
    d._cell_costs(get_config("qwen2.5-14b").reduced(),
                  ShapeConfig("t", 64, 8, "prefill"), mesh)
    print("no error")
except ValueError as e:
    print("ValueError:", e)
"""


def test_reference_production_mesh_fault_is_pinned():
    """The frozen JAX package's fault: ``make_production_mesh`` calls
    ``jax.make_mesh`` without ``axis_types``, which this JAX makes
    ``Explicit``, and the step's first ``with_sharding_constraint``
    (``repro/distributed/sharding.py:160``) refuses a spec on such axes,
    so the reference's dry run reports ``error`` on every applicable cell.
    The test passes while the fault stands; the port's dry run prices the
    same cell."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", PINNED], env=env,
                         capture_output=True, text=True, timeout=110,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    types, result = run.stdout.strip().splitlines()[-2:]
    assert "Explicit" in types
    assert result.startswith("ValueError:") and "Auto axes" in result
    cell = dryrun.price(get_config("qwen2.5-14b").reduced(),
                        ShapeConfig("t", 64, 8, "prefill"),
                        Mesh(("data", "model"), (16, 16)))
    assert cell["flops_per_device"] > 0


HOST_MESH = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.devices()
from repro.launch.mesh import make_host_mesh
from repro.launch.train import train
print([str(t) for t in make_host_mesh(2).axis_types])
try:
    train("mamba2-130m", steps=2, batch=4, seq=32, model_parallel=2)
    print("no error")
except ValueError as e:
    print("ValueError:", e)
"""


def test_reference_host_mesh_fault_is_pinned():
    """The same fault in the reference's training driver: on a host of two
    devices ``make_host_mesh(2)`` builds ``Explicit`` axes, so
    ``repro.launch.train.train(model_parallel=2)`` raises at the step's
    first sharding constraint (a (1, 1) mesh would not: ``make_host_mesh``
    on one device). The port's ``train()`` runs such a mesh as a process
    group (``tests/test_torch_sharded_train.py``)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", HOST_MESH], env=env,
                         capture_output=True, text=True, timeout=110,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    types, result = run.stdout.strip().splitlines()[-2:]
    assert "Explicit" in types
    assert result.startswith("ValueError:") and "Auto axes" in result
