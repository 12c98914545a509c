"""The serving steps sharded over a mesh of processes, tensor-parallel over
the model axis, against the reference's bundles on the same mesh and
against the port's one-process steps.

Ranks are real processes on the CPU, one gloo group per mesh shape
((2, 1), (1, 2), (2, 2), (1, 4) over ("data", "model")), meeting at a
file store (``repro_torch.launch.mesh.run_ranks``; every group has its
own timeout, after which the parent kills its ranks). Each rank runs
``tests/_torch_sharded_serving_rank.py`` with one thread, every case of
its mesh in one start-up: the weights laid out by the prefill step's
in-shardings (each rank keeps its shards), ``make_prefill_step``'s
``sharded_fn`` on 4 prompts, the cache resharded and padded to the
decode capacity (``decode_cache``), then ``make_decode_step``'s
``sharded_fn`` once per ``cache_index`` of the case. The reference's
``make_prefill_step`` / ``make_decode_step`` bundles run jitted with
their in- and out-shardings in a subprocess on 4 fake host devices, on
meshes built with ``AxisType.Auto`` axes (its own ``make_host_mesh``
builds ``Explicit`` axes in this JAX, pinned in ROADMAP Queue 3), on
torch ops (``use_pallas=False``: the port runs the kernels' plain
versions on the CPU). All start from the JAX model's parameters
(``PRNGKey(0)``) cast to the model dtype.

The cases cover reduced qwen2.5-14b in bf16 and f32, qwen2-vl-7b (M-RoPE
``positions``) and mamba2-130m; on (1, 4) the kv heads (2) fall back to
the embed dim and mamba2's ``conv_state`` split (160 channels: 40 a
rank) does not match the compute's (32 x channels a rank, B and C
whole); a decode capacity that the model axis does not divide (T = 31
on (1, 2): the cache split by kv heads; T = 30 on (1, 4): whole on every
rank) and a prompt that it does not divide (S = 15); per-slot
``cache_index`` whose writes cross a rank's boundary (16 on (1, 2); 8
and 16 on (1, 4)). Each step's logits and every cache leaf, gathered
whole, are held by relative L2 error:

  (a) against the reference: REF_TOL (f32 1e-4, test_torch_steps.py's
      bound; bf16 4e-2: the port's one-process steps themselves read
      1.2e-2 to 2.7e-2 against the reference here, the bf16 logits
      rounded in another order through two layers, and the sharded runs
      the same to within (b));
  (b) against the port on one process: ONE_TOL (bf16 1e-6, f32 2e-5;
      the CPU reads at most 2.7e-6 in f32 and 0 to 1.3e-9 in bf16: the
      sharded products sum their f32 parts in another order, and round
      once, as one process rounds its product. A control with the
      row-parallel partials rounded to bf16 before their sum reads
      1.0e-2 to 4.2e-2 in bf16, so the bf16 limit holds that one
      rounding);
  (c) each rank's bytes of the weights and batch equal
      ``dryrun.price``'s argument bytes for the mesh, exactly, and every
      weight is held as its shard, none whole where its sharding splits
      it. ``cache_index`` counts as the bundle's abstract scalar where
      the model reads it and not at all for mamba2, which never reads it
      (``jax.jit`` drops an unread input, and so does the dry run); the
      per-slot cases pass a (B,) one.

The moe, hybrid and audio families refuse a sharded step; the shard-wise
init draws what the whole init draws.
"""
import concurrent.futures as cf
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      serving_param_shapes,
                                      serving_param_shardings)
from repro_torch.models.transformer import build_model, pad_cache
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_sharded_serving_rank import (case_config, inputs,  # noqa: E402
                                         load_params)

ROOT = Path(__file__).resolve().parents[1]
RANK = ROOT / "tests" / "_torch_sharded_serving_rank.py"
REF_TOL = {"bf16": 4e-2, "f32": 1e-4}
ONE_TOL = {"bf16": 1e-6, "f32": 2e-5}
B = 4
GROUP_TIMEOUT, REFERENCE_TIMEOUT = 300, 300
DENSE, VLM, SSM = "qwen2.5-14b", "qwen2-vl-7b", "mamba2-130m"
# mesh -> (arch, dtype, prompt S, decode capacity T, cache_index per step)
MESHES = {
    (2, 1): [(DENSE, "bf16", 16, 32, [16, 17]), (SSM, "f32", 16, 32, [16])],
    (1, 2): [(DENSE, "bf16", 16, 32, [[15, 16, 16, 17], [16, 17, 17, 18]]),
             (DENSE, "f32", 15, 31, [15]), (SSM, "f32", 16, 32, [16, 17])],
    (2, 2): [(VLM, "f32", 16, 32, [16, 17]), (SSM, "bf16", 16, 32, [16])],
    (1, 4): [(DENSE, "f32", 16, 32, [[7, 8, 15, 16], [8, 9, 16, 17]]),
             (DENSE, "bf16", 16, 30, [16]), (SSM, "f32", 16, 32, [16, 17])],
}
SLOW_MESHES = {
    (1, 2): [(VLM, "bf16", 16, 32, [[15, 16, 16, 17]]),
             (SSM, "bf16", 15, 31, [15])],
    (1, 4): [(VLM, "f32", 16, 32, [[7, 8, 15, 16]]),
             (SSM, "bf16", 16, 32, [16])],
}


def _name(mesh, c):
    return f"{mesh[0]}x{mesh[1]}/{c[0]}/{c[1]}/S{c[2]}T{c[3]}"


CASES = [(m, _name(m, c)) for m, cs in MESHES.items() for c in cs]
SLOW_CASES = [(m, _name(m, c)) for m, cs in SLOW_MESHES.items() for c in cs]

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro.configs.base import ShapeConfig, get_config
from repro.distributed.sharding import use_mesh
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models.transformer import build_model, pad_cache
sys.path.insert(0, sys.argv[2])
from _torch_sharded_serving_rank import inputs
DT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
for c in json.load(open(sys.argv[1])):
    cfg = dataclasses.replace(get_config(c["arch"]).reduced(),
                              dtype=DT[c["dtype"]])
    model = build_model(cfg)
    d, m = c["mesh"]
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    b, s, t = c["batch"], c["prompt"], c["capacity"]
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    with np.load(c["params"]) as z:
        leaves = [jnp.asarray(z[f"leaf_{i}"], cfg.dtype)
                  for i in range(len(z.files))]
    params = jax.tree.unflatten(jax.tree.structure(like), leaves)
    pb, steps = inputs(cfg, c)
    out = {}
    with use_mesh(mesh):
        pre = make_prefill_step(model, mesh, ShapeConfig("p", s, b,
                                                         "prefill"))
        dec = make_decode_step(model, mesh, ShapeConfig("d", t, b, "decode"))
        run = [jax.jit(x.fn, in_shardings=x.in_shardings,
                       out_shardings=x.out_shardings) for x in (pre, dec)]
        logits, cache = run[0](params, jax.tree.map(jnp.asarray, pb))
        out["prefill/logits"] = logits
        out.update({f"prefill/{k}": v for k, v in cache.items()})
        # the reshard between the steps: the prefill's out-shardings to
        # the decode step's in-shardings
        cache = jax.device_put(pad_cache(cache, t),
                               dec.in_shardings[1]["cache"])
        for i, st in enumerate(steps):
            db = {k: jnp.asarray(v) for k, v in st.items()}
            db["cache"] = cache
            logits, cache = run[1](params, db)
            out[f"decode{i}/logits"] = logits
            out.update({f"decode{i}/{k}": v for k, v in cache.items()})
    np.savez(c["out"], **{k: np.asarray(v, np.float32)
                          for k, v in out.items()})
print("done")
"""


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(ROOT / "src")}


def _params_npz(tmp, arch):
    """The JAX model's parameters at ``PRNGKey(0)`` (f32), leaf by leaf in
    ``jax.tree`` order."""
    path = tmp / f"{arch}.npz"
    if not path.exists():
        leaves = jax.tree.leaves(jbuild_model(
            jget_config(arch).reduced()).init(jax.random.PRNGKey(0)))
        np.savez(path, **{f"leaf_{i}": np.asarray(x)
                          for i, x in enumerate(leaves)})
    return str(path)


def one_process(case):
    """The port's steps on one process, from the same weights and
    batches: every output by its key, as numpy."""
    cfg = case_config(case)
    model = build_model(cfg)
    S, T = case["prompt"], case["capacity"]
    one = Mesh(("data", "model"), (1, 1), "cpu")
    pre = make_prefill_step(model, one, ShapeConfig("p", S, B, "prefill"))
    dec = make_decode_step(model, one, ShapeConfig("d", T, B, "decode"))
    params = load_params(model, case["params"], cfg.dtype)
    pb, steps = inputs(cfg, case)
    logits, cache = pre.fn(params, {k: torch.from_numpy(v)
                                    for k, v in pb.items()})
    out = {"prefill/logits": logits}
    out.update({f"prefill/{k}": v for k, v in cache.items()})
    cache = pad_cache(cache, T)
    for i, st in enumerate(steps):
        logits, cache = dec.fn(params, {
            **{k: torch.as_tensor(v) for k, v in st.items()},
            "cache": cache})
        out[f"decode{i}/logits"] = logits
        out.update({f"decode{i}/{k}": v for k, v in cache.items()})
    return {k: v.float().numpy() for k, v in out.items()}


def _priced(case, mesh):
    cfg = case_config(case)
    m = Mesh(("data", "model"), mesh, "cpu")
    return {kind: dryrun.price(cfg, ShapeConfig(kind, n, B, kind), m)[
        "memory"]["argument_size_in_bytes"]
        for kind, n in (("prefill", case["prompt"]),
                        ("decode", case["capacity"]))}


def _run_group(tmp, mesh, cases):
    job = tmp / f"job_{mesh[0]}x{mesh[1]}.json"
    job.write_text(json.dumps({"model_parallel": mesh[1], "cases": cases}))
    prefix = tmp / f"out_{mesh[0]}x{mesh[1]}"
    ranks = run_ranks([sys.executable, str(RANK), str(job), str(prefix)],
                      mesh[0] * mesh[1], GROUP_TIMEOUT, env=_env(),
                      cwd=str(ROOT))
    for r, (code, _, err) in enumerate(ranks):
        assert code == 0, f"{mesh} rank {r} exited {code}:\n{err[-4000:]}"
    return ([json.loads(Path(f"{prefix}.{r}.json").read_text())
             for r in range(len(ranks))],
            {c["name"]: dict(np.load(
                f"{prefix}.{c['name'].replace('/', '_')}.npz"))
             for c in cases})


def _run_all(tmp, meshes):
    """Every group, the reference and the one-process runs at once."""
    cases = {m: [dict(name=_name(m, c), arch=c[0], dtype=c[1], prompt=c[2],
                      capacity=c[3], indices=c[4], batch=B,
                      params=_params_npz(tmp, c[0]))
                 for c in cs] for m, cs in meshes.items()}
    ref_job = tmp / "reference.json"
    ref_job.write_text(json.dumps(
        [dict(c, mesh=list(m), out=str(tmp / f"ref_{i}_{j}.npz"))
         for i, (m, cs) in enumerate(cases.items())
         for j, c in enumerate(cs)]))
    env = {**_env(), "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    with cf.ThreadPoolExecutor(len(cases) + 1) as ex:
        ref = ex.submit(subprocess.run,
                        [sys.executable, "-c", REFERENCE, str(ref_job),
                         str(ROOT / "tests")], env=env, capture_output=True,
                        text=True, timeout=REFERENCE_TIMEOUT, cwd=ROOT)
        groups = {m: ex.submit(_run_group, tmp, m, cs)
                  for m, cs in cases.items()}
        one = {c["name"]: one_process(c) for cs in cases.values()
               for c in cs}
        priced = {c["name"]: _priced(c, m) for m, cs in cases.items()
                  for c in cs}
        run = ref.result()
        assert run.returncode == 0, run.stderr[-4000:]
        ranks = {m: g.result() for m, g in groups.items()}
    reference = {c["name"]: dict(np.load(tmp / f"ref_{i}_{j}.npz"))
                 for i, (m, cs) in enumerate(cases.items())
                 for j, c in enumerate(cs)}
    return dict(cases={c["name"]: c for cs in cases.values() for c in cs},
                ranks=ranks, reference=reference, one=one, priced=priced)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("sharded_serving"), MESHES)


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _hold(runs, mesh, name, against, tol):
    got = runs["ranks"][mesh][1][name]
    want = runs[against][name]
    assert sorted(got) == sorted(want)
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    for k in want:
        assert got[k].shape == want[k].shape, k
    print(f"\n{name} against {against}: worst "
          f"{max(errs.values()):.2e} [<= {tol:g}]")
    bad = {k: e for k, e in errs.items() if not e <= tol}
    assert not bad, bad


@pytest.mark.parametrize("mesh,name", CASES)
def test_sharded_serving_matches_reference_on_the_same_mesh(runs, mesh,
                                                            name):
    _hold(runs, mesh, name, "reference",
          REF_TOL[runs["cases"][name]["dtype"]])


@pytest.mark.parametrize("mesh,name", CASES)
def test_sharded_serving_matches_one_process(runs, mesh, name):
    _hold(runs, mesh, name, "one", ONE_TOL[runs["cases"][name]["dtype"]])


@pytest.mark.parametrize("mesh,name", CASES)
def test_bytes_per_rank_equal_the_dry_run(runs, mesh, name):
    for r in runs["ranks"][mesh][0]:
        got = r["cases"][name]
        assert got["argument_bytes"] == runs["priced"][name], (
            r["rank"], got["argument_bytes"], runs["priced"][name])
        assert got["shards_ok"]


def test_every_rank_has_its_coordinates(runs):
    for mesh, (ranks, _) in runs["ranks"].items():
        assert sorted((r["coords"]["data"], r["coords"]["model"])
                      for r in ranks) == [(d, m) for d in range(mesh[0])
                                          for m in range(mesh[1])]


@pytest.fixture(scope="module")
def slow_runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("sharded_serving_slow"),
                    SLOW_MESHES)


@pytest.mark.slow
@pytest.mark.parametrize("mesh,name", SLOW_CASES)
def test_more_sharded_serving_cases(slow_runs, mesh, name):
    dtype = slow_runs["cases"][name]["dtype"]
    _hold(slow_runs, mesh, name, "reference", REF_TOL[dtype])
    _hold(slow_runs, mesh, name, "one", ONE_TOL[dtype])
    for r in slow_runs["ranks"][mesh][0]:
        assert r["cases"][name]["argument_bytes"] == slow_runs["priced"][name]


# -- without a process group ------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
                                  "whisper-base"])
def test_other_families_refuse_a_sharded_step(arch):
    """The moe, hybrid and audio families' sharded steps raise, naming the
    queue; the bundles (which the dry run prices) still build."""
    model = build_model(get_config(arch).reduced())
    mesh = Mesh(("data", "model"), (1, 2), "cpu")
    for make, shape in ((make_prefill_step, ShapeConfig("p", 8, 4,
                                                        "prefill")),
                        (make_decode_step, ShapeConfig("d", 8, 4,
                                                       "decode"))):
        bundle = make(model, mesh, shape)
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            bundle.sharded_fn({}, {})
    assert make_prefill_step(model, Mesh(("data", "model"), (1, 1), "cpu"),
                             ShapeConfig("p", 8, 4, "prefill")
                             ).sharded_fn is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_init_parts_equal_the_whole_init(monkeypatch, dtype):
    """``init(parts=...)`` keeps exactly the rank's slices of the whole
    draw, for every rank of (1, 4) and (2, 2), bf16 leaves drawn in
    slices of 3000 elements (so a rank's part spans several draws)."""
    from repro_torch.models import common
    monkeypatch.setattr(common, "DRAW_ELEMENTS", 3000)
    model = build_model(get_config(DENSE).reduced())
    whole = tree_leaves(model.init(3, device="cpu", dtype=dtype))
    shapes = serving_param_shapes(model)
    for mesh_shape in ((1, 4), (2, 2)):
        mesh = Mesh(("data", "model"), mesh_shape, "cpu")
        shs = serving_param_shardings(model.param_axes(), shapes, mesh)
        for rank in range(mesh.size):
            group = sharding.ShardGroup.__new__(sharding.ShardGroup)
            group.mesh = mesh
            where = divmod(rank, mesh_shape[1])
            group.coords = dict(zip(mesh.axis_names, where))
            parts = {}

            def slices(tree, sh, out):
                for k in tree:
                    if isinstance(tree[k], dict):
                        out[k] = {}
                        slices(tree[k], sh[k], out[k])
                    else:
                        out[k] = group.slices(sh[k], tree[k].shape)
            slices(shapes, shs, parts)
            got = tree_leaves(model.init(3, device="cpu", dtype=dtype,
                                         parts=parts))
            for g, w, p in zip(got, whole, tree_leaves(
                    parts, is_leaf=lambda x: isinstance(x, tuple))):
                assert torch.equal(g, w[p]), (mesh_shape, rank)


def test_constrain_raises_outside_a_model_axis():
    mesh = Mesh(("data", "model"), (1, 2), "cpu")
    x = torch.ones(2)
    with sharding.use_mesh(mesh):
        with pytest.raises(NotImplementedError):
            sharding.constrain(x, "batch")
        with sharding.use_model_axis(object()):
            assert sharding.constrain(x, "batch") is x
    assert sharding.model_axis() is None
