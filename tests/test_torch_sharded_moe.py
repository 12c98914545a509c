"""The moe and hybrid families' serving steps sharded over a mesh of
processes: the MoE blocks expert-parallel over the data axes (an
all-to-all carries each block's expert inputs to their experts' ranks and
the outputs back), everything else tensor-parallel over the model axis,
against the reference's bundles on the same mesh and against the port's
one-process steps.

Ranks are real processes on the CPU, one gloo group per mesh, running
``tests/_torch_sharded_serving_rank.py`` (``test_torch_sharded_serving.py``'s
rank script: the prefill of 4 prompts, the cache resharded and padded to
the decode capacity, then a decode step per ``cache_index``). The
reference's ``make_prefill_step`` / ``make_decode_step`` run jitted with
their shardings in a subprocess on 4 fake host devices with
``AxisType.Auto`` axes, on torch ops; all start from the JAX model's
parameters (``PRNGKey(0)``) cast to the model dtype.

The meshes and what they exercise, on reduced configs (4 experts, top-2,
expert hidden width 32):

  qwen3-moe-30b-a3b  (2, 1)  2 experts a rank, pure expert parallelism,
                             in f32 and bf16;
                     (4, 1)  1 expert and 1 row a rank;
                     (2, 2)  2 experts a rank over data, each expert's
                             hidden columns and the heads over model;
                     (3, 1)  3 does not divide 4 experts (nor 4 rows):
                             the experts stay whole on every rank and
                             nothing is exchanged;
                     (2, 2, 1) over ("pod", "data", "model"): the expert
                             axis spans pod x data, 1 expert a rank;
  arctic-480b        (2, 2)  the dense residual, column- and row-parallel;
  jamba-1.5-large    (2, 2)  one period of 8 layers: mamba2, attention,
                             dense MLP and MoE layers, its mixed cache;
                     (1, 2)  the experts whole, their columns split.

Each step's logits and every cache leaf, gathered whole, are held by
relative L2 error:

  (a) against the reference on the same mesh: REF_TOL (f32 1e-4,
      ``test_torch_steps.py``'s bound). The f32 cases hold the whole
      steps' logits there; the bf16 cases are held against one process
      only (bf16 rounding alone puts two implementations' routing a
      near-tie apart, ``tests/_torch_routing.py``);
  (b) against the port on one process: ONE_TOL (f32 2e-5, bf16 1e-6, as
      ``test_torch_sharded_serving.py``'s). The router's logits come
      from the product one process computes (the rank's rows at their
      places in the batch), so its top-k sets equal one process's and no
      expert choice flips; a bf16 case that flipped one would count as
      rounding only where the same case in f32 flips none, and here none
      flips in either;
  (c) each rank's bytes of the weights and batch equal ``dryrun.price``'s
      argument bytes exactly, every weight is held as its shard (none
      whole where its sharding splits it), and the bytes it sends into
      the all-to-alls of a step equal the dry run's ``moe_all_to_all``
      term (b_loc x E x C x D a pass, two a MoE layer; 0 where the
      experts stay whole).

Without a process group: the MoE block on threads that stand for the
ranks of an expert axis (its all-to-all and gather exchanged in memory)
equals the whole block, its router's choice too, and gathers no weight
but the router's; the experts' SwiGLU on threads that stand for a model
axis equals the whole product for each layout of its weights.
"""
import concurrent.futures as cf
import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.launch.steps import SHARDED_SERVING_FAMILIES
from repro_torch.models import moe
from repro_torch.models.transformer import FAMILIES

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_sharded_serving_rank import case_config  # noqa: E402
from test_torch_sharded_serving import (_env, _params_npz,  # noqa: E402
                                        one_process, rel_l2)

ROOT = Path(__file__).resolve().parents[1]
RANK = ROOT / "tests" / "_torch_sharded_serving_rank.py"
REF_TOL = {"f32": 1e-4}
ONE_TOL = {"bf16": 1e-6, "f32": 2e-5}
B = 4
GROUP_TIMEOUT, REFERENCE_TIMEOUT = 300, 300
MOE, ARCTIC, JAMBA = "qwen3-moe-30b-a3b", "arctic-480b", "jamba-1.5-large-398b"
DM, PDM = ("data", "model"), ("pod", "data", "model")
# (axes, shape) -> (arch, dtype, prompt S, decode capacity T, cache_index
#                   per step)
MESHES = {
    (DM, (2, 1)): [(MOE, "f32", 16, 32, [16, 17]), (MOE, "bf16", 16, 32,
                                                     [16])],
    (DM, (4, 1)): [(MOE, "f32", 16, 32, [16])],
    (DM, (2, 2)): [(MOE, "f32", 16, 32, [16, 17]),
                   (ARCTIC, "f32", 16, 32, [16]),
                   (JAMBA, "f32", 16, 32, [16])],
    (DM, (3, 1)): [(MOE, "f32", 16, 32, [16])],
    (DM, (1, 2)): [(JAMBA, "bf16", 16, 32, [16])],
    (PDM, (2, 2, 1)): [(MOE, "f32", 16, 32, [16])],
}


def _mesh_name(axes, shape):
    return "x".join(map(str, shape)) + ("" if axes == DM else "pdm")


def _name(axes, shape, c):
    return f"{_mesh_name(axes, shape)}/{c[0]}/{c[1]}/S{c[2]}T{c[3]}"


CASES = [(key, _name(*key, c)) for key, cs in MESHES.items() for c in cs]
REF_CASES = [(key, n) for key, n in CASES if n.split("/")[2] in REF_TOL]

# ``test_torch_sharded_serving.py``'s reference, on a mesh of any axes
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
    shape = tuple(c["shape"])
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                tuple(c["axes"]), axis_types=(AxisType.Auto,) * len(shape))
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
        logits, cache = run[0](params, {
            k: jnp.asarray(v, cfg.dtype if v.dtype.kind == "f" else None)
            for k, v in pb.items()})
        out["prefill/logits"] = logits
        out.update({f"prefill/{k}": v for k, v in cache.items()})
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


def _priced(case, axes, shape):
    """The dry run's argument bytes and ``moe_all_to_all`` bytes a rank,
    of the prefill and the decode step."""
    cfg = case_config(case)
    m = Mesh(axes, shape, "cpu")
    out = {"argument_bytes": {}, "a2a_bytes": {}}
    for kind, n in (("prefill", case["prompt"]),
                    ("decode", case["capacity"])):
        p = dryrun.price(cfg, ShapeConfig(kind, n, B, kind), m)
        out["argument_bytes"][kind] = p["memory"]["argument_size_in_bytes"]
        out["a2a_bytes"][kind] = p["collective_terms"].get(
            "moe_all_to_all", {}).get("bytes", 0)
    return out


def _run_group(tmp, axes, shape, cases):
    name = _mesh_name(axes, shape)
    job = tmp / f"job_{name}.json"
    job.write_text(json.dumps({"axes": list(axes), "shape": list(shape),
                               "cases": cases}))
    prefix = tmp / f"out_{name}"
    world = int(np.prod(shape))
    ranks = run_ranks([sys.executable, str(RANK), str(job), str(prefix)],
                      world, GROUP_TIMEOUT, env=_env(), cwd=str(ROOT))
    for r, (code, _, err) in enumerate(ranks):
        assert code == 0, f"{shape} rank {r} exited {code}:\n{err[-4000:]}"
    return ([json.loads(Path(f"{prefix}.{r}.json").read_text())
             for r in range(world)],
            {c["name"]: dict(np.load(
                f"{prefix}.{c['name'].replace('/', '_')}.npz"))
             for c in cases})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group, the reference and the one-process runs at once."""
    tmp = tmp_path_factory.mktemp("sharded_moe")
    cases = {key: [dict(name=_name(*key, c), arch=c[0], dtype=c[1],
                        prompt=c[2], capacity=c[3], indices=c[4], batch=B,
                        overrides={}, params=_params_npz(tmp, c[0], {}))
                   for c in cs] for key, cs in MESHES.items()}
    ref = [dict(c, axes=list(key[0]), shape=list(key[1]),
                out=str(tmp / f"ref_{c['name'].replace('/', '_')}.npz"))
           for key, cs in cases.items() for c in cs
           if c["dtype"] in REF_TOL]
    # three reference processes, each jitting a third of the cases
    env = {**_env(), "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    halves = [ref[0::3], ref[1::3], ref[2::3]]
    for i, h in enumerate(halves):
        (tmp / f"reference{i}.json").write_text(json.dumps(h))
    with cf.ThreadPoolExecutor(len(cases) + len(halves)) as ex:
        refs = [ex.submit(subprocess.run,
                          [sys.executable, "-c", REFERENCE,
                           str(tmp / f"reference{i}.json"),
                           str(ROOT / "tests")], env=env, capture_output=True,
                          text=True, timeout=REFERENCE_TIMEOUT, cwd=ROOT)
                for i in range(len(halves))]
        groups = {key: ex.submit(_run_group, tmp, *key, cs)
                  for key, cs in cases.items()}
        one = {c["name"]: one_process(c) for cs in cases.values()
               for c in cs}
        priced = {c["name"]: _priced(c, *key) for key, cs in cases.items()
                  for c in cs}
        for r in refs:
            run = r.result()
            assert run.returncode == 0, run.stderr[-4000:]
        ranks = {key: g.result() for key, g in groups.items()}
    reference = {c["name"]: dict(np.load(c["out"])) for c in ref}
    return dict(cases={c["name"]: c for cs in cases.values() for c in cs},
                ranks=ranks, reference=reference, one=one, priced=priced)


def _hold(runs, key, name, against, tol):
    got = runs["ranks"][key][1][name]
    want = runs[against][name]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    print(f"\n{name} against {against}: worst "
          f"{max(errs.values()):.2e} [<= {tol:g}]")
    bad = {k: e for k, e in errs.items() if not e <= tol}
    assert not bad, bad


@pytest.mark.parametrize("key,name", REF_CASES)
def test_sharded_moe_matches_reference_on_the_same_mesh(runs, key, name):
    _hold(runs, key, name, "reference",
          REF_TOL[runs["cases"][name]["dtype"]])


@pytest.mark.parametrize("key,name", CASES)
def test_sharded_moe_matches_one_process(runs, key, name):
    _hold(runs, key, name, "one", ONE_TOL[runs["cases"][name]["dtype"]])


@pytest.mark.parametrize("key,name", CASES)
def test_bytes_and_all_to_all_bytes_equal_the_dry_run(runs, key, name):
    want = runs["priced"][name]
    for r in runs["ranks"][key][0]:
        got = r["cases"][name]
        assert got["argument_bytes"] == want["argument_bytes"], (
            r["rank"], got["argument_bytes"], want["argument_bytes"])
        assert got["shards_ok"]
        assert got["a2a_bytes"] == want["a2a_bytes"], (
            r["rank"], got["a2a_bytes"], want["a2a_bytes"])
    # the meshes whose data axes divide the experts exchange; (3, 1) and
    # (1, 2) keep them whole
    split = key[1] not in ((3, 1), (1, 2))
    assert (want["a2a_bytes"]["prefill"] > 0) == split, want


def test_the_expert_axis_spans_the_data_axes(runs):
    """Every rank has its coordinates; on (2, 2, 1) the all-to-all's group
    is the 4 ranks of pod x data."""
    for (axes, shape), (ranks, _) in runs["ranks"].items():
        got = sorted(tuple(r["coords"][a] for a in axes) for r in ranks)
        assert got == sorted(np.ndindex(*shape))
    assert sharding.expert_axes(Mesh(PDM, (2, 2, 1), "cpu"), 4) == (
        "pod", "data")
    assert sharding.expert_axes(Mesh(DM, (3, 1), "cpu"), 4) == ()
    assert sharding.expert_axes(Mesh(PDM, (2, 3, 1), "cpu"), 4) == ("pod",)


def test_every_family_serves_sharded():
    assert sorted(SHARDED_SERVING_FAMILIES) == sorted(FAMILIES)


# -- without a process group ------------------------------------------------


class ThreadedAxis(sharding.LocalAxis):
    """Rank ``index`` of an axis of ``world.n`` ranks that are threads of
    this process: its gather, sum and all-to-all exchange the ranks'
    parts in ``world.slots`` between two barriers, and record what the
    rank sent. ``rows`` as ``ExpertAxis.rows``."""
    kv, conv = None, False

    def __init__(self, world, index, rows=None):
        self.world, self.size, self.index = world, world.n, index
        self.rows, self.sent = rows, []

    def _parts(self, x):
        w = self.world
        w.slots[self.index] = x
        w.barrier.wait()
        parts = list(w.slots)
        w.barrier.wait()
        return parts

    def _all_gather(self, x):
        self.sent.append(("gather", tuple(x.shape)))
        return self._parts(x.contiguous())

    def sum(self, x):
        self.sent.append(("sum", tuple(x.shape)))
        parts = self._parts(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_to_all(self, x):
        self.sent.append(("all_to_all", tuple(x.shape)))
        n = x.shape[0] // self.size
        return torch.cat([p.narrow(0, self.index * n, n)
                          for p in self._parts(x.contiguous())])


def _world(n):
    world = type("World", (), {})()
    world.n, world.slots = n, [None] * n
    world.barrier = threading.Barrier(n)
    return world


def _run_threads(n, fn):
    with cf.ThreadPoolExecutor(n) as ex:
        return list(ex.map(fn, range(n)))


@pytest.mark.parametrize("arch,n", [(MOE, 2), (MOE, 4), (ARCTIC, 2)])
def test_expert_parallel_block_equals_the_whole_block(arch, n):
    """``n`` threads, each a data rank with its rows of a (4, 8) batch and
    its 4 / n experts' weights (the router's expert columns too), run the
    MoE block inside their expert axis: the outputs, concatenated, equal
    the whole block's (f32), each rank's top-k sets equal the whole
    router's rows exactly, and a rank sends the router's columns into one
    gather and two all-to-alls of (n, rows, 4 / n, C, D), nothing else."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              dtype=torch.float32)
    rng = np.random.default_rng(3)
    E, D = cfg.moe.num_experts, cfg.d_model
    params = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32) * 0.3) for k, p in moe.moe_specs(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((B, 8, D)).astype(np.float32))
    whole, _ = moe.moe_block(params, x, cfg)
    _, _, idx = moe.choose(params, x, cfg)
    world = _world(n)
    per, el = B // n, E // n
    axes = [ThreadedAxis(world, i, (i * per, B)) for i in range(n)]

    def rank(i):
        local = {k: (v[i * el:(i + 1) * el] if k in ("wi", "wg", "wo")
                     else v[:, i * el:(i + 1) * el] if k == "router" else v)
                 for k, v in params.items()}
        rows = x[i * per:(i + 1) * per]
        with sharding.use_expert_axis(axes[i]):
            out, _ = moe.moe_block(local, rows, cfg)
            _, _, got = moe.choose(local, rows, cfg)
        return out, got

    done = _run_threads(n, rank)
    torch.testing.assert_close(torch.cat([o for o, _ in done]), whole,
                               rtol=1e-6, atol=1e-6)
    for i, (_, got) in enumerate(done):
        assert torch.equal(got, idx[i * per:(i + 1) * per])
    C = moe._capacity(8, cfg)
    a2a = ("all_to_all", (n, per, el, C, D))
    for ax in axes:     # the block's, then ``choose``'s gather
        assert ax.sent == [("gather", (D, el)), a2a, a2a, ("gather", (D, el))]


@pytest.mark.parametrize("layout,m", [("split", 2), ("whole", 3),
                                      ("embed", 2)])
def test_experts_on_every_model_axis_layout(layout, m):
    """The experts' SwiGLU on ``m`` threads standing for a model axis
    equals the whole product (f32), for each way the serving shardings
    lay its weights over the axis: ``expert_mlp`` split (the rank's 32 /
    m columns, ``wo``'s partials summed); whole on every rank where m
    does not divide it (the rank's ``mlp_columns`` of 32 in units of 8:
    16, 16 and none, the last rank a zero partial);
    split on the embed dim, the serving fallback where neither the data
    axes divide the experts nor m their columns (``wg`` and ``wi`` on the
    rank's slice of the input, summed; ``wo``'s output columns,
    gathered)."""
    cfg = dataclasses.replace(get_config(MOE).reduced(),
                              dtype=torch.float32)
    rng = np.random.default_rng(4)
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    params = {k: torch.from_numpy(rng.standard_normal(
        moe.moe_specs(cfg)[k].shape).astype(np.float32) * 0.3)
        for k in ("wi", "wg", "wo")}
    xin = torch.from_numpy(rng.standard_normal((2, E, 6, D)).astype(
        np.float32))
    whole = moe.experts(params, xin, cfg)
    world = _world(m)

    def rank(i):
        if layout == "split":
            c = F // m
            local = {"wi": params["wi"][..., i * c:(i + 1) * c],
                     "wg": params["wg"][..., i * c:(i + 1) * c],
                     "wo": params["wo"][:, i * c:(i + 1) * c]}
        elif layout == "whole":
            local = params
        else:
            c = D // m
            local = {"wi": params["wi"][:, i * c:(i + 1) * c],
                     "wg": params["wg"][:, i * c:(i + 1) * c],
                     "wo": params["wo"][..., i * c:(i + 1) * c]}
        ax = ThreadedAxis(world, i)
        with sharding.use_model_axis(ax):
            return moe.experts(local, xin, cfg), ax.sent

    done = _run_threads(m, rank)
    for out, sent in done:
        torch.testing.assert_close(out, whole, rtol=1e-5, atol=1e-5)
        kinds = [k for k, _ in sent]
        assert kinds == {"split": ["sum"], "whole": ["sum"],
                         "embed": ["sum", "sum", "gather"]}[layout], sent
