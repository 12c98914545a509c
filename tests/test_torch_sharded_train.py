"""The train step sharded over a mesh of processes, against the reference's
bundle on the same mesh and against the port's one-process run.

Ranks are real processes on the CPU, one gloo group per mesh shape
((2, 1), (1, 2), (2, 2) over ("data", "model")), meeting at a file store
in the test's temporary directory (``repro_torch.launch.mesh.run_ranks``,
one thread each; every group has its own timeout, after which the parent
kills its ranks). Each rank runs ``tests/_torch_sharded_rank.py`` with
one thread, every case of its mesh in one start-up. The reference's
``make_train_step`` bundle runs jitted with its ``in_shardings`` and
``out_shardings`` in a subprocess on 4 fake host devices, on meshes
built with ``AxisType.Auto`` axes (its own ``make_host_mesh`` builds
``Explicit`` axes in this JAX and raises: pinned in
``tests/test_torch_dryrun_reference.py``). Both start from the JAX
model's parameters (``PRNGKey(0)``, carried across by
``params_from_jax``) and take the same seeded batches, f32 activations.

Each case of reduced qwen2.5-14b (dense; AdamW, and Adafactor on
(2, 2)), mamba2-130m (ssm) and qwen3-moe-30b-a3b (moe, AdamW) runs 3
steps at the step builders' default lr, 3e-4, held three ways:

  (a) against the reference on the same mesh: every step's loss within
      LOSS_TOL = 1e-4 absolute and grad norm within NORM_REL = 1e-4
      relative (the one-step tests hold 1e-5; AdamW's first update is
      nearly lr * sign(g), so a gradient element at the sums' noise
      moves by lr either way, and three steps let that grow: at
      train()'s lr, 3e-3, the MoE's grad norm drifts 2.3e-3 from the
      reference's by step 2, its loss 2.5e-5, in the one-process run as
      much as in the sharded ones; the reference differs from itself
      across meshes by up to 2.1e-3 in loss at its default dtypes);
  (b) against the port's one-process step on the same inputs, the same
      bounds;
  (c) the bytes each rank holds of the parameters, optimizer state and
      batch equal ``dryrun.price``'s argument bytes for that mesh,
      exactly, every leaf a ``DTensor`` on the CPU.

``train()`` on (2, 1): 12 steps of reduced mamba2 lower the loss by more
than 0.1; 8 steps straight equal 4, a checkpoint and a resume, bit for
bit; the checkpoint, written once by rank 0, restores in the port on one
process and in the reference's ``CheckpointManager`` bit for bit.
``train()`` at its default dtypes (bf16 activations) on each mesh against
one process: every loss within TRAIN_LOSS_TOL = 1e-2 absolute (reduced
mamba2 on (2, 1) lies 1.3e-3 from one process over 3 steps, 4.4e-3 over
12; on (1, 2) every rank computes the whole batch and the losses are
equal;
``chip_smoke.py`` phase 12 holds the card to the same bound). The
hybrid, vlm and audio families (jamba's Adafactor, qwen2-vl's
``positions``, whisper's ``encoder_embeds``) run (a), (b) and (c)
behind ``-m slow``; whisper's (a) holds step 0 alone, its grad norm
within WHISPER_GRAD_REL = 2e-3, the bound of its gradients in
``tests/test_torch_train_families.py``: its random-init attention is
near one-hot and magnifies f32 rounding: the reference's own (2, 1)
and (1, 2) runs differ by 3.5e-4 in grad norm at step 0, and by step 1
the port's one-process run lies 3.3e-4 from the reference's in loss,
while the port's sharded and one-process runs agree to 2e-6.
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

from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.models.transformer import build_model as jbuild_model
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.launch.train import train
from repro_torch.models.transformer import build_model
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_sharded_rank import batch, case_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK = ROOT / "tests" / "_torch_sharded_rank.py"
LOSS_TOL, NORM_REL, TRAIN_LOSS_TOL = 1e-4, 1e-4, 1e-2
WHISPER_GRAD_REL = 2e-3
B, S, STEPS, LR = 4, 32, 3, 3e-4
GROUP_TIMEOUT, REFERENCE_TIMEOUT = 300, 300
DENSE, SSM, MOE = "qwen2.5-14b", "mamba2-130m", "qwen3-moe-30b-a3b"
MESHES = {(2, 1): [(DENSE, "adamw"), (SSM, "adamw"), (MOE, "adamw")],
          (1, 2): [(DENSE, "adamw"), (SSM, "adamw"), (MOE, "adamw")],
          (2, 2): [(DENSE, "adamw"), (DENSE, "adafactor")]}
SLOW_MESHES = {(2, 1): [("jamba-1.5-large-398b", "adafactor"),
                        ("qwen2-vl-7b", "adamw"), ("whisper-base", "adamw")],
               (1, 2): [("jamba-1.5-large-398b", "adafactor"),
                        ("qwen2-vl-7b", "adamw"), ("whisper-base", "adamw")]}
CASES = [(m, a, o) for m, cs in MESHES.items() for a, o in cs]
SLOW_CASES = [(m, a, o) for m, cs in SLOW_MESHES.items() for a, o in cs]

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro.configs.base import ShapeConfig, get_config
from repro.distributed.sharding import use_mesh
from repro.launch.steps import make_optimizer, make_train_step
from repro.models.transformer import build_model
sys.path.insert(0, sys.argv[2])
from _torch_sharded_rank import batch
out = {}
for c in json.load(open(sys.argv[1])):
    cfg = dataclasses.replace(get_config(c["arch"]).reduced(),
                              dtype=jnp.float32, optimizer=c["optimizer"])
    model = build_model(cfg)
    d, m = c["mesh"]
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    shape = ShapeConfig("t", c["seq"], c["batch"], "train")
    with use_mesh(mesh):
        bundle = make_train_step(model, mesh, shape, lr=c["lr"])
        step = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                       out_shardings=bundle.out_shardings)
        like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        with np.load(c["params"]) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        params = jax.tree.unflatten(jax.tree.structure(like),
                                    [jnp.asarray(a) for a in leaves])
        state = make_optimizer(cfg, c["lr"]).init(params)
        losses, norms = [], []
        for s in range(c["steps"]):
            b = {k: jnp.asarray(v) for k, v in batch(cfg, shape, s).items()}
            params, state, mt = step(params, state, b)
            losses.append(float(mt["loss"]))
            norms.append(float(mt["grad_norm"]))
    out[c["name"]] = {"losses": losses, "grad_norms": norms}
print(json.dumps(out))
"""


def _name(mesh, arch, optimizer):
    return f"{mesh[0]}x{mesh[1]}/{arch}/{optimizer}"


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(ROOT / "src")}


def _params_npz(tmp, arch, optimizer):
    """The JAX model's parameters at ``PRNGKey(0)``, leaf by leaf in
    ``jax.tree`` order."""
    path = tmp / f"{arch}.npz"
    if not path.exists():
        jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                   dtype=jnp.float32, optimizer=optimizer)
        leaves = jax.tree.leaves(jbuild_model(jcfg).init(
            jax.random.PRNGKey(0)))
        np.savez(path, **{f"leaf_{i}": np.asarray(x)
                          for i, x in enumerate(leaves)})
    return str(path)


def one_process(case):
    """The port's step on one process, from the same parameters and
    batches."""
    cfg = case_config(case)
    model = build_model(cfg)
    shape = ShapeConfig("t", case["seq"], case["batch"], "train")
    fn = make_train_step(model, Mesh(("data", "model"), (1, 1), "cpu"),
                         shape, lr=case["lr"]).fn
    with np.load(case["params"]) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    params = params_from_jax(tree_unflatten(
        tree_flatten(model.param_shapes())[1], leaves), "cpu")
    state = make_optimizer(cfg, case["lr"]).init(params)
    losses, norms = [], []
    for step in range(case["steps"]):
        b = {k: torch.from_numpy(v) if v.dtype.kind == "f"
             else torch.from_numpy(v).long()
             for k, v in batch(cfg, shape, step).items()}
        params, state, m = fn(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


def _run_group(tmp, mesh, cases):
    job = tmp / f"job_{mesh[0]}x{mesh[1]}.json"
    job.write_text(json.dumps({"model_parallel": mesh[1], "cases": cases}))
    prefix = tmp / f"out_{mesh[0]}x{mesh[1]}"
    ranks = run_ranks([sys.executable, str(RANK), str(job), str(prefix)],
                      mesh[0] * mesh[1], GROUP_TIMEOUT, env=_env(),
                      cwd=str(ROOT))
    for r, (code, _, err) in enumerate(ranks):
        assert code == 0, f"{mesh} rank {r} exited {code}:\n{err[-4000:]}"
    return [json.loads(Path(f"{prefix}.{r}.json").read_text())
            for r in range(len(ranks))]


def _run_all(tmp, meshes, with_train):
    """Every group, the reference and the one-process runs at once."""
    step_cases = {m: [dict(kind="step", name=_name(m, a, o), arch=a,
                           optimizer=o, params=_params_npz(tmp, a, o),
                           steps=STEPS, batch=B, seq=S, lr=LR)
                      for a, o in cs] for m, cs in meshes.items()}
    jobs = {m: list(cs) for m, cs in step_cases.items()}
    if with_train:
        for m in jobs:
            jobs[m].append(dict(kind="train", name="train",
                                restart=m == (2, 1),
                                dir=str(tmp / f"ck_{m[0]}x{m[1]}")))
    ref_job = tmp / "reference.json"
    ref_job.write_text(json.dumps(
        [dict(c, mesh=list(m)) for m, cs in step_cases.items()
         for c in cs]))
    env = {**_env(), "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    with cf.ThreadPoolExecutor(len(jobs) + 1) as ex:
        ref = ex.submit(subprocess.run,
                        [sys.executable, "-c", REFERENCE, str(ref_job),
                         str(ROOT / "tests")], env=env, capture_output=True,
                        text=True, timeout=REFERENCE_TIMEOUT, cwd=ROOT)
        groups = {m: ex.submit(_run_group, tmp, m, cs)
                  for m, cs in jobs.items()}
        one = {c["name"]: one_process(c) for cs in step_cases.values()
               for c in cs}
        priced = {c["name"]: dryrun.price(
            case_config(c), ShapeConfig("t", S, B, "train"),
            Mesh(("data", "model"), m, "cpu"))["memory"][
                "argument_size_in_bytes"]
            for m, cs in step_cases.items() for c in cs}
        one_train = ({n: train("mamba2-130m", steps=12, batch=4, seq=32,
                               log_every=100, device="cpu",
                               num_microbatches=n)["losses"]
                      for n in (1, 2)} if with_train else None)
        run = ref.result()
        assert run.returncode == 0, run.stderr[-4000:]
        ranks = {m: g.result() for m, g in groups.items()}
    return dict(reference=json.loads(run.stdout.strip().splitlines()[-1]),
                ranks=ranks, one=one, priced=priced, one_train=one_train,
                ck_dir=tmp / "ck_2x1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("sharded"), MESHES, True)


def _close(got, want, what, steps=STEPS, norm_rel=NORM_REL):
    for i, (g, w) in enumerate(zip(got["losses"][:steps],
                                   want["losses"][:steps])):
        assert abs(g - w) <= LOSS_TOL, (what, "loss", i, g, w)
    for i, (g, w) in enumerate(zip(got["grad_norms"][:steps],
                                   want["grad_norms"][:steps])):
        assert abs(g / w - 1) <= norm_rel, (what, "grad norm", i, g, w)


def _check(runs, mesh, arch, optimizer):
    name = _name(mesh, arch, optimizer)
    ranks = [r["cases"][name] for r in runs["ranks"][mesh]]
    print(f"\n{name}: losses {ranks[0]['losses']}, reference "
          f"{runs['reference'][name]['losses']}, one process "
          f"{runs['one'][name]['losses']}; bytes per rank "
          f"{[r['argument_bytes'] for r in ranks]}, dry run "
          f"{runs['priced'][name]}")
    for r in ranks:                 # global: the same on every rank
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_norms"] == ranks[0]["grad_norms"]
    return name, ranks


@pytest.mark.parametrize("mesh,arch,optimizer", CASES)
def test_sharded_step_matches_reference_on_the_same_mesh(runs, mesh, arch,
                                                         optimizer):
    name, ranks = _check(runs, mesh, arch, optimizer)
    _close(ranks[0], runs["reference"][name], "reference")


@pytest.mark.parametrize("mesh,arch,optimizer", CASES)
def test_sharded_step_matches_one_process(runs, mesh, arch, optimizer):
    name, ranks = _check(runs, mesh, arch, optimizer)
    _close(ranks[0], runs["one"][name], "one process")


@pytest.mark.parametrize("mesh,arch,optimizer", CASES)
def test_bytes_per_rank_equal_the_dry_run(runs, mesh, arch, optimizer):
    name, ranks = _check(runs, mesh, arch, optimizer)
    for r in ranks:
        assert r["argument_bytes"] == runs["priced"][name]
        assert r["devices"] == ["cpu"] and r["dtensors"]


def test_every_rank_has_its_coordinates(runs):
    for mesh, ranks in runs["ranks"].items():
        assert sorted((r["coords"]["data"], r["coords"]["model"])
                      for r in ranks) == [(d, m) for d in range(mesh[0])
                                          for m in range(mesh[1])]
        assert all(r["mesh"] == list(mesh) for r in ranks)


def test_train_on_a_data_mesh_drops_the_loss_and_restarts_exactly(runs):
    first = runs["ranks"][(2, 1)][0]["cases"]["train"]
    for r in runs["ranks"][(2, 1)]:
        t = r["cases"]["train"]
        assert t["twelve"]["mesh"] == [2, 1]
        assert np.isfinite(t["twelve"]["losses"]).all()
        assert t["twelve"]["loss_drop"] > 0.1
        assert t["resumed"] == t["straight"][4:]
        assert t["params_equal"]
        assert t["straight"] == first["straight"]
        assert t["twelve"]["losses"] == first["twelve"]["losses"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_matches_one_process(runs, mesh):
    """``train()`` at its default dtypes on each mesh equals, bit for bit,
    ``train()`` on one process with as many microbatches as the mesh has
    data shards (each rank computes its shard's rows, and the mean of
    two is one sum and one division either way); against one microbatch
    every step lies within TRAIN_LOSS_TOL."""
    one = runs["one_train"]
    for r in runs["ranks"][mesh]:
        got = r["cases"]["train"]["twelve"]
        assert got["mesh"] == list(mesh)
        assert got["losses"] == one[mesh[0]]
        diff = max(abs(a - b) for a, b in zip(got["losses"], one[1]))
        print(f"\n{mesh}: largest loss difference from one microbatch "
              f"{diff:.3e}")
        assert diff <= TRAIN_LOSS_TOL


def test_checkpoint_from_a_data_mesh_restores_on_one_process(runs):
    """The (2, 1) run's last checkpoint (step 7, rank 0's write of the
    gathered state) restores on one process in the port and in the
    reference's manager, bit for bit with the parameters the ranks
    gathered at the end of the run."""
    d = str(runs["ck_dir"])
    cfg = get_config("mamba2-130m").reduced()
    model = build_model(cfg)
    like = model.init(0, device="cpu")
    state_like = make_optimizer(cfg, 1e-2).init(like)
    mgr = CheckpointManager(CheckpointConfig(d))
    assert mgr.latest_step() == 7
    step, (params, state) = mgr.restore((like, state_like))
    assert step == 7 and int(state.step) == 8
    with np.load(Path(d) / "straight_params.npz") as z:
        want = [z[f"leaf_{i}"] for i in range(len(z.files))]
    got = tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    jcfg = jget_config("mamba2-130m").reduced()
    jlike = jax.tree.map(
        jnp.zeros_like, jbuild_model(jcfg).init(jax.random.PRNGKey(1)))
    jstep, (jparams, _) = JCheckpointManager(JCheckpointConfig(d)).restore(
        (jlike, jmake_optimizer(jcfg, 1e-2).init(jlike)))
    assert jstep == 7
    for a, b in zip(jax.tree.leaves(jparams), want):
        assert np.array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("families"), SLOW_MESHES, False)


@pytest.mark.slow
@pytest.mark.parametrize("mesh,arch,optimizer", SLOW_CASES)
def test_other_families_sharded(family_runs, mesh, arch, optimizer):
    """(a), (b) and (c) for the hybrid, vlm and audio families."""
    name, ranks = _check(family_runs, mesh, arch, optimizer)
    if arch == "whisper-base":
        _close(ranks[0], family_runs["reference"][name], "reference",
               steps=1, norm_rel=WHISPER_GRAD_REL)
    else:
        _close(ranks[0], family_runs["reference"][name], "reference")
    _close(ranks[0], family_runs["one"][name], "one process")
    for r in ranks:
        assert r["argument_bytes"] == family_runs["priced"][name]
