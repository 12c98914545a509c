"""The port's training stack against the JAX package's on reduced configs
(f32 activations, as tests/test_torch_dense.py sets them), parameters
carried across by ``params_from_jax`` and the same numpy batches:

  - ``loss_fn`` and its gradients on reduced mamba2-130m and qwen2.5-14b:
    the loss within 1e-5 absolute, each gradient leaf within 1e-4 relative
    L2 (sums in another order through the backward pass);
  - one whole train step against the reference's ``make_train_step``
    bundle with AdamW and with Adafactor: the loss within 1e-5 absolute,
    the grad norm (of order 10) within 1e-5 relative,
    the parameter change within 1e-3 relative L2 per leaf over the
    elements whose gradient stands above the gradient comparison's own
    noise floor (1e-4 of the leaf's largest); AdamW's first step divides
    m by sqrt(v) + eps, nearly sign(g), so below that floor the change is
    lr times the sign of the sums' noise in either package, and there it
    is held only within twice the leaf's largest change. (Reduced qwen's
    key bias has gradients down to 1e-6 of its largest: its change over
    all elements differs by 1.4e-3.)
  - port-only: 2 microbatches against 1 (rtol 5e-3, the reference's
    tests/test_train_driver.py bound), remat on against off (1e-6), the
    refusal to train a use_pallas config, and ``train()`` on the CPU:
    12 steps of reduced mamba2 drop the loss by more than 0.1 and a
    checkpoint restart is bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.transformer import build_model as jbuild_model
from repro.models.transformer import loss_fn as jloss_fn
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (compute_grads, make_optimizer,
                                      make_train_step)
from repro_torch.launch.train import train
from repro_torch.models.transformer import build_model, loss_fn
from repro_torch.tree import tree_leaves
from repro_torch.weights import opt_state_from_jax, params_from_jax

LOSS_TOL, GRAD_REL, CHANGE_REL = 1e-5, 1e-4, 1e-3
B, S = 4, 32
ARCHS = ("mamba2-130m", "qwen2.5-14b")


def rel_l2(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _batch(vocab, seed=0, batch=B, seq=S):
    r = np.random.default_rng(seed)
    toks = r.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    """``models(arch, optimizer)``: the reference's f32 model, parameters
    and jitted train step, and the port's model and parameters, built once
    per module."""
    built = {}

    def get(arch, optimizer="adamw"):
        key = (arch, optimizer)
        if key not in built:
            jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                       dtype=jnp.float32, optimizer=optimizer)
            jmodel = jbuild_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            jstep = jax.jit(jmake_train_step(
                jmodel, jmake_host_mesh(),
                JShapeConfig("t", S, B, "train")).fn)
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype=torch.float32,
                                      optimizer=optimizer)
            params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
            built[key] = (jmodel, jparams, jstep, build_model(cfg), params)
        return built[key]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(models, arch):
    jmodel, jparams, _, model, params = models(arch)
    b = _batch(model.cfg.vocab_size, 1)
    jb = jax.tree.map(jnp.asarray, b)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jmodel, p, jb), has_aux=True))(jparams)
    loss, parts = loss_fn(model, params, _tbatch(b))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    gloss, grads = compute_grads(model, params, _tbatch(b))
    assert float(gloss) == float(loss)
    g_leaves, w_leaves = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert rel_l2(g, w) <= GRAD_REL, (g.shape, rel_l2(g, w))


@pytest.mark.parametrize("arch,optimizer", [("mamba2-130m", "adamw"),
                                            ("mamba2-130m", "adafactor"),
                                            ("qwen2.5-14b", "adamw")])
def test_train_step_matches_reference(models, arch, optimizer):
    jmodel, jparams, jstep, model, params = models(arch, optimizer)
    jstate = jmake_optimizer(jmodel.cfg).init(jparams)
    state = make_optimizer(model.cfg).init(params)
    assert type(state).__name__ == type(jstate).__name__
    b = _batch(model.cfg.vocab_size, 2)
    jnew, jnew_state, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray,
                                                                b))
    new, new_state, m = make_train_step(model, make_host_mesh(device="cpu"),
                                        ShapeConfig("t", S, B, "train")).fn(
        params, state, _tbatch(b))
    assert m["loss"].dtype == m["grad_norm"].dtype == torch.float32
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) \
        <= LOSS_TOL
    assert int(new_state.step) == int(jnew_state.step) == 1
    _, grads = compute_grads(model, params, _tbatch(b))
    for p0, p1, g, w0, w1 in zip(tree_leaves(params), tree_leaves(new),
                                 tree_leaves(grads), jax.tree.leaves(jparams),
                                 jax.tree.leaves(jnew)):
        want = np.asarray(w1) - np.asarray(w0)
        got = (p1 - p0).numpy()
        g = g.abs().numpy()
        above = g >= GRAD_REL * g.max()
        assert rel_l2(got[above], want[above]) <= CHANGE_REL, (
            p0.shape, rel_l2(got[above], want[above]))
        assert (np.abs(got - want)[~above]
                <= 2 * np.abs(want).max()).all()
    # the new optimizer state: the moments are made of the gradients (and
    # their squares), so they agree to the gradients' tolerance (doubled)
    carried = opt_state_from_jax(jax.tree.map(np.asarray, jnew_state), "cpu")
    assert type(carried) is type(new_state)
    for g, w in zip(tree_leaves(new_state)[1:], tree_leaves(carried)[1:]):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert rel_l2(g, w.numpy()) <= 2 * GRAD_REL


def test_microbatches_match_one_batch():
    """num_microbatches=2 equals one big batch (same data, f32), at the
    reference's bound."""
    a = train("qwen2.5-14b", steps=3, batch=4, seq=32, num_microbatches=1,
              log_every=100, lr=1e-3, device="cpu")
    b = train("qwen2.5-14b", steps=3, batch=4, seq=32, num_microbatches=2,
              log_every=100, lr=1e-3, device="cpu")
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=5e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat(models, arch):
    _, _, _, model, params = models(arch)
    remat = build_model(dataclasses.replace(model.cfg, remat=True))
    b = _tbatch(_batch(model.cfg.vocab_size, 3))
    l0, g0 = compute_grads(model, params, b)
    l1, g1 = compute_grads(remat, params, b)
    assert abs(float(l1) - float(l0)) <= 1e-6
    for a, c in zip(tree_leaves(g1), tree_leaves(g0)):
        assert rel_l2(a, c.numpy()) <= 1e-6


def test_use_pallas_training_raises(models):
    _, _, _, model, _ = models("mamba2-130m")
    pallas = build_model(dataclasses.replace(model.cfg, use_pallas=True))
    with pytest.raises(NotImplementedError, match="no backward"):
        make_train_step(pallas, make_host_mesh(device="cpu"),
                        ShapeConfig("t", S, B, "train"))


def test_train_reduces_loss_and_restarts_exactly(tmp_path):
    """The reference's driver cases on the CPU: the loss drops over 12
    steps; 8 steps straight equal 4 + checkpoint + resume to 8, bit for
    bit (the CPU is deterministic)."""
    out = train("mamba2-130m", steps=12, batch=4, seq=32, log_every=100,
                device="cpu")
    assert np.isfinite(out["losses"]).all() and out["loss_drop"] > 0.1
    assert out["device"] == "cpu" and len(out["step_ms"]) == 12

    kw = dict(steps=8, batch=2, seq=32, log_every=100, lr=1e-2,
              device="cpu")
    straight = train("mamba2-130m", **kw)
    d = str(tmp_path / "ck")
    train("mamba2-130m", ckpt_dir=d, ckpt_every=4, total_steps=8,
          **{**kw, "steps": 4})
    resumed = train("mamba2-130m", ckpt_dir=d, ckpt_every=100, resume=True,
                    **kw)
    assert resumed["losses"] == straight["losses"][4:]
    for a, b in zip(tree_leaves(straight["params"]),
                    tree_leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_train_model_parallel_clamps_to_one_device():
    """model_parallel=2 on one device: ``make_host_mesh`` clamps the model
    axis to the one device, as the reference's does, and training on the
    (1, 1) mesh gives model_parallel=1's losses exactly."""
    assert make_host_mesh(2, device="cpu").shape == (1, 1)
    kw = dict(steps=3, batch=2, seq=32, log_every=100, device="cpu")
    one = train("mamba2-130m", model_parallel=1, **kw)
    two = train("mamba2-130m", model_parallel=2, **kw)
    assert two["losses"] == one["losses"]


def test_host_mesh_counts_processes_not_cards(monkeypatch):
    """One process on a host of four cards runs on one of them: its mesh
    is (1, 1) whatever ``model_parallel`` asks; a process group of four
    gives the four-device mesh, the model axis clamped to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for mp in (1, 2, 8):
        assert make_host_mesh(mp, device="cuda").shape == (1, 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    assert make_host_mesh(1, device="cuda").shape == (4, 1)
    assert make_host_mesh(2, device="cuda").shape == (2, 2)
    assert make_host_mesh(8, device="cuda").shape == (1, 4)


def test_train_model_parallel_raises(monkeypatch):
    """A mesh of more than one process is refused: sharded training is
    not ported, and the step would otherwise run whole on every rank."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="2 processes"):
        train("mamba2-130m", steps=1, batch=2, seq=32, model_parallel=2,
              device="cpu")
