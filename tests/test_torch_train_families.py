"""The port's training stack on the moe, hybrid and audio families against
the JAX package's, on reduced configs (f32 activations), parameters
carried across by ``params_from_jax`` and the same numpy batches, at
tests/test_torch_train.py's tolerances:

  - ``loss_fn`` (cross-entropy plus the MoE auxiliary loss) and its
    gradients on reduced qwen3-moe-30b-a3b and whisper-base (a batch with
    ``encoder_embeds``): the loss and the aux within 1e-5 absolute, each
    gradient leaf within 1e-4 relative L2;
  - one whole AdamW train step against the reference's
    ``make_train_step`` bundle on the same two: the loss within 1e-5, the
    grad norm within 1e-5 relative, the parameter change within 1e-3
    relative L2 per leaf above the gradients' noise floor (as
    test_torch_train.py holds it);
  - whisper's gradients within 2e-3 relative L2 and its grad norm within
    1e-4 relative instead: its random-init attention is near one-hot (the
    init's fan-in of wq is its heads axis), which magnifies f32 rounding.
    On the loss test's batch the reference's own f32 gradients lie up to
    1.6e-3 (encoder ln1), the port's 1.2e-3, from a float64 evaluation of
    the same function, so no f32 evaluation can meet 1e-4 there
    (``test_whisper_gradient_rounding_against_float64``);
  - every routing call of the port in these comparisons clear of a
    near-tie (``tests/_torch_routing.py``);
  - port-only: remat on against off with a nonzero aux (1e-6; the aux is
    summed through the checkpointed periods), and the training driver on
    reduced qwen3-moe and jamba.
"""
import contextlib
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
from repro_torch.weights import params_from_jax
from tests._torch_routing import clear_routing

LOSS_TOL, GRAD_REL, CHANGE_REL = 1e-5, 1e-4, 1e-3
B, S = 4, 16
ARCHS = ("qwen3-moe-30b-a3b", "whisper-base")
# (gradient relative L2, grad-norm relative) by arch
GRAD_TOL = {"qwen3-moe-30b-a3b": (GRAD_REL, LOSS_TOL),
            "whisper-base": (2e-3, 1e-4)}


def _routing(cfg):
    """``clear_routing()`` for a model with MoE layers, else nothing."""
    return clear_routing() if cfg.moe else contextlib.nullcontext()


def rel_l2(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.encoder_layers:
        b["encoder_embeds"] = r.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model), dtype=np.float32)
    return b


def _tbatch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    """``models(arch)``: the reference's f32 model, parameters and jitted
    AdamW train step, and the port's model and parameters."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                       dtype=jnp.float32)
            jmodel = jbuild_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            jstep = jax.jit(jmake_train_step(
                jmodel, jmake_host_mesh(),
                JShapeConfig("t", S, B, "train")).fn)
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype=torch.float32)
            params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
            built[arch] = (jmodel, jparams, jstep, build_model(cfg), params)
        return built[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(models, arch):
    jmodel, jparams, _, model, params = models(arch)
    b = _batch(model.cfg, 1)
    jb = jax.tree.map(jnp.asarray, b)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jmodel, p, jb), has_aux=True))(jparams)
    with _routing(model.cfg):
        loss, parts = loss_fn(model, params, _tbatch(b))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert abs(float(parts["aux"]) - float(jparts["aux"])) <= LOSS_TOL
    assert (float(parts["aux"]) > 0) == (model.cfg.moe is not None)
    gloss, grads = compute_grads(model, params, _tbatch(b))
    assert float(gloss) == float(loss)
    g_leaves, w_leaves = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert rel_l2(g, w) <= GRAD_TOL[arch][0], (g.shape, rel_l2(g, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(models, arch):
    jmodel, jparams, jstep, model, params = models(arch)
    jstate = jmake_optimizer(jmodel.cfg).init(jparams)
    state = make_optimizer(model.cfg).init(params)
    b = _batch(model.cfg, 2)
    jnew, jnew_state, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray,
                                                                b))
    with _routing(model.cfg):
        new, new_state, m = make_train_step(
            model, make_host_mesh(device="cpu"),
            ShapeConfig("t", S, B, "train")).fn(params, state, _tbatch(b))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) \
        <= GRAD_TOL[arch][1]
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


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b"])
def test_remat_sums_aux_through_checkpoint(arch):
    """Remat against no remat on the port's own init: the loss, the aux
    (nonzero: every MoE layer adds its share) and every gradient."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=torch.float32)
    plain = build_model(cfg)
    remat = build_model(dataclasses.replace(cfg, remat=True))
    params = plain.init(0, device="cpu")
    b = _tbatch(_batch(cfg, 3))
    l0, p0 = loss_fn(plain, params, b)
    l1, p1 = loss_fn(remat, params, b)
    assert float(p0["aux"]) > 0
    assert abs(float(p1["aux"]) - float(p0["aux"])) <= 1e-6
    assert abs(float(l1) - float(l0)) <= 1e-6
    _, g0 = compute_grads(plain, params, b)
    _, g1 = compute_grads(remat, params, b)
    for a, c in zip(tree_leaves(g1), tree_leaves(g0)):
        assert rel_l2(a, c.numpy()) <= 1e-6
    # the routers' gradients come through the aux loss and the gates
    routers = [g1["layers"][p]["ffn"]["router"] for p in g1["layers"]
               if "router" in g1["layers"][p]["ffn"]]
    assert routers and all(float(r.abs().max()) > 0 for r in routers)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b"])
def test_train_driver_runs_moe_and_hybrid(arch):
    out = train(arch, steps=3, batch=2, seq=16, log_every=100, device="cpu")
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3


def test_whisper_gradient_rounding_against_float64(models):
    """Whisper's gradient tolerance is f32 rounding: against the port's
    float64 gradients of the same loss, both packages' f32 gradients lie
    within 2e-3 relative L2 on every leaf, and the reference's worst leaf
    farther than 1e-4."""
    from repro_torch.tree import tree_map
    jmodel, jparams, _, model, params = models("whisper-base")
    b = _batch(model.cfg, 1)
    jb = jax.tree.map(jnp.asarray, b)
    jgrads = jax.grad(lambda p: jloss_fn(jmodel, p, jb)[0])(jparams)
    _, grads = compute_grads(model, params, _tbatch(b))
    m64 = build_model(dataclasses.replace(model.cfg, dtype=torch.float64))
    tb = _tbatch(b)
    tb["encoder_embeds"] = tb["encoder_embeds"].double()
    _, g64 = compute_grads(m64, tree_map(lambda a: a.double(), params), tb)
    exact = [g.numpy() for g in tree_leaves(g64)]

    def worst(leaves):
        return max(float(np.linalg.norm(np.asarray(a, np.float64) - x)
                         / np.linalg.norm(x))
                   for a, x in zip(leaves, exact))

    ref = worst(jax.tree.leaves(jgrads))
    port = worst([g.double().numpy() for g in tree_leaves(grads)])
    print(f"worst leaf, relative L2 from float64: reference {ref:.2e}, "
          f"port {port:.2e}")
    assert GRAD_REL < ref <= GRAD_TOL["whisper-base"][0]
    assert port <= GRAD_TOL["whisper-base"][0]
