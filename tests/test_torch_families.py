"""The port's moe, hybrid and audio families against the JAX package's on
reduced configs (f32): JAX-initialised parameters carried across through
numpy, the same tokens (and frame embeddings for whisper), and

  - ``forward_train``: the logits and the MoE auxiliary loss;
  - ``prefill``: the last-token logits and every cache leaf (k/v for the
    attention layers, conv/ssm state for jamba's mamba2 layers, cross_k
    and cross_v for whisper's decoder);
  - three ``decode_step``s at per-slot (B,) lengths: logits and caches;

for reduced qwen3-moe-30b-a3b and whisper-base on the torch-ops path and
on use_pallas (the kernels' plain versions on the CPU), arctic-480b and
jamba-1.5-large-398b on the torch-ops path. Every routing call of the
port is clear of a near-tie (``tests/_torch_routing.py``).

Tolerance: test_torch_dense.py's 2e-4 (rtol and atol). Whisper's logits
and decoder caches are held at rtol 2e-4 with atol 2e-3 elementwise and
at 2e-4 in relative L2 norm: its random-init attention is near one-hot
(the init's fan-in of wq is its heads axis), which magnifies f32
rounding. On the inputs of the forward and prefill tests (seeds 1 and 5)
the reference's own f32 logits lie up to 9.6e-4 and 1.4e-3 from a float64
evaluation of the same function (the port's f32 logits 4.4e-4 and 3.6e-4;
``test_whisper_f32_rounding_against_float64``), so no elementwise bound
near 2e-4 can hold the reference.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.transformer import build_model as jbuild_model
from repro.models.transformer import pad_cache as jpad_cache
from repro_torch.configs import get_config
from repro_torch.models.transformer import build_model, pad_cache
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_jax
from tests._torch_routing import clear_routing

TOL = dict(rtol=2e-4, atol=2e-4)
WHISPER_TOL = dict(rtol=2e-4, atol=2e-3)
REL_L2 = 2e-4
B, S = 2, 11


@pytest.fixture(scope="module")
def models():
    """``models(arch)``: (JAX model, JAX params, port cfg, port params) for
    reduced ``arch`` in f32, built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                       dtype=jnp.float32)
            jmodel = jbuild_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype=torch.float32)
            params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
            built[arch] = (jmodel, jparams, cfg, params)
        return built[arch]

    return get


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    emb = (rng.standard_normal((B, cfg.num_audio_frames, cfg.d_model),
                               dtype=np.float32)
           if cfg.encoder_layers else None)
    return toks, emb


def _kw(emb, torch_side):
    if emb is None:
        return {}
    return {"encoder_embeds": torch.from_numpy(emb) if torch_side
            else jnp.asarray(emb)}


def _routing(cfg):
    """``clear_routing()`` for a model with MoE layers, else nothing."""
    return clear_routing() if cfg.moe else contextlib.nullcontext()


def _close(got, want, tol=TOL):
    g, w = got.detach().numpy(), np.asarray(want)
    np.testing.assert_allclose(g, w, **tol)
    if tol is WHISPER_TOL:
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= REL_L2, err


CASES = [("qwen3-moe-30b-a3b", False), ("qwen3-moe-30b-a3b", True),
         ("arctic-480b", False), ("jamba-1.5-large-398b", False),
         ("whisper-base", False), ("whisper-base", True)]


@pytest.mark.parametrize("arch,use_pallas", CASES)
def test_forward_train_matches_reference(models, arch, use_pallas):
    jmodel, jparams, cfg, params = models(arch)
    toks, emb = _inputs(cfg, 1)
    want, jaux = jmodel.forward_train(jparams, jnp.asarray(toks),
                                      **_kw(emb, False))
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    with _routing(cfg):
        got, aux = model.forward_train(params,
                                       torch.from_numpy(toks).long(),
                                       **_kw(emb, True))
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)
    _close(got, want, WHISPER_TOL if cfg.encoder_layers else TOL)


@pytest.mark.parametrize("arch,use_pallas", CASES)
def test_prefill_and_decode_match_reference(models, arch, use_pallas):
    """Prefill two prompts of 11 tokens, then three decode steps with slot
    1 holding a shorter prompt (per-slot lengths), each against the
    reference: logits and every cache leaf."""
    jmodel, jparams, cfg, params = models(arch)
    tol = WHISPER_TOL if cfg.encoder_layers else TOL
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    toks, emb = _inputs(cfg, 5)
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(toks),
                                  **_kw(emb, False))
    with _routing(cfg):
        log, cache = model.prefill(params, torch.from_numpy(toks).long(),
                                   **_kw(emb, True))
    _close(log, jlog, tol)
    assert sorted(cache) == sorted(jcache)
    want_keys = {"k", "v"}
    if cfg.family == "hybrid":
        want_keys |= {"conv_state", "ssm_state"}
    if cfg.encoder_layers:
        want_keys |= {"cross_k", "cross_v"}
    assert set(cache) == want_keys
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        assert cache[k].dtype == torch.float32
        _close(cache[k], jcache[k], tol)

    cap = 16
    jcache, cache = jpad_cache(jcache, cap), pad_cache(cache, cap)
    lengths = np.array([S, S - 4], np.int32)
    nxt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, 3)).astype(np.int32)
    for t in range(3):
        jlog, jcache = jmodel.decode_step(
            jparams, jnp.asarray(nxt[:, t:t + 1]), jcache,
            jnp.asarray(lengths + t))
        with _routing(cfg):
            log, cache = model.decode_step(
                params, torch.from_numpy(nxt[:, t:t + 1]).long(), cache,
                torch.from_numpy(lengths + t))
        _close(log, jlog, tol)
        assert sorted(cache) == sorted(jcache)
        for k in cache:
            _close(cache[k], jcache[k], tol)


@pytest.mark.parametrize("arch", [a for a, pal in CASES if not pal])
def test_params_from_jax_keeps_leaf_order(models, arch):
    """The MoE, hybrid and encoder trees carried across: the port's leaves
    in ``jax.tree.flatten``'s order, each equal to the reference's."""
    _, jparams, _, params = models(arch)
    want = jax.tree.leaves(jparams)
    got = tree_leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [1, 5])
def test_whisper_f32_rounding_against_float64(models, seed):
    """Whisper's tolerance is f32 rounding: the port's float64 evaluation
    of the same function (its semantics held by the tests above) lies
    within WHISPER_TOL of both packages' f32 logits, and farther than 2e-4
    from the reference's, so the dense tolerance cannot hold there."""
    from repro_torch.tree import tree_map
    jmodel, jparams, cfg, params = models("whisper-base")
    toks, emb = _inputs(cfg, seed)
    want, _ = jmodel.forward_train(jparams, jnp.asarray(toks),
                                   **_kw(emb, False))
    got, _ = build_model(cfg).forward_train(
        params, torch.from_numpy(toks).long(), **_kw(emb, True))
    m64 = build_model(dataclasses.replace(cfg, dtype=torch.float64))
    exact, _ = m64.forward_train(
        tree_map(lambda a: a.double(), params),
        torch.from_numpy(toks).long(),
        encoder_embeds=torch.from_numpy(emb).double())
    exact = exact.numpy()
    ref_err = float(np.abs(np.asarray(want, np.float64) - exact).max())
    port_err = float(np.abs(got.detach().double().numpy() - exact).max())
    print(f"seed {seed}: max |f32 - float64| reference {ref_err:.2e}, "
          f"port {port_err:.2e}")
    assert ref_err > TOL["atol"]
    for f32 in (np.asarray(want), got.detach().numpy()):
        np.testing.assert_allclose(f32, exact, **WHISPER_TOL)
