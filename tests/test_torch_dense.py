"""The port's dense and vlm model stack against the JAX package's on reduced
configs (f32): JAX-initialised parameters carried across through numpy,
the same tokens, and logits and k/v caches within 2e-4 (the tolerance of
tests/test_kernels.py::test_model_pallas_path_matches_xla), with
``use_pallas`` off and on (on the CPU the port's kernels run their plain
versions)."""
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
from repro_torch.kernels.flash_attention import FLASH
from repro_torch.kernels.matmul import MATMUL
from repro_torch.models.transformer import (TransformerLM, build_model,
                                            pad_cache)
from repro_torch.weights import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)


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


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _mrope_positions(B, S, seed, start=0):
    """(3, B, S) t/h/w ids: text-like t (start + index), random h and w."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(start + np.arange(S), (B, S))
    return np.stack([t, rng.integers(0, 8, size=(B, S)),
                     rng.integers(0, 8, size=(B, S))]).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_train_matches_reference(models, S, use_pallas):
    jmodel, jparams, cfg, params = models("qwen2.5-14b")
    toks = _tokens(cfg, 2, S, S)
    want, _ = jmodel.forward_train(jparams, jnp.asarray(toks))
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    got, aux = model.forward_train(params, torch.from_numpy(toks).long())
    assert tuple(got.shape) == (2, S, cfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want)


def test_reference_kernel_path_matches(models):
    """The JAX model on its own use_pallas path (Pallas in interpret mode)
    against the port's kernel path, at S = 16."""
    jmodel, jparams, cfg, params = models("qwen2.5-14b")
    jpal = jbuild_model(dataclasses.replace(jmodel.cfg, use_pallas=True))
    toks = _tokens(cfg, 2, 16, 1)
    want, _ = jpal.forward_train(jparams, jnp.asarray(toks))
    model = build_model(dataclasses.replace(cfg, use_pallas=True))
    got, _ = model.forward_train(params, torch.from_numpy(toks).long())
    _close(got, want)


def _prefill_decode(models, arch, use_pallas, index_kind, positions=False):
    """Prefill 2 prompts of 11 tokens, then 3 decode steps at a scalar
    index or at per-slot (B,) lengths, each against the reference."""
    jmodel, jparams, cfg, params = models(arch)
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    B, S, cap = 2, 11, 16
    toks = _tokens(cfg, B, S, 5)
    pos = _mrope_positions(B, S, 6) if positions else None
    jlog, jcache = jmodel.prefill(
        jparams, jnp.asarray(toks),
        positions=None if pos is None else jnp.asarray(pos))
    before = (dict(MATMUL.launches), dict(FLASH.launches))
    log, cache = model.prefill(
        params, torch.from_numpy(toks).long(),
        positions=None if pos is None else torch.from_numpy(pos))
    # on the CPU the wrappers run the plain versions and count no launch
    assert (MATMUL.launches, FLASH.launches) == before
    _close(log, jlog)
    assert sorted(cache) == sorted(jcache) == ["k", "v"]
    n_attn = cfg.num_layers
    for k in cache:
        assert tuple(cache[k].shape) == (n_attn, B, S, cfg.num_kv_heads,
                                         cfg.head_dim_)
        _close(cache[k], jcache[k])
    # decode against the caches padded to capacity
    jcache, cache = jpad_cache(jcache, cap), pad_cache(cache, cap)
    lengths = np.array([S, S - 4], np.int32)   # slot 1 holds a shorter prompt
    nxt = _tokens(cfg, B, 3, 7)
    for t in range(3):
        if index_kind == "scalar":
            ji, ti = jnp.int32(S + t), S + t
        else:
            ji = jnp.asarray(lengths + t)
            ti = torch.from_numpy(lengths + t)
        dpos = (_mrope_positions(B, 1, 8 + t, start=S + t) if positions
                else None)
        jlog, jcache = jmodel.decode_step(
            jparams, jnp.asarray(nxt[:, t:t + 1]), jcache, ji,
            positions=None if dpos is None else jnp.asarray(dpos))
        log, cache = model.decode_step(
            params, torch.from_numpy(nxt[:, t:t + 1]).long(), cache, ti,
            positions=None if dpos is None else torch.from_numpy(dpos))
        _close(log, jlog)
        for k in cache:
            _close(cache[k], jcache[k])


@pytest.mark.parametrize("index_kind", ["scalar", "per_slot"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(models, use_pallas, index_kind):
    _prefill_decode(models, "qwen2.5-14b", use_pallas, index_kind)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mrope_model_matches_reference(models, use_pallas):
    """qwen2-vl-7b with (3, B, S) M-RoPE positions through forward_train,
    prefill and per-slot decode."""
    jmodel, jparams, cfg, params = models("qwen2-vl-7b")
    toks = _tokens(cfg, 2, 12, 9)
    pos = _mrope_positions(2, 12, 10)
    want, _ = jmodel.forward_train(jparams, jnp.asarray(toks),
                                   positions=jnp.asarray(pos))
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    got, _ = model.forward_train(params, torch.from_numpy(toks).long(),
                                 positions=torch.from_numpy(pos))
    _close(got, want)
    _prefill_decode(models, "qwen2-vl-7b", use_pallas, "per_slot",
                    positions=True)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mistral-nemo-12b",
                                  "deepseek-coder-33b"])
def test_other_dense_configs_match_reference(models, arch):
    """The other dense configs, reduced, at one shape on the kernel path:
    qkv bias with rope theta 1e6 (codeqwen), no bias (mistral-nemo) and
    no bias with theta 1e5 (deepseek-coder)."""
    jmodel, jparams, cfg, params = models(arch)
    toks = _tokens(cfg, 2, 10, 11)
    want, _ = jmodel.forward_train(jparams, jnp.asarray(toks))
    model = build_model(dataclasses.replace(cfg, use_pallas=True))
    got, _ = model.forward_train(params, torch.from_numpy(toks).long())
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen2-vl-7b",
                                  "mistral-nemo-12b"])
def test_specs_match_reference(models, arch):
    """The same tree of shapes as the reference's specs, so a JAX tree
    carries across leaf for leaf; the port's own init fills every leaf."""
    jmodel, jparams, cfg, _ = models(arch)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    mine = TransformerLM(cfg).init(0, device="cpu")
    n = 0
    for path, leaf in flat:
        node = mine
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        n += node.numel()
    assert n == sum(x.size for x in jax.tree.leaves(jparams))
