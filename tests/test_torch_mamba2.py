"""The port's mamba2 model stack against the JAX package's on reduced
mamba2-130m (f32): JAX-initialised parameters carried across through
numpy, the same tokens, logits and caches within 2e-4 (the tolerance of
tests/test_kernels.py::test_model_pallas_path_matches_xla)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels.mamba2_scan import SSD
from repro_torch.models.transformer import TransformerLM, build_model
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_config("mamba2-130m").reduced(),
                               dtype=jnp.float32)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, cfg, params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("S", [16, 40])       # L = 16 (one chunk), L = 20
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_train_matches_reference(models, S, use_pallas):
    jmodel, jparams, cfg, params = models
    toks = _tokens(cfg, 2, S, S)
    want, _ = jmodel.forward_train(jparams, jnp.asarray(toks))
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    got, aux = model.forward_train(params, torch.from_numpy(toks).long())
    assert tuple(got.shape) == (2, S, cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(models, use_pallas):
    jmodel, jparams, cfg, params = models
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    toks = _tokens(cfg, 2, 40, 5)
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(toks))
    before = SSD.launches["ssd_plain"]
    log, cache = model.prefill(params, torch.from_numpy(toks).long())
    # on the CPU the wrapper runs the plain version and counts no launch
    assert SSD.launches["ssd_plain"] == before
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    assert sorted(cache) == sorted(jcache) == ["conv_state", "ssm_state"]
    for k in cache:
        assert cache[k].dtype == torch.float32
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)
    nxt = _tokens(cfg, 2, 3, 6)
    idx = 40
    for t in range(3):
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt[:, t:t + 1]),
                                          jcache, jnp.int32(idx))
        log, cache = model.decode_step(
            params, torch.from_numpy(nxt[:, t:t + 1]).long(), cache, idx)
        idx += 1
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)


def test_specs_match_reference(models):
    """The same tree of shapes as the reference's specs, so a JAX tree
    carries across leaf for leaf; the port's own init fills every leaf."""
    jmodel, jparams, cfg, _ = models
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


def _spec_shapes(tree, prefix=()):
    """{path: shape} of a port spec tree."""
    if hasattr(tree, "shape"):
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_spec_shapes(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("arch", ["arctic-480b", "jamba-1.5-large-398b",
                                  "qwen3-moe-30b-a3b", "whisper-base"])
def test_other_families_build(arch):
    """The moe, hybrid and audio families build: the port's spec tree is
    the reference's, leaf for leaf, at full size (shapes only) and
    reduced, where the port's own init fills every leaf (the parity of
    the computations: tests/test_torch_families.py)."""
    for reduce in (False, True):
        jcfg, cfg = jget_config(arch), get_config(arch)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        want = {tuple(k.key for k in path): leaf.shape for path, leaf in
                jax.tree_util.tree_flatten_with_path(
                    jbuild_model(jcfg).param_shapes())[0]}
        model = TransformerLM(cfg)
        assert _spec_shapes(model.specs()) == want
    params = model.init(0, device="cpu")
    assert _spec_shapes(params) == want
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))


def test_params_from_jax_keeps_bf16_and_casts(models):
    """bf16 leaves stay bf16 (through f32, exactly); ``dtype`` casts the
    whole mamba2 tree."""
    jmodel, jparams, cfg, _ = models
    jb = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    tb = params_from_jax(jb, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jb)[0]
    for path, leaf in flat:
        node = tb
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(node.float().numpy(),
                                      leaf.astype(np.float32))
    t32 = params_from_jax(jb, "cpu", torch.float32)
    assert t32["layers"]["p0"]["ssm"]["wz"].dtype == torch.float32
