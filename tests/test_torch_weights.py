"""Weights and configs carried across from the JAX package: the reduced
qwen2.5-14b parameter tree initialised by JAX, moved through numpy into
tensors, and one decoder layer's prefill launches (flash attention and the
SwiGLU MLP's three matmuls) through the port's server, against
``repro.kernels.ops`` on the same weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models.transformer import build_model
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.virtualization import TallyServer
from repro_torch.kernels.flash_attention import flash_attention_desc
from repro_torch.kernels.matmul import matmul_desc
from repro_torch.weights import mlp_weights, params_from_jax

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.fixture(scope="module")
def jax_model():
    cfg = dataclasses.replace(jget_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    jc = jget_config("qwen2.5-14b")
    tc = get_config("qwen2.5-14b")
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for f in dataclasses.fields(ModelConfig):
        want = getattr(jc, f.name)
        if f.name in ("dtype", "param_dtype"):
            want = DTYPES[want]
        assert getattr(tc, f.name) == want, f.name
    assert (tc.head_dim_, tc.q_per_kv) == (jc.head_dim_, jc.q_per_kv)


def test_params_from_jax_keeps_tree_and_layout(jax_model):
    cfg, tree = jax_model
    params = params_from_jax(tree, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) > 0
    for path, leaf in flat_j:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    wg = params["layers"]["p0"]["ffn"]["wg"]
    assert tuple(wg.shape) == (cfg.num_layers, cfg.d_model, cfg.d_ff)
    assert params_from_jax(tree, "cpu", torch.bfloat16)["embed"].dtype \
        == torch.bfloat16
    for layer in range(cfg.num_layers):
        g, i, o = mlp_weights(params, layer)
        np.testing.assert_array_equal(
            o.numpy(), tree["layers"]["p0"]["ffn"]["wo"][layer])
        assert tuple(g.shape) == tuple(i.shape) == (cfg.d_model, cfg.d_ff)


def test_layer_request_through_server_matches_reference(jax_model):
    cfg, tree = jax_model
    params = params_from_jax(tree, "cpu")
    layer = 1
    wg, wi, wo = mlp_weights(params, layer)
    B, S = 1, 16
    H, KVH, D, E = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.d_model
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    x = rng.normal(size=(B, S, E)).astype(np.float32)

    # reference: the use_pallas path's kernels (layers.py) on the same weights
    ffn = jax.tree.map(lambda a: jnp.asarray(a[layer]),
                       tree["layers"]["p0"]["ffn"])
    j_attn = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True)
    jh = jax.nn.silu(jops.matmul(jnp.asarray(x), ffn["wg"])) \
        * jops.matmul(jnp.asarray(x), ffn["wi"])
    j_mlp = jops.matmul(jh, ffn["wo"])

    # the port: the same launches as an HP client of the Tally server
    srv = TallyServer(device="cpu")
    hp = srv.register("inference", priority=0)
    tq = torch.from_numpy(q).transpose(1, 2).reshape(B * H, S, D).contiguous()
    tk = torch.from_numpy(k).transpose(1, 2).reshape(B * KVH, S, D).contiguous()
    tv = torch.from_numpy(v).transpose(1, 2).reshape(B * KVH, S, D).contiguous()
    fl = hp.launch(flash_attention_desc(B * H, S, S, D, H // KVH), tq, tk, tv)
    x2 = torch.from_numpy(x).reshape(B * S, E)
    up = matmul_desc(B * S, E, cfg.d_ff)
    jg, ji = hp.launch(up, x2, wg), hp.launch(up, x2, wi)
    srv.serve_until_idle(max_seconds=60)
    h = torch.nn.functional.silu(jg.result(0)[0]) * ji.result(0)[0]
    jo = hp.launch(matmul_desc(B * S, cfg.d_ff, E), h, wo)
    srv.serve_until_idle(max_seconds=60)
    attn = fl.result(0)[0].reshape(B, H, S, D).transpose(1, 2)
    mlp = jo.result(0)[0].reshape(B, S, E)
    np.testing.assert_allclose(attn.numpy(), np.asarray(j_attn), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(mlp.numpy(), np.asarray(j_mlp), rtol=2e-4,
                               atol=2e-4)
