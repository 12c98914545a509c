"""The port's layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same numpy inputs from a seed:
RoPE and M-RoPE, full, chunked and decode GQA attention, the cache write,
the attention block and the SwiGLU MLP. f32 throughout: 1e-5, and 2e-4
where a kernel's plain version is in the path (``use_pallas``; the
tolerance of tests/test_kernels.py::test_model_pallas_path_matches_xla)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as J
from repro_torch.configs import get_config
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _arr(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(size=shape)
            * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _cfgs(arch="qwen2.5-14b", **kw):
    jc = dataclasses.replace(jget_config(arch).reduced(), dtype=jnp.float32,
                             **kw)
    tc = dataclasses.replace(get_config(arch).reduced(), dtype=torch.float32,
                             **kw)
    return jc, tc


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("pos_shape", [(1, 9), (2, 9)])
def test_rope_matches_reference(theta, pos_shape):
    x = _arr(0, 2, 9, 3, 16)
    pos = (np.random.default_rng(1).integers(0, 500, size=pos_shape)
           .astype(np.int32))
    jx, tx = _both(x)
    jp, tp = _both(pos)
    _close(L.rope_freqs(16, theta), J.rope_freqs(16, theta))
    _close(L.apply_rope(tx, tp, theta), J.apply_rope(jx, jp, theta))


def test_rope_keeps_bf16():
    x = torch.from_numpy(_arr(2, 1, 4, 2, 8)).to(torch.bfloat16)
    out = L.apply_rope(x, torch.arange(4)[None], 1e4)
    assert out.dtype == torch.bfloat16
    # position 0 is the identity
    assert torch.equal(out[:, 0], x[:, 0])


def test_mrope_matches_reference():
    x = _arr(3, 2, 7, 3, 16)
    pos = (np.random.default_rng(4).integers(0, 64, size=(3, 2, 7))
           .astype(np.int32))
    jx, tx = _both(x)
    jp, tp = _both(pos)
    _close(L.apply_mrope(tx, tp, 1e6, (4, 2, 2)),
           J.apply_mrope(jx, jp, 1e6, (4, 2, 2)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(seed, B=2, S=12, T=12, H=4, KVH=2, D=16):
    return (_arr(seed, B, S, H, D), _arr(seed + 1, B, T, KVH, D),
            _arr(seed + 2, B, T, KVH, D))


@pytest.mark.parametrize("causal,q_offset,S,T", [(True, 0, 12, 12),
                                                 (True, 5, 6, 11),
                                                 (False, 0, 12, 7)])
def test_full_attention_matches_reference(causal, q_offset, S, T):
    q, k, v = _qkv(10, S=S, T=T)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    _close(L.full_gqa_attention(tq, tk, tv, causal, q_offset),
           J.full_gqa_attention(jq, jk, jv, causal, q_offset))


@pytest.mark.parametrize("causal,q_offset,S,T,qc,kc", [
    (True, 0, 12, 12, 4, 6),      # 3 query x 2 key chunks
    (True, 0, 12, 12, 512, 1024),  # one chunk each
    (True, 7, 6, 13, 4, 5),       # chunked prefill; 13 is prime: kc = 1
    (False, 0, 10, 9, 5, 3),
])
def test_chunked_attention_matches_reference(causal, q_offset, S, T, qc, kc):
    q, k, v = _qkv(20, S=S, T=T)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    got = L.chunked_gqa_attention(tq, tk, tv, causal, q_offset, qc, kc)
    _close(got, J.chunked_gqa_attention(jq, jk, jv, causal, q_offset, qc,
                                        kc))
    # and the same math as the materialized scores
    _close(got, L.full_gqa_attention(tq, tk, tv, causal, q_offset))


def test_chunked_attention_fully_masked_rows_are_zero():
    """q_offset < 0 leaves the first rows no key to attend: the guards give
    0, not NaN, as the reference's do."""
    q, k, v = _qkv(25, S=6, T=6)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    got = L.chunked_gqa_attention(tq, tk, tv, True, -3, 2, 3)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, :3], torch.zeros_like(got[:, :3]))
    _close(got, J.chunked_gqa_attention(jq, jk, jv, True, -3, 2, 3))


@pytest.mark.parametrize("index", [5, [0, 9]])
def test_decode_attention_matches_reference(index):
    q, k, v = _qkv(30, S=1, T=10)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    ji, ti = _both(np.asarray(index, np.int32))
    _close(L.decode_gqa_attention(tq, tk, tv, ti),
           J.decode_gqa_attention(jq, jk, jv, ji))


@pytest.mark.parametrize("index", [3, 20, [0, 7]])
def test_write_cache_matches_reference(index):
    """A scalar index writes one slice (clamped to fit, as
    dynamic_update_slice clamps: 20 lands at 9); a (B,) index writes
    position index[b] of each slot only."""
    cache, kv = _arr(40, 2, 10, 2, 4), _arr(41, 2, 1, 2, 4)
    (jc, tc), (jk, tk) = _both(cache), _both(kv)
    ji, ti = _both(np.asarray(index, np.int32))
    got = L._write_cache(tc, tk, ti)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(J._write_cache(jc, jk, ji)))
    np.testing.assert_array_equal(tc.numpy(), cache)   # not written in place


def _attn_params(seed, cfg, bias):
    E, H, D, KVH = cfg.d_model, cfg.num_heads, cfg.head_dim_, cfg.num_kv_heads
    p = {"wq": _arr(seed, E, H, D, scale=E ** -0.5),
         "wk": _arr(seed + 1, E, KVH, D, scale=E ** -0.5),
         "wv": _arr(seed + 2, E, KVH, D, scale=E ** -0.5),
         "wo": _arr(seed + 3, H, D, E, scale=(H * D) ** -0.5)}
    if bias:
        p.update(bq=_arr(seed + 4, H, D), bk=_arr(seed + 5, KVH, D),
                 bv=_arr(seed + 6, KVH, D))
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("mode", ["chunked", "exact_costs", "use_pallas",
                                  "no_bias"])
def test_attention_block_prefill_matches_reference(mode):
    kw = {"exact_costs": mode == "exact_costs",
          "use_pallas": mode == "use_pallas"}
    if mode == "no_bias":
        kw["qkv_bias"] = False
    jc, tc = _cfgs(**kw)
    jp, tp = _attn_params(50, tc, tc.qkv_bias)
    jx, tx = _both(_arr(60, 2, 12, tc.d_model))
    jy, jex = J.attention_block(jp, jx, jc)
    ty, tex = L.attention_block(tp, tx, tc)
    tol = KERNEL_TOL if mode == "use_pallas" else TOL
    _close(ty, jy, tol)
    for got, want in zip(tex["kv"], jex["kv"]):
        _close(got, want)


def test_attention_block_mrope_positions_match_reference():
    jc, tc = _cfgs("qwen2-vl-7b")
    jp, tp = _attn_params(55, tc, True)
    jx, tx = _both(_arr(61, 2, 8, tc.d_model))
    pos = (np.random.default_rng(5).integers(0, 32, size=(3, 2, 8))
           .astype(np.int32))
    jpos, tpos = _both(pos)
    jy, _ = J.attention_block(jp, jx, jc, positions=jpos)
    ty, _ = L.attention_block(tp, tx, tc, positions=tpos)
    _close(ty, jy)


@pytest.mark.parametrize("index", [6, [2, 8]])
def test_attention_block_decode_matches_reference(index):
    """One token against a cache: the rope base is the scalar index or
    each slot's own (``ci[:, None]``), and the cache is written there."""
    jc, tc = _cfgs()
    jp, tp = _attn_params(70, tc, True)
    jx, tx = _both(_arr(80, 2, 1, tc.d_model))
    shape = (2, 12, tc.num_kv_heads, tc.head_dim_)
    (jk, tk), (jv, tv) = _both(_arr(81, *shape)), _both(_arr(82, *shape))
    ji, ti = _both(np.asarray(index, np.int32))
    jy, jex = J.attention_block(jp, jx, jc, cache=(jk, jv), cache_index=ji)
    ty, tex = L.attention_block(tp, tx, tc, cache=(tk, tv), cache_index=ti)
    _close(ty, jy)
    for got, want in zip(tex["cache"], jex["cache"]):
        _close(got, want)


def test_attention_block_cross_attention_matches_reference():
    jc, tc = _cfgs()
    jp, tp = _attn_params(90, tc, True)
    jx, tx = _both(_arr(91, 2, 5, tc.d_model))
    kv_shape = (2, 7, tc.num_kv_heads, tc.head_dim_)
    (jk, tk), (jv, tv) = _both(_arr(92, *kv_shape)), _both(_arr(93, *kv_shape))
    jy, jex = J.attention_block(jp, jx, jc, encoder_kv=(jk, jv))
    ty, tex = L.attention_block(tp, tx, tc, encoder_kv=(tk, tv))
    assert tex == {} and jex == {}
    _close(ty, jy)


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_swiglu_matches_reference(use_pallas):
    jc, tc = _cfgs(use_pallas=use_pallas)
    E, F = tc.d_model, tc.d_ff
    w = {"wi": _arr(100, E, F, scale=E ** -0.5),
         "wg": _arr(101, E, F, scale=E ** -0.5),
         "wo": _arr(102, F, E, scale=F ** -0.5)}
    jx, tx = _both(_arr(103, 2, 12, E))
    want = J.swiglu_mlp({k: jnp.asarray(v) for k, v in w.items()}, jx, jc)
    got = L.swiglu_mlp({k: torch.from_numpy(v) for k, v in w.items()}, tx, tc)
    _close(got, want, KERNEL_TOL if use_pallas else TOL)
