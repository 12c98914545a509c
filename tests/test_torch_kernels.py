"""The port's kernels (plain PyTorch versions on the CPU) and its ops
wrappers against ``repro.kernels.ops`` (Pallas interpret mode) and
``repro.kernels.ref``, with the tolerances of tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.descriptor import build_plain as jbuild_plain
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import \
    flash_attention_desc as jflash_desc
from repro_torch.core.descriptor import build_plain
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_desc

RNG = np.random.default_rng(42)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, dt):
    """The same numpy draw as a JAX array and a tensor of one dtype (both
    round f32 to bf16 to nearest even)."""
    x = RNG.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("M,K,N", [(32, 32, 32), (96, 160, 64),
                                   (128, 64, 48), (17 * 8, 24, 40)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_matmul_matches_reference(M, K, N, dt):
    ja, ta = _pair((M, K), dt)
    jb, tb = _pair((K, N), dt)
    out = ops.matmul(ta, tb, bm=32, bk=32, bn=16)
    assert out.dtype == ta.dtype and tuple(out.shape) == (M, N)
    tol = dict(rtol=2e-2, atol=2e-1) if dt == "bf16" \
        else dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(out), _np(jref.matmul_ref(ja, jb)), **tol)
    np.testing.assert_allclose(_np(out), _np(jops.matmul(ja, jb, bm=32, bk=32,
                                                         bn=16)), **tol)


def test_matmul_batched_lead():
    ja, ta = _pair((2, 8, 48), "f32")
    jb, tb = _pair((48, 32), "f32")
    out = ops.matmul(ta, tb, bm=16, bk=16, bn=16)
    np.testing.assert_allclose(_np(out), _np(jnp.einsum("bmk,kn->bmn", ja, jb)),
                               rtol=1e-4, atol=1e-4)


def test_matmul_kernel_output_is_f32():
    _, ta = _pair((32, 16), "bf16")
    _, tb = _pair((16, 32), "bf16")
    from repro_torch.kernels.matmul import matmul_desc
    (c,) = build_plain(matmul_desc(32, 16, 32, torch.bfloat16, bm=8, bk=8,
                                   bn=8))(ta, tb)
    assert c.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), ref.matmul_ref(ta, tb).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,T,H,KVH,D", [(64, 64, 4, 4, 16),
                                         (64, 64, 8, 2, 32),
                                         (48, 48, 6, 3, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matches_reference(S, T, H, KVH, D, causal, dt):
    B = 2
    jq, tq = _pair((B, S, H, D), dt)
    jk, tk = _pair((B, T, KVH, D), dt)
    jv, tv = _pair((B, T, KVH, D), dt)
    out = ops.flash_attention(tq, tk, tv, causal=causal, bq=16, bk=16)
    assert out.dtype == tq.dtype and tuple(out.shape) == (B, S, H, D)
    G = H // KVH
    qf = jq.transpose(0, 2, 1, 3).reshape(B * H, S, D)
    kf = jk.transpose(0, 2, 1, 3).reshape(B * KVH, T, D)
    vf = jv.transpose(0, 2, 1, 3).reshape(B * KVH, T, D)
    want = jref.attention_ref(qf, kf, vf, causal=causal, group=G
                              ).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dt))
    if dt == "f32":     # the Pallas kernel itself, on one sweep point each
        jout = jops.flash_attention(jq, jk, jv, causal=causal, bq=16, bk=16)
        np.testing.assert_allclose(_np(out), _np(jout), **_tol(dt))


@pytest.mark.parametrize("q_offset", [0, 8, 24])
def test_flash_causal_q_offset(q_offset):
    """Absolute query positions from q_offset; with bk=8 whole KV blocks are
    masked for the early rows of each q block."""
    BH, S, T, D, G = 4, 16, 40, 8, 2
    jq, tq = _pair((BH, S, D), "f32")
    jk, tk = _pair((BH // G, T, D), "f32")
    jv, tv = _pair((BH // G, T, D), "f32")
    geo = dict(causal=True, q_offset=q_offset, bq=8, bk=8)
    (out,) = build_plain(flash_attention_desc(BH, S, T, D, G, **geo))(
        tq, tk, tv)
    (jout,) = jbuild_plain(jflash_desc(BH, S, T, D, G, **geo))(jq, jk, jv)
    want = ref.attention_ref(tq, tk, tv, causal=True, group=G,
                             q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=2e-5, atol=2e-5)


def test_flash_fully_masked_rows_give_zero():
    """Rows with no visible key (positions below 0) give 0, never NaN from
    exp(-inf - -inf): the isfinite guards and the 1e-30 clamp on l."""
    BH, S, T, D, G = 2, 16, 16, 8, 1
    jq, tq = _pair((BH, S, D), "f32")
    jk, tk = _pair((BH, T, D), "f32")
    jv, tv = _pair((BH, T, D), "f32")
    geo = dict(causal=True, q_offset=-4, bq=8, bk=8)
    (out,) = build_plain(flash_attention_desc(BH, S, T, D, G, **geo))(
        tq, tk, tv)
    (jout,) = jbuild_plain(jflash_desc(BH, S, T, D, G, **geo))(jq, jk, jv)
    assert torch.isfinite(out).all()
    assert torch.all(out[:, :4] == 0)
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=2e-5, atol=2e-5)
