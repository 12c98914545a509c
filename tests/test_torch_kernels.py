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
from repro.kernels.mamba2_scan import mamba2_scan_desc as jssd_desc
from repro_torch.core.descriptor import build_plain, new_outputs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_desc
from repro_torch.kernels.mamba2_scan import SSD, mamba2_scan_desc

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


# ---------------------------------------------------------------------------
# Mamba2 SSD chunk scan
# ---------------------------------------------------------------------------

SSD_SWEEP = [(2, 48, 3, 8, 5, 16), (1, 64, 2, 16, 8, 32), (3, 30, 4, 4, 4, 10)]


def _ssd_inputs(B, S, NH, HD, DS, dt):
    """x, Bm, Cm in ``dt``; dt, A and D in f32, as the model passes them."""
    jx, tx = _pair((B, S, NH, HD), dt)
    dtv = RNG.uniform(0.1, 0.9, size=(B, S, NH)).astype(np.float32)
    A = -RNG.uniform(0.5, 2.0, size=(NH,)).astype(np.float32)
    jb, tb = _pair((B, S, DS), dt)
    jc, tc = _pair((B, S, DS), dt)
    _, tD = _pair((NH,), "f32")
    D = tD.numpy()
    jargs = (jx, jnp.asarray(dtv), jnp.asarray(A), jb, jc, jnp.asarray(D))
    targs = (tx, torch.from_numpy(dtv), torch.from_numpy(A), tb, tc, tD)
    return jargs, targs


@pytest.mark.parametrize("B,S,NH,HD,DS,chunk", SSD_SWEEP)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba2_scan_matches_reference(B, S, NH, HD, DS, chunk, dt):
    """Against JAX ``ops.mamba2_scan`` (Pallas, interpret mode): f32 within
    1e-4 (the sums' order differs); bf16 y within 2e-2 (both compute in f32
    and round once to bf16: an ulp apart at most), h (f32) within 1e-4.
    Against the per-token ``ssd_ref`` with tests/test_kernels.py's
    tolerances."""
    jargs, targs = _ssd_inputs(B, S, NH, HD, DS, dt)
    y, h = ops.mamba2_scan(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and h.dtype == torch.float32
    assert tuple(h.shape) == (B, NH, HD, DS)
    jy, jh = jops.mamba2_scan(*jargs, chunk=chunk)
    ytol = dict(rtol=1e-4, atol=1e-4) if dt == "f32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(y), _np(jy), **ytol)
    np.testing.assert_allclose(_np(h), _np(jh), rtol=1e-4, atol=1e-4)
    yr, hr = jref.ssd_ref(*jargs)
    rtol = dict(rtol=5e-2, atol=5e-1) if dt == "bf16" \
        else dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(y), _np(yr), **rtol)
    np.testing.assert_allclose(_np(h), _np(hr), **rtol)


def test_ssd_ref_matches_reference():
    jargs, targs = _ssd_inputs(2, 20, 3, 4, 5, "f32")
    y, h = ref.ssd_ref(*targs)
    jy, jh = jref.ssd_ref(*jargs)
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), _np(jh), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(512, 256), (300, 256), (257, 256),
                                     (100, 256), (64, 256), (24, 8),
                                     (13, 8), (30, 10)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssd_descriptor_matches_reference(S, chunk, dt):
    """Grid, chunk length, num_blocks and the cost counts of the
    reference's descriptor (the profiler and the bound read them)."""
    jdt, tdt = DTYPES[dt]
    jd = jssd_desc(264, S, 24, 64, 128, chunk, jdt)
    td = mamba2_scan_desc(264, S, 24, 64, 128, chunk, tdt)
    assert td.grid == jd.grid
    assert td.static["L"] == jd.in_maps[0].block_shape[1]
    assert td.parallel_axes == jd.parallel_axes == (0,)
    assert td.num_blocks == jd.num_blocks == 264
    assert (td.flops, td.bytes_accessed) == (jd.flops, jd.bytes_accessed)
    assert td.revisits_output == jd.revisits_output
    assert [b.block_shape for b in td.in_maps + td.out_maps] == \
        [b.block_shape for b in jd.in_maps + jd.out_maps]
    for pids in ((0, 0), (5, td.grid[1] - 1)):
        assert [b.index_map(*pids) for b in td.in_maps + td.out_maps] == \
            [tuple(int(i) for i in b.index_map(*pids))
             for b in jd.in_maps + jd.out_maps]
    assert [(tuple(s), d) for s, d in td.out_shape] == \
        [(tuple(o.shape), DTYPES["bf16" if o.dtype == jnp.bfloat16
                                  else "f32"][1]) for o in jd.out_shape]


def test_ssd_check_raises_on_what_the_kernel_does_not_take():
    """The wrapper's checks run before any launch; the model's strided
    views are made contiguous by ``ops.mamba2_scan`` and refused here."""
    _, targs = _ssd_inputs(2, 16, 2, 4, 4, "f32")
    desc = mamba2_scan_desc(2, 16, 2, 4, 4, 8)
    outs = new_outputs(desc, torch.device("cpu"))
    SSD.check(desc, targs, outs)
    x, dtv, A, Bm, Cm, D = targs
    wide = torch.cat([x, x], dim=-1)[..., :4]          # a strided view
    with pytest.raises(ValueError, match="contiguous"):
        SSD.check(desc, (wide, dtv, A, Bm, Cm, D), outs)
    with pytest.raises(TypeError, match="f32"):
        SSD.check(desc, (x, dtv.to(torch.bfloat16), A, Bm, Cm, D), outs)
    with pytest.raises(TypeError, match="one type"):
        SSD.check(desc, (x, dtv, A, Bm.to(torch.bfloat16), Cm, D), outs)
    with pytest.raises(ValueError, match="bad shapes"):
        SSD.check(desc, (x, dtv, A[:1], Bm, Cm, D), outs)
    big = mamba2_scan_desc(2, 16, 2, 128, 4, 8)
    xb = torch.zeros(2, 16, 2, 128)
    with pytest.raises(ValueError, match="HD <= 64"):
        SSD.check(big, (xb, dtv, A, Bm, Cm, D), new_outputs(big, "cpu"))
    # the ops wrapper takes the strided views the model gives it
    y, _ = ops.mamba2_scan(wide, dtv, A, Bm, Cm, D, chunk=8)
    np.testing.assert_allclose(
        y.numpy(), ops.mamba2_scan(wide.contiguous(), dtv, A, Bm, Cm, D,
                                   chunk=8)[0].numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Routes: tensor cores for bf16, CUDA cores for f32, picked in one place
# ---------------------------------------------------------------------------

def _inputs(desc, dtype):
    """Uninitialised CPU inputs of ``desc``'s shapes in ``dtype``: a route
    reads only types, shapes, contiguity and alignment."""
    s = desc.static
    if desc.kernel.name == "matmul":
        M, N = desc.out_shape[0][0]
        K = desc.in_maps[0].block_shape[1] * desc.grid[2]
        return torch.empty(M, K, dtype=dtype), torch.empty(K, N, dtype=dtype)
    BH, S, D = desc.out_shape[0][0]
    kv = (BH // s["group"], s["T"], D)
    return (torch.empty(BH, S, D, dtype=dtype), torch.empty(kv, dtype=dtype),
            torch.empty(kv, dtype=dtype))


def _main_path():
    from repro_torch.kernels.matmul import matmul_desc
    bf = torch.bfloat16
    return {"mm_hp_up": matmul_desc(512, 5120, 13824, bf),
            "mm_hp_down": matmul_desc(512, 13824, 5120, bf),
            "mm_be": matmul_desc(4096, 5120, 13824, bf),
            "flash_hp": flash_attention_desc(40, 512, 512, 128, 5, bf),
            "flash_be": flash_attention_desc(80, 2048, 2048, 128, 5, bf)}


@pytest.mark.parametrize("label", ["mm_hp_up", "mm_hp_down", "mm_be",
                                   "flash_hp", "flash_be"])
def test_route_takes_tensor_cores_on_the_main_path(label):
    """Every bf16 launch of the main path, at its descriptor's defaults,
    goes to wgmma + TMA, and the wrapper's checks accept it."""
    from repro_torch.kernels.launch import TENSOR_CORES
    desc = _main_path()[label]
    args = _inputs(desc, torch.bfloat16)
    assert desc.kernel.route(desc, args) == TENSOR_CORES
    desc.kernel.check(desc, args, new_outputs(desc, torch.device("cpu")))


def _f32_cases():
    from repro_torch.kernels.matmul import matmul_desc
    return {
        # the parity geometries of the transform and on-card tests
        "mm parity": matmul_desc(96, 64, 48, bm=16, bk=32, bn=16),
        "flash parity": flash_attention_desc(6, 32, 32, 8, 2, bq=8, bk=8),
        "flash q_offset": flash_attention_desc(6, 32, 40, 8, 2, q_offset=8,
                                               bq=8, bk=8),
        # f32 at a main-path shape: still the CUDA cores (no TF32)
        "mm 512x5120x13824 f32": matmul_desc(512, 5120, 13824),
        "flash D=128 f32": flash_attention_desc(8, 64, 64, 128, 2),
    }


@pytest.mark.parametrize("label", list(_f32_cases()))
def test_route_takes_cuda_cores_for_f32(label):
    from repro_torch.kernels.launch import CUDA_CORES
    desc = _f32_cases()[label]
    args = _inputs(desc, torch.float32)
    assert desc.kernel.route(desc, args) == CUDA_CORES
    desc.kernel.check(desc, args, new_outputs(desc, torch.device("cpu")))


@pytest.mark.parametrize("N,bn", [(688, 16), (864, 96), (1184, 32),
                                  (13824, 128)])
def test_matmul_column_tiles_are_multiples_of_8(N, bn):
    """bf16 column tiles that TMA loads from 16-byte boundaries: the
    largest divisor of N up to 128 that is a multiple of 8 (86, 108 and
    74, the largest divisors of the first three, trap the card), on the
    tensor cores; a tile of 4 columns is refused before any launch."""
    from repro_torch.kernels.launch import TENSOR_CORES
    from repro_torch.kernels.matmul import MATMUL, matmul_desc
    bf = torch.bfloat16
    d = matmul_desc(256, 512, N, bf)
    assert d.static["bn"] == bn and d.grid[1] == N // bn
    assert MATMUL.route(d, _inputs(d, bf)) == TENSOR_CORES
    d = matmul_desc(256, 512, N, bf, bn=4)
    assert d.static["bn"] == 4
    args = _inputs(d, bf)
    assert MATMUL.route(d, args) is None
    with pytest.raises(ValueError, match="no matmul route"):
        MATMUL.check(d, args, new_outputs(d, torch.device("cpu")))


def test_check_raises_on_a_launch_no_route_takes():
    """bf16 that TMA cannot read (K or N not a multiple of 8, a base off
    the 16-byte grid), bf16 flash with D outside (64, 128), f32 flash with
    D > 128: refused before any launch, never sent to the other route."""
    from repro_torch.kernels.matmul import MATMUL, matmul_desc
    bf = torch.bfloat16
    cpu = torch.device("cpu")
    d = matmul_desc(64, 12, 32, bf)
    a, b = _inputs(d, bf)
    assert MATMUL.route(d, (a, b)) is None
    with pytest.raises(ValueError, match="no matmul route"):
        MATMUL.check(d, (a, b), new_outputs(d, cpu))
    d = matmul_desc(64, 64, 32, bf)
    a, b = _inputs(d, bf)
    shifted = torch.empty(64 * 64 + 1, dtype=bf)[1:].view(64, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="no matmul route"):
        MATMUL.check(d, (shifted, b), new_outputs(d, cpu))
    for D, dt in ((32, bf), (256, torch.float32)):
        fd = flash_attention_desc(4, 64, 64, D, 2, dt)
        args = _inputs(fd, dt)
        assert fd.kernel.route(fd, args) is None
        with pytest.raises(ValueError, match="no flash route"):
            fd.kernel.check(fd, args, new_outputs(fd, cpu))


def test_every_c_entry_point_has_its_counter():
    """The C symbols of csrc/*.cu are exactly the families' counted entry
    points: each route's plain, sliced and persistent forms."""
    import re
    from pathlib import Path
    from repro_torch import kernels
    from repro_torch.kernels.launch import FORMS
    csrc = Path(kernels.__file__).parent / "csrc"
    for fam in kernels.FAMILIES:
        text = (csrc / f"{fam.lib}.cu").read_text()
        exported = text[text.index('extern "C" {'):]
        symbols = set(re.findall(r"^int (\w+)\(", exported, re.M))
        assert symbols == set(fam.launches)
        assert set(fam.launches) == {fam.symbol(r, f) for r in fam.routes
                                     for f in FORMS}


# ---------------------------------------------------------------------------
# The SSD's routes, and the tensor-core route's roundings emulated on the CPU
# ---------------------------------------------------------------------------

def _ssd_launch(S, dtype, HD=64, DS=128, B=1, NH=24, chunk=256):
    desc = mamba2_scan_desc(B, S, NH, HD, DS, chunk, dtype)
    f32 = torch.float32
    args = (torch.empty(B, S, NH, HD, dtype=dtype),
            torch.empty(B, S, NH, dtype=f32), torch.empty(NH, dtype=f32),
            torch.empty(B, S, DS, dtype=dtype),
            torch.empty(B, S, DS, dtype=dtype), torch.empty(NH, dtype=f32))
    return desc, args


@pytest.mark.parametrize("S,L", [(512, 256), (300, 150), (257, 1),
                                 (100, 100), (64, 64)])
def test_ssd_route_takes_tensor_cores_for_bf16(S, L):
    """bf16 at mamba2-130m width (HD 64, DS 128), at every chunk length
    that phase 5's prompts make, goes to wgmma + TMA; so does DS = 64."""
    from repro_torch.kernels.launch import TENSOR_CORES
    for DS in (128, 64):
        desc, args = _ssd_launch(S, torch.bfloat16, DS=DS)
        assert desc.static["L"] == L
        assert SSD.route(desc, args) == TENSOR_CORES
        SSD.check(desc, args, new_outputs(desc, torch.device("cpu")))


@pytest.mark.parametrize("S", [512, 300, 257])
def test_ssd_route_takes_cuda_cores_for_f32(S):
    from repro_torch.kernels.launch import CUDA_CORES
    desc, args = _ssd_launch(S, torch.float32)
    assert SSD.route(desc, args) == CUDA_CORES
    SSD.check(desc, args, new_outputs(desc, torch.device("cpu")))


def test_ssd_check_raises_on_a_launch_no_route_takes():
    """bf16 with HD != 64, DS = 96 or a base off the 16-byte grid, and f32
    past the CUDA-core routine's limits: refused before any launch, never
    sent to the other route."""
    cpu = torch.device("cpu")
    bad = [_ssd_launch(512, torch.bfloat16, HD=32),
           _ssd_launch(512, torch.bfloat16, DS=96),
           _ssd_launch(512, torch.float32, DS=256)]
    desc, args = _ssd_launch(512, torch.bfloat16)
    x = args[0]
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    bad.append((desc, (shifted, *args[1:])))
    for desc, args in bad:
        assert SSD.route(desc, args) is None
        with pytest.raises(ValueError, match="no ssd route"):
            SSD.check(desc, args, new_outputs(desc, cpu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_wrapper_splits_a_wide_head_exactly(dtype):
    """jamba's SSD heads of 128 columns run as two heads of 64 (the
    kernels' width): every launch at HD = 64 with twice the heads, each
    carrying its head's dt, A and D; y and the final state equal one
    walk of the reference body over the whole heads, bit for bit (the
    same products in the same order)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba2_scan import make_ssd_body
    g = torch.Generator().manual_seed(5)
    B, S, NH, HD, DS, chunk = 2, 64, 3, 128, 16, 32
    x = torch.randn(B, S, NH, HD, generator=g).to(dtype)
    dt = torch.rand(B, S, NH, generator=g) * 0.1
    A = -torch.rand(NH, generator=g) - 0.5
    Bm = torch.randn(B, S, DS, generator=g).to(dtype)
    Cm = torch.randn(B, S, DS, generator=g).to(dtype)
    D = torch.randn(NH, generator=g)
    seen = []
    desc_fn = ops.mamba2_scan_desc

    def recording(*a, **kw):
        seen.append(a[:5])
        return desc_fn(*a, **kw)
    ops.mamba2_scan_desc = recording
    try:
        y, h = ops.mamba2_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    finally:
        ops.mamba2_scan_desc = desc_fn
    assert seen == [(B, S, 2 * NH, 64, DS)]
    body = make_ssd_body(chunk, NH, HD, DS)
    want_y = torch.empty(B, S, NH, HD, dtype=dtype)
    want_h = torch.zeros(B, NH, HD, DS)
    for b in range(B):
        for c in range(S // chunk):
            t = slice(c * chunk, (c + 1) * chunk)
            yb = want_y[b:b + 1, t]
            body((b, c), x[b:b + 1, t], dt[b:b + 1, t], A, Bm[b:b + 1, t],
                 Cm[b:b + 1, t], D, yb, want_h[b:b + 1])
    assert torch.equal(h, want_h) and torch.equal(y, want_y)


def _split(v, lo=True):
    """An f32 operand as bf16 hi + lo (the tensor-core route's split), or
    rounded once to bf16 (``lo=False``), back in f32."""
    hi = v.to(torch.bfloat16).float()
    return hi + ((v - hi).to(torch.bfloat16).float() if lo else 0.0)


def emulate_tc_route(x, dt, A, Bm, Cm, D, piece=256, split=("G", "x'", "h")):
    """The arithmetic of the SSD's bf16 tensor-core route
    (``csrc/mamba2_scan.cu``, namespace tc) in f32 on the CPU: the tokens
    in pieces of ``piece`` whatever the chunk length; x, B and C enter the
    products as they are (bf16, exact); G, x' and h as bf16 hi + lo (each
    operand named in ``split``; any other is rounded once to bf16); y
    rounded once to bf16 at the end."""
    B, S, NH, HD = x.shape
    xf, bf, cf = x.float(), Bm.float(), Cm.float()
    h = torch.zeros(B, NH, HD, Bm.shape[-1])
    y = torch.empty(B, S, NH, HD)
    for s0 in range(0, S, piece):
        sl = slice(s0, min(S, s0 + piece))
        xk, dtk, bk, ck = xf[:, sl], dt[:, sl], bf[:, sl], cf[:, sl]
        n = xk.shape[1]
        cum = torch.cumsum(dtk * A, dim=1)                  # (B, n, NH)
        tot = cum[:, -1]
        tri = torch.ones(n, n, dtype=torch.bool).tril()
        delta = torch.where(tri[None, ..., None],
                            cum[:, :, None] - cum[:, None], -torch.inf)
        g = (torch.einsum("btn,bsn->bts", ck, bk)[..., None]
             * torch.exp(delta) * dtk[:, None])             # (B, t, s, NH)
        yk = torch.einsum("btsh,bshd->bthd", _split(g, "G" in split), xk)
        yk = yk + torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhdn->bthd", ck, _split(h, "h" in split))
        y[:, sl] = yk + xk * D[None, None, :, None]
        xp = (torch.exp(tot[:, None] - cum) * dtk)[..., None] * xk
        h = (torch.exp(tot)[..., None, None] * h
             + torch.einsum("bshd,bsn->bhdn", _split(xp, "x'" in split), bk))
    return y.to(torch.bfloat16), h


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _ssd_model_case(width, S, B=1):
    """An SSD launch of chip_smoke.py's kind (B and C scaled so that C.B is
    of order one) at mamba2-130m's full or reduced width."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-130m")
    cfg = cfg if width == "full" else cfg.reduced()
    s = cfg.ssm
    return _chip_smoke().ssd_case(
        np.random.default_rng(S), torch.device("cpu"), B, S,
        s.num_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk_size,
        torch.bfloat16)


@pytest.mark.parametrize("width,S,B", [("full", 512, 1), ("full", 300, 1),
                                       ("full", 257, 1), ("reduced", 64, 2),
                                       ("reduced", 37, 2)])
def test_tc_route_roundings_stay_inside_the_gates(width, S, B):
    """With G, x' and h split hi + lo, the route's arithmetic agrees with
    the f32 plain version at chip_smoke.py's own gates: y within 2 bf16
    ulps, h within 1e-4 max|h|; at full width B = 1 (the HP prefill) and
    at reduced width, for chunk lengths the pieces cut across."""
    cs = _chip_smoke()
    desc, args = _ssd_model_case(width, S, B)
    want = new_outputs(desc, torch.device("cpu"), zero=True)
    SSD.plain_version(desc, args, want)
    y, h = emulate_tc_route(*args)
    cs.compare("y", y, want[0], "ssd")
    cs.compare("h", h, want[1], "ssd")


@pytest.mark.parametrize("once", ["G", "x'", "h"])
def test_tc_route_needs_every_split(once):
    """Rounding any one of G, x' and h to bf16 once, instead of splitting
    it, breaks a gate at full width: why the route splits all three."""
    cs = _chip_smoke()
    desc, args = _ssd_model_case("full", 512)
    want = new_outputs(desc, torch.device("cpu"), zero=True)
    SSD.plain_version(desc, args, want)
    y, h = emulate_tc_route(*args, split={"G", "x'", "h"} - {once})
    with pytest.raises(AssertionError, match="disagrees"):
        cs.compare("y", y, want[0], "ssd")
        cs.compare("h", h, want[1], "ssd")
