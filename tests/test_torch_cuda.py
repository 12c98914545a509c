"""On-card checks of the CUDA kernels against their plain versions, at the
small parity shapes (f32, the CUDA-core route) and at the edges of the
tensor-core route (bf16: matmul, flash attention and the SSD scan). They need a CUDA card and skip without one; the
card's full check is ``python3 chip_smoke.py``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import transforms as T
from repro_torch.core.descriptor import build_plain, new_outputs
from repro_torch.kernels.flash_attention import flash_attention_desc
from repro_torch.kernels.launch import CUDA_CORES, TENSOR_CORES
from repro_torch.kernels.matmul import matmul_desc

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cases(dev):
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    yield matmul_desc(96, 64, 48, bm=16, bk=32, bn=16), (t(96, 64), t(64, 48))
    yield (flash_attention_desc(6, 32, 40, 8, 2, causal=True, q_offset=8,
                                bq=8, bk=8), (t(6, 32, 8), t(3, 40, 8),
                                              t(3, 40, 8)))


@pytest.mark.parametrize("form", ["plain", "sliced", "persistent"])
def test_kernel_matches_plain_version(cuda, form):
    for desc, args in _cases(cuda):
        fam = desc.kernel
        want = new_outputs(desc, cuda, zero=True)
        fam.plain_version(desc, args, want)
        before = dict(fam.launches)
        if form == "plain":
            got = list(build_plain(desc)(*args))
        elif form == "sliced":
            got = new_outputs(desc, cuda, zero=True)
            for off, ln in T.slice_plan(desc, 3):
                got = list(T.build_sliced(desc, off, ln)(got, *args))
        else:
            pre = T.make_preemptible(desc, 5)
            got, start = new_outputs(desc, cuda, zero=True), 0
            while start < pre.total_tasks:
                got, done = pre(got, start, 2, *args)
                ref_done = fam.persistent_version(
                    desc, pre.num_workers, start, 2, args,
                    new_outputs(desc, cuda, zero=True))
                assert torch.equal(done.cpu(), ref_done.cpu())
                start = pre.watermark(start, 2)
        torch.cuda.synchronize()
        sym = fam.symbol(CUDA_CORES, form)
        assert fam.launches[sym] > before[sym]
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", ["plain", "sliced", "persistent"])
@pytest.mark.parametrize("label", list(cs.TC_EDGES))
def test_tensor_core_route_matches_plain_version(cuda, form, label):
    """Each bf16 edge case of chip_smoke.py takes the tensor-core route in
    each form and agrees with the plain version at chip_smoke.py's gates;
    the persistent form runs 3 workers (2 for the SSD's 3 batch tasks), so
    a worker runs several tasks a launch (the ring's phase carries over),
    with budgets 1, 2 and 5, each with its own ``done`` equal to the plain
    version's."""
    desc, args = cs.tc_cases(cuda)[label]
    fam = desc.kernel
    assert fam.route(desc, args) == TENSOR_CORES
    want = new_outputs(desc, cuda, zero=True)
    fam.plain_version(desc, args, want)
    before = dict(fam.launches)
    runs = []
    if form == "plain":
        got = new_outputs(desc, cuda, zero=True)
        fam.plain(desc, args, got)
        runs.append(got)
    elif form == "sliced":
        got = new_outputs(desc, cuda, zero=True)
        for off, ln in T.slice_plan(desc, 3):
            fam.sliced(T.make_slice(desc, off, ln), args, got)
        runs.append(got)
    else:
        W = min(2 if fam.name == "ssd" else 3, desc.num_blocks)
        for budget in (1, 2, 5):
            got, start = new_outputs(desc, cuda, zero=True), 0
            while start < desc.num_blocks:
                done = fam.persistent(desc, W, start, budget, args, got)
                ref_done = fam.persistent_version(
                    desc, W, start, budget, args,
                    new_outputs(desc, cuda, zero=True))
                assert torch.equal(done.cpu(), ref_done.cpu())
                start = T.preempt_watermark(start, budget, W,
                                            desc.num_blocks)
            runs.append(got)
    torch.cuda.synchronize()
    assert fam.launches[fam.symbol(TENSOR_CORES, form)] > before[
        fam.symbol(TENSOR_CORES, form)]
    assert fam.launches[fam.symbol(CUDA_CORES, form)] == before[
        fam.symbol(CUDA_CORES, form)]
    for got in runs:
        for k, (g, w) in enumerate(zip(got, want)):
            cs.compare(f"{label} out{k}", g, w, fam.name,
                       cs.p_rounding_slack(desc, args))


def _ssd_args(dev, B, S, NH, HD, DS, dtype=torch.float32, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape, lo=None, hi=None, dt=torch.float32):
        a = (rng.uniform(lo, hi, size=shape) if lo is not None
             else rng.normal(size=shape))
        return torch.from_numpy(a.astype(np.float32)).to(dev, dt)

    return (t(B, S, NH, HD, dt=dtype), t(B, S, NH, lo=0.1, hi=0.9),
            -t(NH, lo=0.5, hi=2.0), t(B, S, DS, dt=dtype),
            t(B, S, DS, dt=dtype), t(NH))


# (B, S, NH, HD, DS, chunk): the transform tests' parity geometry, a prime
# S (L = 1), S < chunk, L = 150 (not a power of two), and L = 256 at the
# model's head and state widths
SSD_SHAPES = [(3, 24, 2, 4, 4, 8), (2, 13, 2, 4, 4, 8), (2, 20, 3, 8, 5, 32),
              (2, 300, 2, 16, 8, 256), (2, 512, 3, 64, 128, 256)]


@pytest.mark.parametrize("form", ["plain", "sliced", "persistent"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain_version(cuda, form, shape):
    """f32, the CUDA-core route (``ssd_fma_*``): only the order of the sums
    differs (y within 1e-4 relative to max|y|, h within 1e-4 relative to
    max|h|); persistent ``done`` equal."""
    from repro_torch.kernels.mamba2_scan import SSD, mamba2_scan_desc
    B, S, NH, HD, DS, chunk = shape
    args = _ssd_args(cuda, B, S, NH, HD, DS)
    desc = mamba2_scan_desc(B, S, NH, HD, DS, chunk)
    want = new_outputs(desc, cuda, zero=True)
    SSD.plain_version(desc, args, want)
    before = SSD.launches[f"ssd_fma_{form}"]
    got = new_outputs(desc, cuda, zero=True)
    if form == "plain":
        SSD.plain(desc, args, got)
    elif form == "sliced":
        for off, ln in T.slice_plan(desc, 2):
            SSD.sliced(T.make_slice(desc, off, ln), args, got)
    else:
        start = 0
        while start < desc.num_blocks:
            done = SSD.persistent(desc, 2, start, 1, args, got)
            ref_done = SSD.persistent_version(
                desc, 2, start, 1, args, new_outputs(desc, cuda, zero=True))
            assert torch.equal(done.cpu(), ref_done.cpu())
            start = T.preempt_watermark(start, 1, 2, desc.num_blocks)
    torch.cuda.synchronize()
    assert SSD.launches[f"ssd_fma_{form}"] > before
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * max(w.abs().max().item(), 1.0), err


def test_ssd_kernel_bf16_full_width(cuda):
    """bf16 x, B, C at mamba2-130m width, the tensor-core route: y within 2
    bf16 ulps of the plain version, the ulp taken no smaller than at 2^-8
    max|y| (f32 sums of the same terms in another order, then one rounding;
    the sums' error scales with the terms, which are of the order of
    max|y|, not with |y|), h within 1e-3 of max|h|."""
    from repro_torch.kernels.mamba2_scan import SSD, mamba2_scan_desc
    args = _ssd_args(cuda, 2, 512, 24, 64, 128, torch.bfloat16)
    desc = mamba2_scan_desc(2, 512, 24, 64, 128, 256, torch.bfloat16)
    want = new_outputs(desc, cuda)
    SSD.plain_version(desc, args, want)
    before = SSD.launches["ssd_plain"]
    got = build_plain(desc)(*args)
    torch.cuda.synchronize()
    assert SSD.launches["ssd_plain"] == before + 1
    y, h = got
    yw, hw = want
    ulp = torch.exp2(torch.floor(torch.log2(yw.float().abs().clamp_min(
        2.0 ** -8 * yw.float().abs().max().item()))) - 7)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert bool(((y.float() - yw.float()).abs() <= 2 * ulp).all())
    assert (h - hw).abs().max().item() <= 1e-3 * hw.abs().max().item()
