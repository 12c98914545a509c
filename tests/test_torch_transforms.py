"""The port's transforms against the JAX reference: the same slice plans,
slice axes and watermarks, and — for the matmul, flash attention and SSD
scan kernels — the same sliced and preemptible outputs and per-launch
``done`` arrays, on the same numpy inputs (the port's plain PyTorch path on the CPU,
the reference's Pallas kernels in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transforms as JT
from repro.kernels import ref as jref
from repro.kernels.flash_attention import \
    flash_attention_desc as jflash_desc
from repro.kernels.mamba2_scan import mamba2_scan_desc as jssd_desc
from repro.kernels.matmul import matmul_desc as jmatmul_desc
from repro_torch.core import transforms as T
from repro_torch.core.descriptor import new_outputs
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_desc
from repro_torch.kernels.mamba2_scan import mamba2_scan_desc
from repro_torch.kernels.matmul import matmul_desc

TOL = dict(rtol=1e-4, atol=1e-4)


def _matmul_case():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(96, 64)).astype(np.float32)
    b = rng.normal(size=(64, 48)).astype(np.float32)
    geo = dict(bm=16, bk=32, bn=16)
    return (jmatmul_desc(96, 64, 48, **geo), matmul_desc(96, 64, 48, **geo),
            (a, b), lambda *t: [ref.matmul_ref(*t)])


def _flash_case():
    rng = np.random.default_rng(8)
    BH, S, D, G = 6, 32, 8, 2
    q = rng.normal(size=(BH, S, D)).astype(np.float32)
    k = rng.normal(size=(BH // G, S, D)).astype(np.float32)
    v = rng.normal(size=(BH // G, S, D)).astype(np.float32)
    geo = dict(causal=True, bq=8, bk=8)
    return (jflash_desc(BH, S, S, D, G, **geo),
            flash_attention_desc(BH, S, S, D, G, **geo), (q, k, v),
            lambda *t: [ref.attention_ref(*t, causal=True, group=G)])


def _ssd_case():
    """The reference's ``_ssd_case`` geometry (tests/test_transforms.py),
    against the per-token recurrence (JAX's ``ssd_ref``)."""
    rng = np.random.default_rng(9)
    B, S, NH, HD, DS = 3, 24, 2, 4, 4
    args = (rng.normal(size=(B, S, NH, HD)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(B, S, NH)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(NH,)).astype(np.float32),
            rng.normal(size=(B, S, DS)).astype(np.float32),
            rng.normal(size=(B, S, DS)).astype(np.float32),
            rng.normal(size=(NH,)).astype(np.float32))
    return (jssd_desc(B, S, NH, HD, DS, chunk=8),
            mamba2_scan_desc(B, S, NH, HD, DS, chunk=8), args,
            lambda *t: [torch.from_numpy(np.array(o)) for o in
                        jref.ssd_ref(*(jnp.asarray(a.numpy()) for a in t))])


CASES = {"matmul": _matmul_case, "flash": _flash_case, "ssd": _ssd_case}

GEOMETRIES = {
    "matmul": lambda: (jmatmul_desc(96, 64, 48, bm=16, bk=32, bn=16),
                       matmul_desc(96, 64, 48, bm=16, bk=32, bn=16)),
    "matmul_property": lambda: (jmatmul_desc(32, 16, 32, bm=8, bk=8, bn=8),
                                matmul_desc(32, 16, 32, bm=8, bk=8, bn=8)),
    "flash": lambda: (jflash_desc(6, 32, 32, 8, 2, bq=8, bk=8),
                      flash_attention_desc(6, 32, 32, 8, 2, bq=8, bk=8)),
    "flash_tall": lambda: (jflash_desc(4, 64, 64, 8, 2, bq=8, bk=16),
                           flash_attention_desc(4, 64, 64, 8, 2, bq=8,
                                                bk=16)),
    "ssd": lambda: (jssd_desc(3, 24, 2, 4, 4, chunk=8),
                    mamba2_scan_desc(3, 24, 2, 4, 4, chunk=8)),
    "ssd_wide_batch": lambda: (jssd_desc(16, 13, 2, 4, 4, chunk=8),
                               mamba2_scan_desc(16, 13, 2, 4, 4, chunk=8)),
}


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_geometry_matches_reference(geo):
    jd, td = GEOMETRIES[geo]()
    assert td.grid == jd.grid
    assert td.parallel_axes == jd.parallel_axes
    assert td.sequential_axes == jd.sequential_axes
    assert td.num_blocks == jd.num_blocks
    assert (td.flops, td.bytes_accessed) == (jd.flops, jd.bytes_accessed)
    assert T._slice_axis(td) == JT._slice_axis(jd)
    for k in range(1, 20):
        plan = T.slice_plan(td, k)
        assert plan == JT.slice_plan(jd, k)
        assert plan[0][0] == 0
        assert sum(ln for _, ln in plan) == td.grid[T._slice_axis(td)]


def test_watermark_and_task_pids_match_reference():
    jd, td = GEOMETRIES["matmul"]()
    total = td.num_blocks
    for W in (1, 2, 3, 4, 8, 200):
        pre = T.make_preemptible(td, W)
        assert pre.num_workers == max(1, min(W, total))      # clamped W
        assert pre.total_tasks == total
        for start in (0, 1, 5, total - 1):
            for budget in (1, 2, 5):
                assert pre.watermark(start, budget) == JT.preempt_watermark(
                    start, budget, pre.num_workers, total)
    for task in range(total):
        for kk in range(td.grid[2]):
            assert T._task_to_pids(td, task, (kk,)) == tuple(
                int(p) for p in JT._task_to_pids(jd, task, (kk,)))


def _jax_sliced(jd, args, k):
    outs = [jnp.zeros(o.shape, o.dtype) for o in jd.out_shape]
    for off, ln in JT.slice_plan(jd, k):
        outs = list(JT.build_sliced(jd, off, ln)(outs, *args))
    return outs


def _torch_sliced(td, args, k):
    outs = new_outputs(td, torch.device("cpu"), zero=True)
    for off, ln in T.slice_plan(td, k):
        outs = list(T.build_sliced(td, off, ln)(outs, *args))
    return outs


def _run_preempt(pre, outs, args, budgets):
    start, i, dones = 0, 0, []
    while start < pre.total_tasks:
        b = budgets[i % len(budgets)]
        outs, done = pre(outs, start, b, *args)
        new_start = pre.watermark(start, b)
        assert new_start > start
        start, i = new_start, i + 1
        dones.append(np.asarray(done))
    return list(outs), dones


def _check(outs, jouts, want):
    for o, j, w in zip(outs, jouts, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(j), **TOL)
        np.testing.assert_allclose(o.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("num_slices", [1, 2, 3, 7])
def test_sliced_matches_reference(case, num_slices):
    jd, td, np_args, oracle = CASES[case]()
    targs = [torch.from_numpy(a) for a in np_args]
    outs = _torch_sliced(td, targs, num_slices)
    jouts = _jax_sliced(jd, [jnp.asarray(a) for a in np_args], num_slices)
    _check(outs, jouts, oracle(*targs))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("num_workers,budgets", [(1, [1]), (2, [1]),
                                                 (4, [2]), (3, [1, 2, 5])])
def test_preemptible_matches_reference(case, num_workers, budgets):
    jd, td, np_args, oracle = CASES[case]()
    targs = [torch.from_numpy(a) for a in np_args]
    outs, dones = _run_preempt(
        T.make_preemptible(td, num_workers),
        new_outputs(td, torch.device("cpu"), zero=True), targs, budgets)
    jouts, jdones = _run_preempt(
        JT.make_preemptible(jd, num_workers),
        [jnp.zeros(o.shape, o.dtype) for o in jd.out_shape],
        [jnp.asarray(a) for a in np_args], budgets)
    _check(outs, jouts, oracle(*targs))
    assert len(dones) == len(jdones)
    for d, jdn in zip(dones, jdones):
        assert d.dtype == np.int32
        np.testing.assert_array_equal(d, jdn)


def test_sliced_writes_only_its_tiles():
    """A slice launch leaves every tile outside its range untouched."""
    _, td, np_args, _ = CASES["matmul"]()
    targs = [torch.from_numpy(a) for a in np_args]
    ax = T._slice_axis(td)
    off, ln = T.slice_plan(td, 3)[1]
    sentinel = torch.full((96, 48), 7.0)
    (out,) = T.build_sliced(td, off, ln)([sentinel.clone()], *targs)
    bn = td.static["bn"] if ax == 1 else td.static["bm"]
    mine = torch.zeros_like(out, dtype=torch.bool)
    if ax == 1:
        mine[:, off * bn:(off + ln) * bn] = True
    else:
        mine[off * bn:(off + ln) * bn, :] = True
    assert torch.all(out[~mine] == 7.0)
    np.testing.assert_allclose(out[mine].numpy(),
                               ref.matmul_ref(*targs)[mine].numpy(), **TOL)


def test_launch_grid_takes_one_or_two_parallel_axes():
    """The CUDA launch forms' grid and offsets: two parallel axes as they
    are; the SSD's one axis as (G0, 1) with off1 = 0."""
    from repro_torch.kernels.launch import TileKernel
    _, md = GEOMETRIES["matmul"]()
    assert TileKernel._grid(md) == (md.grid[0], md.grid[1])
    sub = T.make_slice(md, 2, 3)
    assert TileKernel._pair(sub, sub.offsets, 0) == tuple(
        sub.offsets[ax] for ax in sub.parallel_axes)
    _, sd = GEOMETRIES["ssd_wide_batch"]()
    assert TileKernel._grid(sd) == (16, 1)
    for off, ln in T.slice_plan(sd, 3):
        s = T.make_slice(sd, off, ln)
        assert TileKernel._grid(s) == (ln, 1)
        assert TileKernel._pair(s, s.offsets, 0) == (off, 0)
    with pytest.raises(ValueError, match="parallel axes"):
        TileKernel._grid(sd.replace(parallel_axes=()))
