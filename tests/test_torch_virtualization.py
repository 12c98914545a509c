"""The port's real-mode Tally server (plain PyTorch versions on the CPU):
the five cases of tests/test_virtualization.py, a slice-level parity run
against the JAX server, and the card-by-default rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.virtualization import TallyServer as JTallyServer
from repro.kernels.flash_attention import \
    flash_attention_desc as jflash_desc
from repro.kernels.matmul import matmul_desc as jmatmul_desc
from repro_torch.core import transforms as T
from repro_torch.core.profiler import LaunchConfig, ProfileEntry
from repro_torch.core.virtualization import TallyServer
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_desc
from repro_torch.kernels.matmul import matmul_desc

RNG = np.random.default_rng(11)


@pytest.fixture()
def server():
    return TallyServer(device="cpu")


def _t(*shape):
    return torch.from_numpy(RNG.normal(size=shape).astype(np.float32))


def _mm_case(m=96, k=64, n=48):
    a, b = _t(m, k), _t(k, n)
    return matmul_desc(m, k, n, bm=16, bk=32, bn=16), (a, b), \
        ref.matmul_ref(a, b)


def _close(got, want, rtol=5e-4, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


def test_priority_and_numerics(server):
    hp = server.register("hp", priority=0)
    be = server.register("be", priority=1)
    d_be, args_be, want_be = _mm_case(96, 64, 48)
    d_hp, args_hp, want_hp = _mm_case(32, 64, 48)
    job_be = be.launch(d_be, *args_be)
    job_hp = hp.launch(d_hp, *args_hp)
    server.serve_until_idle(max_seconds=180)
    _close(job_hp.result(0)[0], want_hp)
    _close(job_be.result(0)[0], want_be)
    assert job_hp.complete_t <= job_be.complete_t


def test_be_kernel_is_transformed(server):
    be = server.register("be", priority=1)
    desc, args, want = _mm_case(96, 64, 48)
    job = be.launch(desc, *args)
    server.serve_until_idle(max_seconds=180)
    _close(job.result(0)[0], want)
    cfg = server.profiler.lookup_launch_config(job)
    assert cfg is not None and cfg.mode in ("slice", "preempt")


def test_flash_attention_through_server(server):
    be = server.register("be", priority=1)
    BH, S, D, G = 4, 32, 8, 2
    q, k, v = _t(BH, S, D), _t(BH // G, S, D), _t(BH // G, S, D)
    desc = flash_attention_desc(BH, S, S, D, G, causal=True, bq=8, bk=8)
    job = be.launch(desc, q, k, v)
    server.serve_until_idle(max_seconds=180)
    want = ref.attention_ref(q, k, v, causal=True, group=G)
    _close(job.result(0)[0], want, rtol=1e-3, atol=1e-4)


def test_client_side_state_caching(server):
    c = server.register("c", priority=0)
    assert c.device_info("sm_count") == 8
    before = c.forwarded_calls
    for _ in range(5):
        c.device_info("sm_count")
    assert c.forwarded_calls == before        # served from local cache
    assert c.cached_calls >= 5


def test_hp_runs_untransformed(server):
    hp = server.register("hp", priority=0)
    desc, args, want = _mm_case(48, 64, 32)
    job = hp.launch(desc, *args)
    server.serve_until_idle(max_seconds=180)
    _close(job.result(0)[0], want)
    # HP kernels bypass the profiler entirely (launched immediately)
    assert server.profiler.lookup_launch_config(job) is None


@pytest.mark.parametrize("cfg", [LaunchConfig("slice", 3),
                                 LaunchConfig("preempt", 5)])
def test_slice_progress_matches_reference(cfg):
    """BE progress per quantum, in flat-task units, is the reference's
    ``int(num_blocks * (off+ln)/grid[ax])`` (slice) or watermark (preempt):
    the shared scheduler sees the same ``remaining`` after every quantum."""
    srv = TallyServer(device="cpu")
    be = srv.register("be", priority=1)
    desc, args, want = _mm_case(96, 64, 48)
    job = be.launch(desc, *args)
    # pin the config so the quanta are known in advance
    srv.profiler._cache[srv.profiler._work_key(job)] = ProfileEntry(
        cfg, 0.0, 0.0)
    seen = []
    sc = srv._sched_clients["be"]
    while srv.scheduler.schedule_once():
        seen.append(desc.num_blocks if sc.current is None
                    else sc.current.watermark)
    if cfg.mode == "slice":
        ax = T._slice_axis(desc)
        plan = T.slice_plan(desc, cfg.param)
        expect = [int(desc.num_blocks * (o + n) / desc.grid[ax])
                  for o, n in plan[:-1]] + [desc.num_blocks]
    else:
        W = min(cfg.param, desc.num_blocks)
        expect, wm = [], 0
        while wm < desc.num_blocks:
            wm = T.preempt_watermark(wm, srv.preempt_budget, W,
                                     desc.num_blocks)
            expect.append(wm)
    assert seen == expect
    _close(job.result(0)[0], want)


def test_server_parity_with_jax():
    """The same HP and BE submissions through the JAX server and the port's:
    outputs agree, and both finish HP first."""
    rng = np.random.default_rng(5)
    a_be = rng.normal(size=(96, 64)).astype(np.float32)
    b = rng.normal(size=(64, 48)).astype(np.float32)
    a_hp = rng.normal(size=(32, 64)).astype(np.float32)
    BH, S, D, G = 4, 32, 8, 2
    q = rng.normal(size=(BH, S, D)).astype(np.float32)
    kv = rng.normal(size=(2, BH // G, S, D)).astype(np.float32)
    geo_mm = dict(bm=16, bk=32, bn=16)
    geo_fl = dict(causal=True, bq=8, bk=8)

    results = {}
    for side, Srv, mm, fl, arr in (
            ("jax", JTallyServer, jmatmul_desc, jflash_desc, jnp.asarray),
            ("torch", lambda: TallyServer(device="cpu"), matmul_desc,
             flash_attention_desc, torch.from_numpy)):
        srv = Srv()
        hp = srv.register("hp", priority=0)
        be = srv.register("be", priority=1)
        jobs = [be.launch(mm(96, 64, 48, **geo_mm), arr(a_be), arr(b)),
                be.launch(fl(BH, S, S, D, G, **geo_fl), arr(q), arr(kv[0]),
                          arr(kv[1])),
                hp.launch(mm(32, 64, 48, **geo_mm), arr(a_hp), arr(b))]
        srv.serve_until_idle(max_seconds=180)
        assert jobs[2].complete_t <= min(j.complete_t for j in jobs[:2])
        results[side] = [np.asarray(j.result(0)[0]) for j in jobs]
    for t, j in zip(results["torch"], results["jax"]):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TallyServer()
