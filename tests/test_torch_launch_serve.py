"""The port's serving driver (``repro_torch.launch.serve``) and its copies
of the traffic and latency code against the JAX package's: the same MAF2
arrivals for the same seed, and ``serve()`` on the CPU giving the
reference's request, shed and retry counts with the injected outage off
and on."""
import json
import math

import numpy as np
import pytest

from repro.core import metrics as jmetrics
from repro.core import traffic as jtraffic
from repro.launch import serve as jserve
from repro_torch.core import metrics, traffic
from repro_torch.launch import serve as tserve


@pytest.mark.parametrize("kw", [dict(), dict(duration=0.64, seed=0),
                                dict(duration=30.0, mean_rate=7.0,
                                     burstiness=5.0, level_period=2.0,
                                     seed=3)])
def test_maf2_trace_matches_reference(kw):
    want = jtraffic.maf2_like_trace(**kw)
    got = traffic.maf2_like_trace(**kw)
    np.testing.assert_array_equal(got.arrivals, want.arrivals)
    assert got.duration == want.duration


def test_latency_stats_match_reference():
    xs = np.random.default_rng(0).exponential(size=37)
    want, got = jmetrics.LatencyStats(), metrics.LatencyStats()
    for x in xs:
        want.record(x)
        got.record(x)
    assert got.latencies == want.latencies
    for q in ("p50", "p99"):
        assert getattr(got, q)() == getattr(want, q)()
    assert math.isnan(metrics.LatencyStats().p99())
    assert metrics.percentile(list(xs), 90.0) == jmetrics.percentile(
        list(xs), 90.0)


def _counts(out):
    return {k: out[k] for k in ("arch", "requests", "shed", "retries",
                                "be_quanta")}


def test_serve_matches_reference_counts():
    kw = dict(requests=6, max_new_tokens=3)
    want = jserve.serve("qwen2.5-14b", **kw)
    got = tserve.serve("qwen2.5-14b", device="cpu", **kw)
    assert _counts(got) == _counts(want) == {
        "arch": "qwen2.5-14b", "requests": 6, "shed": 0, "retries": 0,
        "be_quanta": 0}
    assert got["device"] == "cpu"
    assert 0 < got["p50_ms"] <= got["p99_ms"]


def test_serve_chaos_matches_reference_counts(monkeypatch):
    """The outage with every request arrived before it: all are queued when
    the engine goes dark for longer than their timeout, so all are shed,
    in both drivers, whatever the host's speed."""
    def at_once(make):
        def trace(**kw):
            t = make(**kw)
            return type(t)(np.zeros_like(t.arrivals), t.duration)
        return trace

    monkeypatch.setattr(jserve, "maf2_like_trace",
                        at_once(jtraffic.maf2_like_trace))
    monkeypatch.setattr(tserve, "maf2_like_trace",
                        at_once(traffic.maf2_like_trace))
    kw = dict(requests=6, max_new_tokens=3, chaos=True, timeout=0.05,
              stall_s=0.2)
    want = jserve.serve("qwen2.5-14b", **kw)
    got = tserve.serve("qwen2.5-14b", device="cpu", **kw)
    assert _counts(got) == _counts(want) == {
        "arch": "qwen2.5-14b", "requests": 0, "shed": 6, "retries": 0,
        "be_quanta": 0}
    assert math.isnan(got["p99_ms"])


def test_serve_moe_matches_reference_counts():
    kw = dict(requests=4, max_new_tokens=3)
    want = jserve.serve("qwen3-moe-30b-a3b", **kw)
    got = tserve.serve("qwen3-moe-30b-a3b", device="cpu", **kw)
    assert _counts(got) == _counts(want) == {
        "arch": "qwen3-moe-30b-a3b", "requests": 4, "shed": 0,
        "retries": 0, "be_quanta": 0}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_serve_colocate_train_moe_answers_all(arch, monkeypatch):
    """The best-effort trainer of a MoE model (its aux loss in the loss)
    beside the served MoE model, and of the hybrid family (mamba2 and
    attention mixers, MoE every other layer): every request answered,
    idle quanta taken, every BE loss finite."""
    import torch
    made = []

    class Recorded(tserve.BestEffortTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tserve, "BestEffortTrainer", Recorded)
    out = tserve.serve(arch, requests=6, colocate_train=True, device="cpu")
    assert out["requests"] == 6 and out["shed"] == 0
    assert out["be_quanta"] > 0
    (be,) = made
    assert all(torch.isfinite(x) for x in be.losses)


def test_audio_serve_raises_in_both_packages():
    """Neither serving driver serves the audio family: the reference's
    engine prefills without frame embeddings and fails in the encoder;
    the port's engine refuses the model and says why."""
    with pytest.raises(AttributeError):
        jserve.serve("whisper-base", requests=2, max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        tserve.serve("whisper-base", requests=2, max_new_tokens=2,
                     device="cpu")


def test_serve_colocate_train_answers_all():
    """The best-effort trainer beside the served model: every request
    answered, at least one idle quantum taken, every BE loss finite."""
    out = tserve.serve("mamba2-130m", requests=6, colocate_train=True,
                       device="cpu")
    assert out["requests"] == 6 and out["shed"] == 0
    assert out["be_quanta"] > 0


def test_be_quanta_equal_straight_train_steps(monkeypatch):
    """After k quanta of the serving driver's BE job its parameters equal k
    straight train steps of the same model from the same seed (seed + 1)
    on the same batches (``batch_at(0..k-1)`` of the dataset seeded with
    ``seed``), bit for bit on the CPU."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_leaves
    made = []

    class Recorded(tserve.BestEffortTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tserve, "BestEffortTrainer", Recorded)
    out = tserve.serve("qwen2.5-14b", requests=4, max_new_tokens=2,
                       colocate_train=True, seed=3, device="cpu")
    (be,) = made
    k = out["be_quanta"]
    assert k == be.quanta > 0 and len(be.losses) == k
    assert all(torch.isfinite(x) for x in be.losses)
    model = build_model(get_config("qwen2.5-14b").reduced())
    params = model.init(4, device="cpu")
    state = make_optimizer(model.cfg).init(params)
    step = make_train_step(model, make_host_mesh(device="cpu"),
                           ShapeConfig("be", 32, 2, "train")).fn
    ds = SyntheticLMDataset(DataConfig(model.cfg.vocab_size, 32, 2, seed=3))
    for i in range(k):
        batch = {n: torch.as_tensor(v, dtype=torch.long)
                 for n, v in ds.batch_at(i).items()}
        params, state, _ = step(params, state, batch)
    assert int(state.step) == int(be.opt_state.step) == k
    for a, b in zip(tree_leaves(params), tree_leaves(be.params)):
        assert torch.equal(a, b)


def test_main_prints_json(capsys):
    assert tserve.main(["--arch", "mistral-nemo-12b", "--requests", "2",
                        "--max-new-tokens", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "mistral-nemo-12b"
    assert out["requests"] == 2 and out["shed"] == 0
