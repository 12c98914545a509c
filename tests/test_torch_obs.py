"""The port's telemetry hub (``repro_torch.obs``) and latency stats against
the JAX package's (``repro.obs``, ``repro.core.metrics``).

The same seeded inputs and the same event sequences go through both
packages: registry semantics, ``Histogram.quantile`` (``==``, bucket edges
and overflow included), binned series, the audit log, the self-profiler's
sections, the Prometheus and JSONL expositions (byte-equal, and JSONL
written by either package read back by the other), resampling, and
``LatencyStats``. Then the serving engine with a hub: the shed, retry,
hedge and brownout scenarios of ``tests/test_serving.py`` under one fake
clock through the reference's engine with ``repro.obs.ObsHub`` and the
port's with ``repro_torch.obs.ObsHub`` give byte-equal ``prometheus_text``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.configs import get_config as jget_config
from repro.core import metrics as jmetrics
from repro.models.transformer import build_model as jbuild_model
from repro.serving import (BrownoutPolicy as JBrownout,
                           HedgePolicy as JHedge, RetryPolicy as JRetry,
                           ServingConfig as JServingConfig,
                           ServingEngine as JServingEngine)
import repro_torch.obs as tobs
from repro_torch.configs import get_config
from repro_torch.core import metrics as tmetrics
from repro_torch.models.transformer import build_model
from repro_torch.serving import (BrownoutPolicy, HedgePolicy, RetryPolicy,
                                 ServingConfig, ServingEngine)
from repro_torch.weights import params_from_jax

PKGS = pytest.mark.parametrize("pkg", [jobs, tobs], ids=["jax", "port"])


# ---------------------------------------------------------------------------
# Registry primitives, each package on its own, then against each other
# ---------------------------------------------------------------------------


@PKGS
def test_label_families_and_registration(pkg):
    r = pkg.MetricsRegistry()
    c = r.counter("reqs_total", "requests", ("device",))
    c.labels(device=0).inc()
    c.labels(device=0).inc(2.0)
    c.child("1").inc()
    assert c.labels(device=0).value == 3.0 and c.child("1").value == 1.0
    assert [k for k, _ in c.items()] == [("0",), ("1",)] and len(c) == 2
    assert r.counter("reqs_total", "other help", ("device",)) is c
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("reqs_total", "", ("device",))
    with pytest.raises(ValueError, match="already registered"):
        r.counter("reqs_total", "", ("device", "job"))
    with pytest.raises(ValueError, match="finite and non-empty"):
        pkg.Histogram(())
    with pytest.raises(ValueError, match="finite and non-empty"):
        pkg.Histogram((1.0, math.inf))
    h = pkg.Histogram((1.0, 2.0))
    for v in (0.5, 1.0, 2.0, 7.0, 9.0):       # edges inclusive, 2 overflow
        h.observe(v)
    assert h.counts == [2, 1, 2] and h.count == 5 and h.sum == 19.5
    assert h.bucket_pairs() == [(1.0, 2), (2.0, 3), (math.inf, 5)]
    assert h.quantile(0.99) == 2.0            # overflow clamps to the top
    assert math.isnan(pkg.Histogram().quantile(0.5))
    assert [f.name for f in r.families()] == ["reqs_total"]


def _samples(seed):
    """Latency-like samples: exponential, every default bucket edge, and
    values past the last bucket (overflow)."""
    rng = np.random.default_rng(seed)
    xs = list(rng.exponential(0.05, size=200)) + list(
        jobs.DEFAULT_BUCKETS) + list(rng.uniform(10.0, 50.0, size=7))
    rng.shuffle(xs)
    return [float(x) for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantile_equals_reference(seed):
    assert tobs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    xs = _samples(seed)
    for buckets in (jobs.DEFAULT_BUCKETS, (0.01, 0.02, 0.5)):
        want, got = jobs.Histogram(buckets), tobs.Histogram(buckets)
        for x in xs[:50 * (seed + 1)]:
            want.observe(x)
            got.observe(x)
        assert got.counts == want.counts and got.sum == want.sum
        for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
            assert got.quantile(q) == want.quantile(q), (buckets, q)


def test_binned_series_equals_reference():
    rng = np.random.default_rng(3)
    ts = rng.uniform(0.0, 12.0, size=300)          # some past the span
    vs = rng.exponential(size=300)
    want, got = jobs.BinnedSeries(10.0, 24), tobs.BinnedSeries(10.0, 24)
    for t, v in zip(ts, vs):
        want.add(float(t), float(v))
        got.add(float(t), float(v))
    assert got.bins == want.bins and got.edges() == want.edges()
    assert got.bins[-1] > 0.0 and len(got.bins) == 24
    c_want, r_want = jobs.binned_rate(want)
    c_got, r_got = tobs.binned_rate(got)
    np.testing.assert_array_equal(c_got, c_want)
    np.testing.assert_array_equal(r_got, r_want)
    for pkg in (jobs, tobs):
        with pytest.raises(ValueError, match="span must be positive"):
            pkg.BinnedSeries(0.0)


# ---------------------------------------------------------------------------
# Audit log and self-profiler
# ---------------------------------------------------------------------------


def _audit(pkg, capacity):
    log = pkg.AuditLog(capacity=capacity)
    for i in range(7):
        log.record(0.5 * i, "placement" if i % 2 else "slo_check",
                   f"job{i % 3}", i % 2, window_p99=0.1 * i, bound=0.3,
                   candidates=[[i, 0.25]])
    log.record(4.0, "migration", "job1", 1, dst=0, disruption={"a": 1.5})
    return log


@pytest.mark.parametrize("capacity", [None, 3])
def test_audit_log_equals_reference(capacity):
    want, got = _audit(jobs, capacity), _audit(tobs, capacity)
    assert (len(got), got.total, got.dropped) == (
        len(want), want.total, want.dropped)
    if capacity:
        assert got.dropped == 5 and len(got) == 3
    assert got.fingerprint() == want.fingerprint()
    for kw in (dict(kind="placement"), dict(job="job1"), dict(device=0),
               dict(kind="slo_check", device=0)):
        assert [r.to_dict() for r in got.filter(**kw)] \
            == [r.to_dict() for r in want.filter(**kw)]
    assert [r.to_dict() for r in got.why("job1")] \
        == [r.to_dict() for r in want.why("job1")]
    assert [r.to_dict() for r in got.why("job1", t=4.0)] \
        == [r.to_dict() for r in want.why("job1", t=4.0)]
    text = want.to_jsonl()
    assert got.to_jsonl() == text
    # written by one package, read back byte-equal by the other
    assert tobs.AuditLog.from_jsonl(text, capacity).to_jsonl() == text
    assert jobs.AuditLog.from_jsonl(got.to_jsonl()).to_jsonl() == text


def test_audit_jsonl_file_round_trip(tmp_path):
    log = _audit(tobs, None)
    path = tmp_path / "audit.jsonl"
    text = log.to_jsonl(str(path))
    assert path.read_text() == text
    assert jobs.AuditLog.from_jsonl(str(path)).fingerprint() \
        == log.fingerprint()


@PKGS
def test_selfprofiler_sections(pkg):
    p = pkg.SelfProfiler()
    p.start()
    p.push("outer")
    p.push("inner")
    p.pop()
    p.push("inner")
    p.stop()                                  # closes what is still open
    rep = p.report()
    assert sorted(rep) == ["frac_inner", "frac_outer", "inner_s", "other_s",
                           "outer_s", "total_s"]
    assert rep["inner_s"] >= 0.0 and rep["outer_s"] >= 0.0
    assert rep["inner_s"] + rep["outer_s"] + rep["other_s"] \
        == pytest.approx(rep["total_s"])


# ---------------------------------------------------------------------------
# The hub and the expositions on one event sequence
# ---------------------------------------------------------------------------


def _drive(pkg, seed=0):
    """Every ObsHub hook, the same calls in both packages."""
    rng = np.random.default_rng(seed)
    hub = pkg.ObsHub()
    sp = hub.serving()
    for d in (0, 1):
        p = hub.for_device(d)
        p.bind(20.0 + d)
        p.residency(0.0, "bert", 0, 1.0)
        for i in range(25):
            t = float(rng.uniform(0.0, 25.0))
            p.arrival(t)
            p.request_done(t, float(rng.exponential(0.02)), 1.0)
            p.iteration(t, "gpt2" if i % 3 else "resnet",
                        float(rng.integers(1, 64)))
            if i % 7 == 0:
                p.preempt(t)
                p.profiled("matmul")
            p.occupancy(t, 0.1 * i, 0.05 * i)
        p.finalize(25.0, 3.25, 7.5, 25.0, 2.0)
    snap = [[0, 0.5, 0.25], [1, 0.75, 0.0]]
    hub.placement(0.0, "bert", "hp", 0, snap)
    hub.admission_reject(1.0, "gpt2", "be", 3, snap)
    hub.admission_reject(1.0, "gpt2", "be", 3, snap)      # deduped
    hub.slo_check(2.0, 0, "bert", 0.021, 0.02, 50, True)
    hub.migration(2.0, "gpt2", 0, 1, "bert", 0.021, 0.02, 50,
                  {"lost_s": 0.125}, snap)
    hub.migration_blocked(3.0, "resnet", 1, "bert", 0.03, 0.02, 50)
    hub.device_failure(4.0, 1, ["gpt2"])
    hub.departure(5.0, "resnet", 0)
    hub.device_stall(6.0, 0, 6.5, [])
    hub.device_recover(6.5, 0, "stall_end")
    hub.requeue(6.0, "gpt2", 1, "failure", 1, 6.25, 0.5, None)
    hub.quarantine(7.0, 1, 3, 9.0)
    hub.shed(8.0, "resnet", "be", "overload")
    hub.be_preempt(8.5, 0, ["gpt2"], "storm")
    hub.failover(9.0, "bert", 0, "failure", 3, 4, 1)
    hub.failover_restore(9.5, "bert", 1, True, 0.5, 3, 4)
    for i in range(12):
        sp.admitted(float(rng.exponential(0.1)))
        sp.retired(float(rng.exponential(0.3)))
        sp.slots(float(i % 4))
    for where in ("queued", "slot", "queued", "brownout"):
        sp.shed_request(where)
    sp.be_quantum()
    sp.retry()
    for outcome in ("spawned", "won", "spawned", "lost"):
        sp.hedge(outcome)
    sp.brownout("enter")
    sp.brownout("exit")
    return hub


def test_hub_exposition_equals_reference():
    want, got = _drive(jobs), _drive(tobs)
    text = jobs.prometheus_text(want.registry)
    assert tobs.prometheus_text(got.registry) == text
    assert tobs.to_jsonl(got.registry) == jobs.to_jsonl(want.registry)
    assert got.audit.fingerprint() == want.audit.fingerprint()
    assert got.audit.to_jsonl() == want.audit.to_jsonl()
    assert tobs.parse_prometheus_text(text) == jobs.parse_prometheus_text(
        text)
    # the exposition reproduces every sample of the registry
    types, samples = tobs.parse_prometheus_text(text)
    lat = got.registry.get("tally_serving_request_latency_seconds").child()
    assert samples[("tally_serving_request_latency_seconds_sum", ())] \
        == lat.sum
    assert samples[("tally_serving_sheds_total", (("where", "queued"),))] \
        == 2.0
    assert types["tally_hp_request_latency_seconds"] == "histogram"
    assert len(types) == len([f for f in got.registry.families()
                              if f.kind in ("counter", "gauge",
                                            "histogram")])


def test_fresh_hubs_register_the_same_families():
    want, got = jobs.ObsHub(), tobs.ObsHub()
    want.serving()
    got.serving()
    assert [(f.name, f.kind, f.labelnames, f.help)
            for f in got.registry.families()] \
        == [(f.name, f.kind, f.labelnames, f.help)
            for f in want.registry.families()]
    assert tobs.prometheus_text(got.registry) \
        == jobs.prometheus_text(want.registry)
    # JSONL has a line per child: a family without one comes back without
    # its # HELP / # TYPE lines, in both packages alike
    for pkg, hub in ((jobs, want), (tobs, got)):
        back = pkg.prometheus_text(pkg.registry_from_jsonl(
            pkg.to_jsonl(hub.registry)))
        assert "# TYPE tally_serving_requests_total counter" in back
        assert "tally_serving_sheds_total" not in back


def test_jsonl_read_back_by_the_other_package(tmp_path):
    """A registry written with ``to_jsonl`` by one package reads back with
    the other's ``registry_from_jsonl`` and gives byte-equal text, in both
    directions; timelines and binned series travel too."""
    want, got = _drive(jobs, 1), _drive(tobs, 1)
    j_text = jobs.to_jsonl(want.registry)
    t_text = tobs.to_jsonl(got.registry, str(tmp_path / "reg.jsonl"))
    assert (tmp_path / "reg.jsonl").read_text() == t_text == j_text
    assert tobs.from_jsonl(j_text) == jobs.from_jsonl(j_text)
    into_port = tobs.registry_from_jsonl(j_text)
    into_ref = jobs.registry_from_jsonl(t_text)
    assert tobs.to_jsonl(into_port) == j_text
    assert jobs.to_jsonl(into_ref) == t_text
    assert tobs.prometheus_text(into_port) \
        == jobs.prometheus_text(want.registry)
    assert jobs.prometheus_text(into_ref) \
        == tobs.prometheus_text(got.registry)
    with pytest.raises(ValueError, match="unknown metric kind"):
        tobs.registry_from_jsonl('{"name": "x", "kind": "bogus", '
                                 '"labels": {}}\n')


@pytest.mark.parametrize("kind", ["previous", "linear", "sum", "rate"])
def test_resample_equals_reference(kind):
    hub = _drive(tobs)
    tl = hub.registry.get("tally_hp_request_latency_series").child("0")
    order = np.argsort(tl.ts, kind="stable")
    ts = list(np.asarray(tl.ts)[order])
    vs = list(np.asarray(tl.vs)[order])
    grid = np.linspace(-1.0, 26.0, 40)
    np.testing.assert_array_equal(tobs.resample(ts, vs, grid, kind),
                                  jobs.resample(ts, vs, grid, kind))
    np.testing.assert_array_equal(tobs.resample([], [], grid[:3], kind),
                                  jobs.resample([], [], grid[:3], kind))


def test_resample_errors_match_reference():
    for pkg in (jobs, tobs):
        with pytest.raises(ValueError, match=">= 2 grid points"):
            pkg.resample([0.0], [1.0], [0.0], "sum")
        with pytest.raises(ValueError, match="unknown resample kind"):
            pkg.resample([0.0], [1.0], [0.0, 1.0], "mean")


# ---------------------------------------------------------------------------
# LatencyStats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ideal", [0.02, 1.0, 0.0, -1.0, math.nan,
                                   math.inf, None])
def test_latency_stats_overhead_vs(ideal):
    xs = np.random.default_rng(0).exponential(0.05, size=41)
    want, got = jmetrics.LatencyStats(), tmetrics.LatencyStats()
    for x in xs:
        want.record(x)
        got.record(x)
    assert got.count == want.count == 41
    assert got.mean() == want.mean()
    if ideal is None:           # the isolated run answered nothing
        ideal = tmetrics.LatencyStats().p99()
        assert math.isnan(tmetrics.LatencyStats().mean())
        assert tmetrics.LatencyStats().count == 0
    w, g = want.overhead_vs(ideal), got.overhead_vs(ideal)
    if ideal > 0.0 and math.isfinite(ideal):
        assert g == w == got.p99() / ideal - 1.0
    else:
        assert math.isnan(g) and math.isnan(w)


# ---------------------------------------------------------------------------
# The serving engine with a hub, both packages under one fake clock
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module", params=["qwen2.5-14b", "mamba2-130m"])
def engines(request):
    """Makers of the reference's and the port's engine on the same reduced
    model and parameters (f32)."""
    arch = request.param
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               dtype=jnp.float32)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ref = dict(obs=jobs, engine=JServingEngine, config=JServingConfig,
               retry=JRetry, hedge=JHedge, brownout=JBrownout,
               model=jmodel, params=jparams)
    port = dict(obs=tobs, engine=ServingEngine, config=ServingConfig,
                retry=RetryPolicy, hedge=HedgePolicy,
                brownout=BrownoutPolicy, model=model, params=params)
    return ref, port


def _shed(m, clk, eng_kw):
    eng = m["engine"](m["model"], m["params"],
                      m["config"](capacity=1, max_len=48,
                                  request_timeout=2.0), clock=clk, **eng_kw)
    p = np.arange(4, dtype=np.int32)
    eng.submit(p, max_new_tokens=40)
    eng.submit(p, max_new_tokens=2)
    eng.step()
    clk.t = 1.25
    eng.step()
    clk.t = 2.5
    eng.step()                           # one evicted, one shed queued
    eng.submit(p, max_new_tokens=3, timeout=10.0)
    clk.t = 3.0
    eng.run_until_idle()
    return eng


def _retry(m, clk, eng_kw):
    eng = m["engine"](m["model"], m["params"],
                      m["config"](capacity=1, max_len=48), clock=clk,
                      retry=m["retry"](max_retries=1, backoff_base=1.0,
                                       jitter=0.25), **eng_kw)
    p = np.arange(4, dtype=np.int32)
    eng.submit(p, max_new_tokens=6)
    eng.step()
    r = eng.submit(p, max_new_tokens=2, timeout=2.0)
    gone = eng.submit(p, max_new_tokens=2, timeout=1.0)
    clk.t = 3.0                          # both expire: retry #1
    eng.step()
    while eng.n_active:
        eng.step()
    clk.t = 4.5                          # both gates open: EDF admits one
    eng.step()
    clk.t = 20.0                         # the other's re-armed deadline
    eng.run_until_idle()                 # blown: retries exhausted, shed
    assert {r.shed, gone.shed} == {True, False}
    return eng


def _hedge_primary(m, clk, eng_kw):
    eng = m["engine"](m["model"], m["params"],
                      m["config"](capacity=2, max_len=48), clock=clk,
                      hedge=m["hedge"](min_delay=1.0, max_hedges=1),
                      **eng_kw)
    p = np.arange(4, dtype=np.int32)
    eng.submit(p, max_new_tokens=3)
    eng.submit(p, max_new_tokens=3)
    eng.step()
    eng.submit(p, max_new_tokens=2)
    clk.t = 2.0
    eng.step()
    clk.t = 2.5
    eng.run_until_idle()
    return eng


def _hedge_clone(m, clk, eng_kw):
    eng = m["engine"](m["model"], m["params"],
                      m["config"](capacity=1, max_len=48), clock=clk,
                      retry=m["retry"](max_retries=3, backoff_base=50.0,
                                       backoff_max=100.0, jitter=0.0),
                      hedge=m["hedge"](min_delay=1.0, max_hedges=1),
                      **eng_kw)
    p = np.arange(4, dtype=np.int32)
    eng.submit(p, max_new_tokens=10)
    eng.step()
    eng.submit(p, max_new_tokens=2, timeout=2.0)
    clk.t = 3.0
    eng.step()
    clk.t = 5.0
    eng.step()
    while eng.n_active:
        eng.step()
    clk.t = 6.0
    eng.run_until_idle()
    return eng


def _brownout(m, clk, eng_kw):
    eng = m["engine"](m["model"], m["params"],
                      m["config"](capacity=2, max_len=48), clock=clk,
                      retry=m["retry"](max_retries=3, backoff_base=0.1,
                                       jitter=0.0),
                      brownout=m["brownout"](queue_delay=1.0,
                                             min_capacity=1, exit_delay=0.5),
                      best_effort_hook=lambda: None, **eng_kw)
    p = np.arange(4, dtype=np.int32)
    eng.submit(p, max_new_tokens=2, timeout=2.0)
    eng.submit(p, max_new_tokens=2, timeout=50.0)
    eng.submit(p, max_new_tokens=2)
    eng.submit(p, max_new_tokens=2)
    clk.t = 1.5
    eng.step()
    clk.t = 1.75
    eng.run_until_idle()
    eng.step()                           # exit brownout
    eng.step()                           # idle: one BE quantum
    return eng


SCENARIOS = {"shed": _shed, "retry": _retry, "hedge_primary_wins":
             _hedge_primary, "hedge_clone_wins": _hedge_clone,
             "brownout": _brownout}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_exposition_byte_equal_to_reference(engines, scenario):
    texts, hubs = [], []
    for m in engines:
        hub = m["obs"].ObsHub()
        eng = SCENARIOS[scenario](m, _FakeClock(), dict(obs=hub))
        texts.append(m["obs"].prometheus_text(hub.registry))
        hubs.append((hub, eng))
    want, got = texts
    assert got == want
    hub, eng = hubs[1]
    types, samples = tobs.parse_prometheus_text(got)
    fired = {
        "shed": ("tally_serving_sheds_total", (("where", "slot"),)),
        "retry": ("tally_serving_retries_total", ()),
        "hedge_primary_wins": ("tally_serving_hedges_total",
                               (("outcome", "lost"),)),
        "hedge_clone_wins": ("tally_serving_hedges_total",
                             (("outcome", "won"),)),
        "brownout": ("tally_serving_brownout_transitions_total",
                     (("state", "exit"),)),
    }[scenario]
    assert samples[fired] >= 1.0
    # the registry is the engine's account
    assert samples[("tally_serving_requests_total", ())] == len(eng.done)
    lat = hub.registry.get("tally_serving_request_latency_seconds").child()
    assert lat.count == len(eng.done)
    assert lat.sum == sum(r.latency for r in eng.done)
    assert samples.get(("tally_serving_be_quanta_total", ()), 0.0) \
        == eng.be_quanta
    assert sum(v for (name, _), v in samples.items()
               if name == "tally_serving_sheds_total") \
        == len(eng.shed_requests)
    assert samples[("tally_serving_retries_total", ())] == sum(
        r.attempt for r in eng.done + eng.shed_requests)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 10 (e) under a fake clock: an outage with failover
# ---------------------------------------------------------------------------

# phase 10's traffic and budget: 12 requests of 6 new tokens at ``drive``'s
# arrivals, a 6 s request budget, an outage of 1.5 budgets once half the
# requests are in, a BE quantum of 0.45 s (phase 10 measures 0.4-0.5 s on
# the H100); each prefill and decode step advances the clock by its cost
E_REQUESTS, E_NEW, E_TIMEOUT, E_QUANTUM = 12, 6, 6.0, 0.45
# (prefill s, decode step s): "one" keeps every first retry inside its
# re-armed budget; "two" makes the retried requests and their hedge clones
# (which race each other slot for slot) outlast it, so the last pairs time
# out a second time, the engine idles behind their backoff and takes a
# second BE quantum, as the failing card runs did (2 quanta, 2 or 4 shed)
E_COSTS = {"one": (0.1, 0.05), "two": (0.2, 0.05)}


def _failover(m, timeout, capacity):
    """``launch.serve.failover_policies`` in package ``m``'s classes."""
    return dict(retry=m["retry"](max_retries=3, backoff_base=0.1,
                                 backoff_factor=2.0, jitter=0.25),
                hedge=m["hedge"](min_delay=timeout / 2),
                brownout=m["brownout"](queue_delay=3.0 * timeout,
                                       min_capacity=max(1, capacity // 2),
                                       exit_delay=1.5 * timeout))


def _outage_with_failover(m, prefill_s, decode_s):
    """``launch.serve.drive(chaos=True)``'s loop on a fake clock: the
    arrivals of ``maf2_like_trace``, the prompt draw, the outage."""
    from repro_torch.core.traffic import maf2_like_trace
    clk, quanta, capacity = _FakeClock(), [], 4

    def be():
        quanta.append(clk.t)
        clk.t += E_QUANTUM

    eng = m["engine"](m["model"], m["params"],
                      m["config"](capacity=capacity, max_len=48,
                                  request_timeout=E_TIMEOUT),
                      clock=clk, best_effort_hook=be,
                      **_failover(m, E_TIMEOUT, capacity))

    def costs(fn, s):
        def call(*a):
            clk.t += s
            return fn(*a)
        return call

    eng._prefill = costs(eng._prefill, prefill_s)
    eng._decode = costs(eng._decode, decode_s)
    rng = np.random.default_rng(0)
    arrivals = maf2_like_trace(duration=E_REQUESTS / 50.0 * 2,
                               mean_rate=50.0, seed=0).arrivals[:E_REQUESTS]
    submitted, stall_after = 0, E_REQUESTS // 2
    while submitted < E_REQUESTS or eng.queue or eng.n_active:
        while submitted < E_REQUESTS and arrivals[submitted] <= clk.t:
            prompt = rng.integers(0, m["model"].cfg.vocab_size,
                                  size=int(rng.integers(4, 12)))
            eng.submit(prompt.astype(np.int32), max_new_tokens=E_NEW)
            submitted += 1
        if stall_after is not None and submitted >= stall_after:
            stall_after = None
            clk.t += 1.5 * E_TIMEOUT
        if not eng.step():
            clk.t += 0.001
    return eng, quanta


def test_failover_policies_are_the_scripts():
    from repro_torch.launch.serve import failover_policies
    port = dict(retry=RetryPolicy, hedge=HedgePolicy,
                brownout=BrownoutPolicy)
    assert failover_policies(E_TIMEOUT, 4) == tuple(
        _failover(port, E_TIMEOUT, 4).values())


@pytest.mark.parametrize("quanta", sorted(E_COSTS))
def test_outage_with_failover_sheds_no_hedge_clone(engines, quanta):
    """Phase 10 (e)'s flake, reproduced: when the retried requests and
    their clones outlast the re-armed budget, a primary and its clone time
    out in one pass (a clone keeps the deadline its primary had when it
    spawned). The reference's engine sheds the clone, so (e) counts a shed
    although all 12 requests are answered; the port withdraws it, and the
    primary's second retry answers the request (ROADMAP Queue 3)."""
    want = 1 if quanta == "one" else 2
    runs = {label: _outage_with_failover(m, *E_COSTS[quanta])
            for label, m in zip(("reference", "port"), engines)}
    for label, (eng, q) in runs.items():
        print(f"{quanta} quantum: {label} answered {len(eng.done)}, "
              f"retries {sum(r.attempt for r in eng.done + eng.shed_requests)}"
              f", BE quanta at {[round(t, 3) for t in q]}, shed "
              + str([dict(rid=r.rid, hedge_of=r.hedge_of, attempt=r.attempt,
                          deadline=round(r.deadline, 3),
                          shed_at=round(r.done_t, 3))
                     for r in eng.shed_requests]))
        assert len(eng.done) == E_REQUESTS
        assert len(q) == want
    ref, port = runs["reference"][0], runs["port"][0]
    assert port.shed_requests == []
    if quanta == "one":
        assert ref.shed_requests == []
        return
    # every entry the reference sheds is a clone that never retried, shed
    # at its deadline, whose primary was answered after a second retry
    assert len(ref.shed_requests) == 2
    answered = {r.rid: r for r in ref.done}
    for clone in ref.shed_requests:
        assert clone.hedge_of is not None and clone.attempt == 0
        assert clone.done_t >= clone.deadline
        assert answered[clone.hedge_of].attempt == 2
    # the port answers the same requests with the same retries
    assert sorted((r.rid, r.attempt) for r in port.done) == sorted(
        (r.rid, r.attempt) for r in ref.done)
