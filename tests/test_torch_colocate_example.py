"""The port's co-location example (``python -m
repro_torch.colocate_serve_train``) against the reference's scenario
(``repro.launch.serve.serve(..., obs=ObsHub())`` as
``examples/colocate_serve_train.py`` calls it), on the CPU at the reduced
width that ``serve`` runs.

Every request arrives at once (the trace's arrivals set to zero, as in
``tests/test_torch_launch_serve.py``), and both drivers and their engines
read one virtual clock that only the drivers' sleeps advance: the
injected outage costs no wall time, and the counts, the counters and the
latency histograms are the same in both packages whatever the host's
speed, plain, with ``--chaos`` and with ``--chaos --failover``. One run on
the wall clock takes ``serve``'s arguments."""
import types

import numpy as np
import pytest

from repro.core import traffic as jtraffic
from repro.launch import serve as jserve
from repro.obs import ObsHub as JObsHub
from repro.obs import prometheus_text as jprometheus_text
from repro_torch import colocate_serve_train as example
from repro_torch.core import traffic
from repro_torch.launch import serve as tserve
from repro_torch.obs import parse_prometheus_text, prometheus_text

MODES = {"plain": dict(), "chaos": dict(chaos=True),
         "chaos_failover": dict(chaos=True, failover=True)}
FLAGS = {"plain": [], "chaos": ["--chaos"],
         "chaos_failover": ["--chaos", "--failover"]}


def _at_once(make):
    def trace(**kw):
        t = make(**kw)
        return type(t)(np.zeros_like(t.arrivals), t.duration)
    return trace


def _virtual_time(monkeypatch, mod, make_trace):
    """``mod.serve`` on a virtual clock: its loop and its engine read
    ``clock.t``, which only ``sleep`` advances; every arrival at 0."""
    clock = types.SimpleNamespace(t=0.0)

    def sleep(s):
        clock.t += s

    engine = mod.ServingEngine
    monkeypatch.setattr(mod, "maf2_like_trace", _at_once(make_trace))
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock.t, sleep=sleep))
    monkeypatch.setattr(mod, "ServingEngine", lambda *a, **kw: engine(
        *a, clock=lambda: clock.t, **kw))


@pytest.fixture(scope="module")
def reference():
    """The reference's scenario in each mode (run once: its JIT compiles
    take seconds), as the example runs it."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _virtual_time(mp, jserve, jtraffic.maf2_like_trace)
        for mode, kw in MODES.items():
            hub = JObsHub()
            res = jserve.serve("qwen2.5-14b", requests=12, capacity=4,
                               max_new_tokens=6, colocate_train=True,
                               obs=hub, **kw)
            out[mode] = (res, jprometheus_text(hub.registry))
    return out


def _counts(out):
    return {k: out[k] for k in ("arch", "requests", "shed", "retries",
                                "be_quanta")}


EXPECTED = {"plain": dict(requests=12, shed=0, retries=0),
            "chaos": dict(requests=0, shed=12, retries=0),
            "chaos_failover": dict(requests=12, shed=0, retries=12)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_example_matches_reference(reference, mode, monkeypatch, capsys):
    """The example through its command line on ``--device cpu``: the
    reference's counts, counter samples and ``# TYPE`` families, its whole
    exposition byte for byte (the latencies are virtual), and the
    example's printout."""
    hubs = []
    hub_cls = example.ObsHub

    def recorded():
        hubs.append(hub_cls())
        return hubs[-1]

    monkeypatch.setattr(example, "ObsHub", recorded)
    _virtual_time(monkeypatch, tserve, traffic.maf2_like_trace)
    assert example.main([*FLAGS[mode], "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    (hub,) = hubs
    want, want_text = reference[mode]
    text = prometheus_text(hub.registry)
    want_types, want_samples = parse_prometheus_text(want_text)
    types_, samples = parse_prometheus_text(text)
    assert types_ == want_types
    assert {k: v for k, v in samples.items() if k[0].endswith("_total")} \
        == {k: v for k, v in want_samples.items()
            if k[0].endswith("_total")}
    assert text == want_text
    assert _counts(want) == {"arch": "qwen2.5-14b", "be_quanta": 0,
                             **EXPECTED[mode]}
    assert f"served {want['requests']} requests" in out
    assert f"registry view: {want['requests']} requests" in out
    assert '"device": "cpu"' in out
    assert ("tally_serving_requests_total "
            f"{float(want['requests'])!r}") in out.splitlines()
    if mode == "chaos":
        assert "chaos: 12 requests lost, 0 timeout retries (failover off" \
            in out
    if mode == "chaos_failover":
        assert "chaos: 0 requests lost, 12 timeout retries (failover on)" \
            in out
        hedges = {dict(k[1])["outcome"]: v for k, v in samples.items()
                  if k[0] == "tally_serving_hedges_total"}
        assert hedges["spawned"] >= hedges.get("won", 0.0) + hedges.get(
            "lost", 0.0) >= 1.0


def test_example_function_takes_serve_arguments():
    """``colocate_serve_train(**serve_kw)`` on the wall clock and the
    trace's own arrivals, with ``serve``'s arguments overriding the
    example's: every request answered, the trainer's quanta taken before
    the first arrival, and the registry the driver's account."""
    out, hub = example.colocate_serve_train(device="cpu", requests=6,
                                            max_new_tokens=3)
    assert (out["requests"], out["shed"], out["retries"]) == (6, 0, 0)
    assert out["be_quanta"] > 0 and out["device"] == "cpu"
    _, samples = parse_prometheus_text(prometheus_text(hub.registry))
    assert samples[("tally_serving_requests_total", ())] == 6.0
    assert samples[("tally_serving_be_quanta_total", ())] \
        == out["be_quanta"]
    assert samples[("tally_serving_request_latency_seconds_count", ())] == 6
    assert samples[("tally_serving_ttft_seconds_count", ())] == 6
