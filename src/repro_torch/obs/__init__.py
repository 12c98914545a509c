"""Live telemetry (the port's copy of ``repro.obs``; pure Python and
numpy, held to the original by ``tests/test_torch_obs.py``).

==============  ============================================================
Module          Provides
==============  ============================================================
``registry``    ``MetricsRegistry`` — labeled counters / gauges /
                fixed-bucket histograms / timelines / binned series
``audit``       ``AuditLog`` — structured decision log with a
                flight-recorder ring mode and "why was X moved" queries
``probes``      ``ObsHub`` / ``DeviceProbe`` / ``ServingProbe`` — the
                opt-in hook surface (``obs=`` of ``ServingEngine`` and
                ``serve``)
``expose``      Prometheus-text + JSONL exposition (exact round trip, also
                across packages), grid resampling
``selfprof``    ``SelfProfiler`` — wall-clock accounting of a run
                (excluded from the determinism contract)
==============  ============================================================

The reference's ``render_dashboard`` draws a fleet simulator's result;
the simulator is not ported, so neither is the dashboard.

Contract: opt-in — every engine call site is guarded by ``obs is None``,
so a bare run pays nothing; observation-only — hooks read
already-computed clocks and never feed back; under one injected clock the
port's serving engine and the reference's drive identical hook sequences,
so their ``prometheus_text`` is byte-identical.
"""
from .audit import AuditLog, AuditRecord
from .expose import (binned_rate, from_jsonl, parse_prometheus_text,
                     prometheus_text, registry_from_jsonl, resample,
                     to_jsonl)
from .probes import DeviceProbe, ObsHub, ServingProbe
from .registry import (DEFAULT_BUCKETS, BinnedSeries, Counter, Gauge,
                       Histogram, MetricsRegistry, Timeline)
from .selfprof import SelfProfiler

__all__ = [
    "AuditLog", "AuditRecord", "binned_rate",
    "from_jsonl", "parse_prometheus_text", "prometheus_text",
    "registry_from_jsonl", "resample", "to_jsonl", "DeviceProbe", "ObsHub",
    "ServingProbe",
    "DEFAULT_BUCKETS", "BinnedSeries", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "Timeline", "SelfProfiler",
]
