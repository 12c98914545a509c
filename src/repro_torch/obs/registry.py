"""Process-wide metrics registry: labeled counters, gauges, fixed-bucket
histograms, and time series (the port's copy of ``repro.obs.registry``;
pure Python, held to the original by ``tests/test_torch_obs.py``).

Deterministic by construction: every metric is fed from observation-only
hooks that read clocks the engines already computed, so two runs that
drive the same hook sequence (the port's serving engine and the
reference's, under one injected clock) produce *identical* registry
contents — the exposition text is byte-comparable across packages, which
is how the tests pin the contract. Wall-clock self-profiling is
deliberately kept out of the registry (see ``selfprof.py``) so this
property survives.

Series kinds:

- ``Counter`` / ``Gauge`` — one float cell; hot paths may bump ``.v``
  directly (plain attribute add, same arithmetic as ``inc``).
- ``Histogram`` — fixed upper-bound buckets (Prometheus ``le`` semantics:
  count of observations ``<= le``), with interpolated ``quantile(q)``.
- ``Timeline`` — raw ``(t, v)`` samples, for resampling; JSONL-only (not
  part of the Prometheus exposition).
- ``BinnedSeries`` — pre-binned accumulation onto a fixed grid over a
  known span; O(1) per event, used for per-kernel-rate series where a raw
  timeline would be too hot.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence, Tuple

# Latency-flavoured default buckets (seconds), exponential-ish.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    kind = "counter"
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.v += amount

    @property
    def value(self) -> float:
        return self.v


class Gauge:
    kind = "gauge"
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def set(self, value: float) -> None:
        self.v = value

    def inc(self, amount: float = 1.0) -> None:
        self.v += amount

    @property
    def value(self) -> float:
        return self.v


class Histogram:
    """Fixed-bucket histogram; ``les`` are inclusive upper bounds, with an
    implicit +Inf overflow bucket at ``counts[-1]``."""

    kind = "histogram"
    __slots__ = ("les", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        les = tuple(sorted(float(b) for b in buckets))
        if not les or any(not math.isfinite(b) for b in les):
            raise ValueError("histogram buckets must be finite and non-empty")
        self.les = les
        self.counts = [0] * (len(les) + 1)      # +1: +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.les, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Prometheus-style ``histogram_quantile``: linear interpolation
        inside the bucket holding rank ``q * count``; observations in the
        overflow bucket clamp to the highest finite bound. NaN when empty."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        prev = 0.0
        for le, c in zip(self.les, self.counts):
            if c and cum + c >= target:
                return prev + (le - prev) * (target - cum) / c
            cum += c
            prev = le
        return self.les[-1]

    def bucket_pairs(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count<=le)`` pairs, ending with ``(inf, n)``."""
        out, cum = [], 0
        for le, c in zip(self.les, self.counts):
            cum += c
            out.append((le, cum))
        out.append((math.inf, cum + self.counts[-1]))
        return out


class Timeline:
    kind = "timeline"
    __slots__ = ("ts", "vs")

    def __init__(self):
        self.ts: List[float] = []
        self.vs: List[float] = []

    def append(self, t: float, v: float) -> None:
        self.ts.append(t)
        self.vs.append(v)

    def __len__(self) -> int:
        return len(self.ts)


class BinnedSeries:
    """Accumulates event weights onto ``n_bins`` equal bins over
    ``[0, span]``; events past the span land in the last bin."""

    kind = "binned"
    __slots__ = ("span", "bins", "_inv")

    def __init__(self, span: float, n_bins: int = 240):
        if not (span > 0):
            raise ValueError(f"span must be positive, got {span}")
        self.span = float(span)
        self.bins = [0.0] * int(n_bins)
        self._inv = len(self.bins) / self.span

    def add(self, t: float, v: float) -> None:
        i = int(t * self._inv)
        b = self.bins
        b[i if i < len(b) else len(b) - 1] += v

    def edges(self) -> List[float]:
        w = self.span / len(self.bins)
        return [i * w for i in range(len(self.bins) + 1)]


class Family:
    """All series of one metric name, keyed by label values (in
    ``labelnames`` order). ``labels(**kv)`` memoizes children so hot paths
    resolve a child once and keep the reference."""

    __slots__ = ("name", "help", "kind", "labelnames", "_make", "_children")

    def __init__(self, name: str, help_: str, kind: str,
                 labelnames: Sequence[str], make):
        self.name = name
        self.help = help_
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._make = make
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kv):
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._make()
            self._children[key] = child
        return child

    def child(self, *values: str):
        """Positional variant of ``labels`` (hot-path friendly)."""
        key = tuple(values)
        child = self._children.get(key)
        if child is None:
            child = self._make()
            self._children[key] = child
        return child

    def items(self) -> List[Tuple[Tuple[str, ...], object]]:
        """Children sorted by label values — exposition order is
        independent of creation order (cores may differ there)."""
        return sorted(self._children.items())

    def __len__(self) -> int:
        return len(self._children)


class MetricsRegistry:
    """Registry of metric families. Re-registering an existing name with
    the same kind/labels returns the existing family (idempotent);
    conflicting re-registration raises."""

    def __init__(self):
        self._families: Dict[str, Family] = {}

    def _register(self, name: str, help_: str, kind: str,
                  labelnames: Sequence[str], make) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                    f"{fam.labelnames}, not {kind}{tuple(labelnames)}")
            return fam
        fam = Family(name, help_, kind, labelnames, make)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()) -> Family:
        return self._register(name, help_, "counter", labelnames, Counter)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()) -> Family:
        return self._register(name, help_, "gauge", labelnames, Gauge)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        buckets = tuple(buckets)
        return self._register(name, help_, "histogram", labelnames,
                              lambda: Histogram(buckets))

    def timeline(self, name: str, help_: str = "",
                 labelnames: Sequence[str] = ()) -> Family:
        return self._register(name, help_, "timeline", labelnames, Timeline)

    def binned(self, name: str, help_: str = "",
               labelnames: Sequence[str] = (), *, span: float,
               n_bins: int = 240) -> Family:
        return self._register(name, help_, "binned", labelnames,
                              lambda: BinnedSeries(span, n_bins))

    def get(self, name: str) -> Optional[Family]:
        return self._families.get(name)

    def families(self) -> List[Family]:
        return [self._families[n] for n in sorted(self._families)]
