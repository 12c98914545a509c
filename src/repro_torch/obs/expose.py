"""Exposition: Prometheus text format, JSONL, and grid resampling (the
port's copy of ``repro.obs.expose``).

Values are formatted with ``repr`` (shortest round-trip float text), so
``parse_prometheus_text(prometheus_text(reg))`` recovers every sample
exactly and two registries are byte-comparable through their expositions
(the cross-package equality tests rely on this). Timelines and binned
series are not Prometheus types; they travel through the JSONL form,
which ``registry_from_jsonl`` can reconstruct losslessly — also from a
dump that the reference wrote.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .registry import (BinnedSeries, Counter, Gauge, Histogram,
                       MetricsRegistry, Timeline)

_PROM_KINDS = ("counter", "gauge", "histogram")


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(names: Sequence[str], values: Sequence[str],
              extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_esc(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_esc(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus/OpenMetrics-style text exposition (counters, gauges,
    histograms; families and children in sorted order)."""
    lines: List[str] = []
    for fam in registry.families():
        if fam.kind not in _PROM_KINDS:
            continue
        if fam.help:
            lines.append(f"# HELP {fam.name} {_esc(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for values, child in fam.items():
            if fam.kind == "histogram":
                for le, cum in child.bucket_pairs():
                    ls = _labelstr(fam.labelnames, values,
                                   (("le", _fmt(le)),))
                    lines.append(f"{fam.name}_bucket{ls} {cum}")
                ls = _labelstr(fam.labelnames, values)
                lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
                lines.append(f"{fam.name}_count{ls} {child.count}")
            else:
                ls = _labelstr(fam.labelnames, values)
                lines.append(f"{fam.name}{ls} {_fmt(child.v)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(r'^([A-Za-z_:][A-Za-z0-9_:]*)(\{(.*)\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unesc(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _parse_val(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)


def parse_prometheus_text(text: str) -> Tuple[Dict[str, str], Dict]:
    """Parse the text exposition back. Returns ``(types, samples)`` where
    ``types`` maps family name -> kind and ``samples`` maps
    ``(sample_name, ((label, value), ...))`` -> float."""
    types: Dict[str, str] = {}
    samples: Dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, _, labelbody, value = m.groups()
        labels = tuple((k, _unesc(v))
                       for k, v in _LABEL_RE.findall(labelbody or ""))
        samples[(name, labels)] = _parse_val(value)
    return types, samples


# -- JSONL (all kinds, lossless) --------------------------------------------


def to_jsonl(registry: MetricsRegistry, path: Optional[str] = None) -> str:
    """One JSON object per (family, child): full state for every kind,
    including timelines and binned series. Lossless and deterministic
    (sorted family/child order)."""
    lines = []
    for fam in registry.families():
        for values, child in fam.items():
            d = {"name": fam.name, "kind": fam.kind, "help": fam.help,
                 "labels": dict(zip(fam.labelnames, values))}
            if fam.kind in ("counter", "gauge"):
                d["value"] = child.v
            elif fam.kind == "histogram":
                d["buckets"] = list(child.les)
                d["counts"] = list(child.counts)
                d["sum"] = child.sum
                d["count"] = child.count
            elif fam.kind == "timeline":
                d["ts"] = child.ts
                d["vs"] = child.vs
            elif fam.kind == "binned":
                d["span"] = child.span
                d["bins"] = child.bins
            lines.append(json.dumps(d, sort_keys=True))
    text = "\n".join(lines) + ("\n" if lines else "")
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def from_jsonl(text: str) -> List[Dict]:
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def registry_from_jsonl(text: str) -> MetricsRegistry:
    """Reconstruct a ``MetricsRegistry`` from its JSONL exposition;
    ``to_jsonl(registry_from_jsonl(t)) == t`` for any registry dump."""
    reg = MetricsRegistry()
    for d in from_jsonl(text):
        name, kind, help_ = d["name"], d["kind"], d.get("help", "")
        labelnames = tuple(sorted(d["labels"]))
        # label order: JSONL stores a dict; families are rebuilt with
        # sorted label names, values resolved by name (order-insensitive)
        if kind == "counter":
            fam = reg.counter(name, help_, labelnames)
        elif kind == "gauge":
            fam = reg.gauge(name, help_, labelnames)
        elif kind == "histogram":
            fam = reg.histogram(name, help_, labelnames,
                                buckets=d["buckets"])
        elif kind == "timeline":
            fam = reg.timeline(name, help_, labelnames)
        elif kind == "binned":
            fam = reg.binned(name, help_, labelnames, span=d["span"],
                             n_bins=len(d["bins"]))
        else:
            raise ValueError(f"unknown metric kind {kind!r}")
        child = fam.labels(**d["labels"])
        if kind in ("counter", "gauge"):
            child.v = d["value"]
        elif kind == "histogram":
            child.counts = list(d["counts"])
            child.sum = d["sum"]
            child.count = d["count"]
        elif kind == "timeline":
            child.ts = list(d["ts"])
            child.vs = list(d["vs"])
        elif kind == "binned":
            child.bins = list(d["bins"])
    return reg


# -- resampling --------------------------------------------------------------


def resample(ts: Sequence[float], vs: Sequence[float],
             grid: Sequence[float], kind: str = "previous",
             fill: float = 0.0) -> np.ndarray:
    """Resample an irregular ``(ts, vs)`` series onto ``grid``.

    ``previous`` — step-hold of the last sample at or before each grid
    point (``fill`` before the first sample); ``linear`` — linear
    interpolation (endpoints clamped); ``sum`` — event weights summed into
    the grid bins ``[grid[i], grid[i+1])`` (returns ``len(grid)-1``
    values); ``rate`` — like ``sum`` divided by the bin widths.
    """
    ts = np.asarray(ts, dtype=float)
    vs = np.asarray(vs, dtype=float)
    grid = np.asarray(grid, dtype=float)
    if kind == "previous":
        if len(ts) == 0:
            return np.full(len(grid), fill)
        idx = np.searchsorted(ts, grid, side="right") - 1
        out = np.where(idx >= 0, vs[np.clip(idx, 0, None)], fill)
        return out
    if kind == "linear":
        if len(ts) == 0:
            return np.full(len(grid), fill)
        return np.interp(grid, ts, vs)
    if kind in ("sum", "rate"):
        if len(grid) < 2:
            raise ValueError("sum/rate resampling needs >= 2 grid points")
        idx = np.clip(np.searchsorted(grid, ts, side="right") - 1,
                      0, len(grid) - 2)
        out = np.zeros(len(grid) - 1)
        if len(ts):
            np.add.at(out, idx, vs)
        if kind == "rate":
            out = out / np.diff(grid)
        return out
    raise ValueError(f"unknown resample kind {kind!r}")


def binned_rate(b: BinnedSeries) -> Tuple[np.ndarray, np.ndarray]:
    """(bin centers, per-second rates) of a pre-binned series."""
    edges = np.asarray(b.edges())
    centers = (edges[:-1] + edges[1:]) / 2
    width = b.span / len(b.bins)
    return centers, np.asarray(b.bins) / width


__all__ = ["prometheus_text", "parse_prometheus_text", "to_jsonl",
           "from_jsonl", "registry_from_jsonl", "resample", "binned_rate",
           "Counter", "Gauge", "Histogram", "Timeline", "BinnedSeries"]
