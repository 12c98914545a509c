"""Latency metrics (the port's copy of the part of ``repro.core.metrics``
that the serving engine, the driver and the co-location example use; pure
numpy)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


@dataclass
class LatencyStats:
    """Request latency accounting for one inference workload."""

    latencies: List[float] = field(default_factory=list)

    def record(self, latency: float) -> None:
        self.latencies.append(float(latency))

    @property
    def count(self) -> int:
        return len(self.latencies)

    def p50(self) -> float:
        return percentile(self.latencies, 50.0)

    def p99(self) -> float:
        return percentile(self.latencies, 99.0)

    def mean(self) -> float:
        return float(np.mean(self.latencies)) if self.latencies else float("nan")

    def overhead_vs(self, ideal_p99: float) -> float:
        """Fractional p99 overhead vs isolated execution (paper's headline).
        Degenerate references (no isolated requests, zero/NaN p99) report
        ``nan`` instead of raising or emitting ``inf``."""
        if not ideal_p99 > 0.0 or not math.isfinite(ideal_p99):
            return float("nan")
        return self.p99() / ideal_p99 - 1.0
