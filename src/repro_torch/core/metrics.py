"""Latency metrics (the port's copy of the part of ``repro.core.metrics``
that the serving engine and driver use; pure numpy)."""
from __future__ import annotations

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

    def p50(self) -> float:
        return percentile(self.latencies, 50.0)

    def p99(self) -> float:
        return percentile(self.latencies, 99.0)

