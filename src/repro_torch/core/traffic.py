"""MAF2-style inference traffic (the port's copy of the part of
``repro.core.traffic`` that the serving driver uses; pure numpy, held to
the original by tests/test_torch_launch_serve.py).

The paper replays the most-invoked function of the Microsoft Azure Function
Trace 2021. The dataset is not shipped offline, so the trace is a
statistically faithful surrogate: a doubly-stochastic (Cox) process whose
rate levels, drawn from a heavy-tailed distribution and held for a few
seconds, modulate Poisson arrivals.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class TrafficTrace:
    """Sorted request arrival times (seconds from epoch 0)."""

    arrivals: np.ndarray          # float64, sorted
    duration: float               # trace span in seconds


def maf2_like_trace(duration: float = 600.0, mean_rate: float = 50.0,
                    burstiness: float = 2.0, level_period: float = 5.0,
                    seed: int = 0) -> TrafficTrace:
    """Bursty serverless-style arrivals.

    Rate levels ~ lognormal; levels held for ``level_period`` seconds;
    arrivals Poisson within a level. ``burstiness`` ~ peak/mean rate ratio
    that the service observes after the paper's load rescaling (2x keeps
    the rescaled trace stable at load <= 0.9).
    """
    rng = np.random.default_rng(seed)
    n_levels = int(np.ceil(duration / level_period))
    sigma = np.log(max(burstiness, 1.001)) / 2.0
    levels = rng.lognormal(mean=-0.5 * sigma ** 2, sigma=sigma, size=n_levels)
    levels *= mean_rate / max(levels.mean(), 1e-12)
    # one rng draw pair per level (the stream order is part of the trace
    # contract: same seed -> same arrivals)
    chunks: List[np.ndarray] = []
    for i, lam in enumerate(levels):
        n = rng.poisson(lam * level_period)
        chunks.append(i * level_period
                      + rng.uniform(0.0, level_period, size=n))
    arr = (np.sort(np.concatenate(chunks)) if chunks
           else np.empty(0, dtype=np.float64))
    arr = arr[arr < duration]
    return TrafficTrace(arr, duration)
