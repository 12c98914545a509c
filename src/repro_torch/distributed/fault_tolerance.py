"""Fault tolerance for the training driver (the port's copy of
``HeartbeatMonitor`` and ``StragglerDetector`` from
``repro.distributed.fault_tolerance``):

  HeartbeatMonitor   per-host liveness from periodic beats; a host is DEAD
                     after ``timeout`` without a beat.
  StragglerDetector  per-step host timings; a host is a straggler when its
                     trailing-window median exceeds the fleet median by
                     ``ratio`` (robust to single slow steps from GC or
                     checkpoints).

The elastic re-meshing of the reference waits for the port's
``torch.distributed`` layer.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Sequence


@dataclass
class HeartbeatMonitor:
    timeout: float
    _last: Dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: float) -> None:
        self._last[host] = now

    def dead_hosts(self, now: float) -> List[int]:
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout)

    def alive_hosts(self, now: float) -> List[int]:
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout)


@dataclass
class StragglerDetector:
    """Flag hosts whose trailing median step time >> fleet median."""

    window: int = 8
    ratio: float = 1.5
    _hist: Dict[int, Deque[float]] = field(
        default_factory=lambda: defaultdict(deque))

    def record(self, host: int, step_time: float) -> None:
        h = self._hist[host]
        h.append(step_time)
        if len(h) > self.window:
            h.popleft()

    def _median(self, xs: Sequence[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def stragglers(self) -> List[int]:
        meds = {h: self._median(list(v)) for h, v in self._hist.items()
                if len(v) >= max(2, self.window // 2)}
        if len(meds) < 2:
            return []
        fleet = self._median(list(meds.values()))
        if fleet <= 0:
            return []
        return sorted(h for h, m in meds.items() if m > self.ratio * fleet)
