"""Wall-clock self-profiling of a run (the port's copy of
``repro.obs.selfprof``).

Answers "where does the *real* time of a run go" as exclusive wall-clock
buckets. This is the one part of the telemetry layer that is *not*
deterministic (it measures the host), so it lives outside the
``MetricsRegistry`` and is excluded from the cross-package equality
contract.

Attribution is a section stack with exclusive accounting: ``push(name)``
charges the elapsed slice to the currently open section, then opens
``name``; ``pop()`` closes it and resumes the parent. Nested sections
therefore never double-count.
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional


class SelfProfiler:
    __slots__ = ("acc", "_stack", "_t0", "_t1")

    def __init__(self):
        self.acc: Dict[str, float] = {}
        self._stack: List[List] = []          # [name, last_mark]
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    def start(self) -> None:
        self._t0 = perf_counter()
        self._t1 = None

    def stop(self) -> None:
        while self._stack:
            self.pop()
        self._t1 = perf_counter()

    def push(self, section: str) -> None:
        now = perf_counter()
        st = self._stack
        if st:
            top = st[-1]
            self.acc[top[0]] = self.acc.get(top[0], 0.0) + (now - top[1])
        st.append([section, now])

    def pop(self) -> None:
        now = perf_counter()
        name, mark = self._stack.pop()
        self.acc[name] = self.acc.get(name, 0.0) + (now - mark)
        if self._stack:
            self._stack[-1][1] = now

    def report(self) -> Dict[str, float]:
        """Sections in seconds plus ``total_s`` (start→stop/now wall time)
        and ``other_s`` (unattributed remainder); ``frac_<name>`` per
        section when the total is positive."""
        end = self._t1 if self._t1 is not None else perf_counter()
        total = (end - self._t0) if self._t0 is not None else \
            sum(self.acc.values())
        out = {f"{k}_s": v for k, v in sorted(self.acc.items())}
        out["total_s"] = total
        out["other_s"] = max(0.0, total - sum(self.acc.values()))
        if total > 0:
            for k, v in sorted(self.acc.items()):
                out[f"frac_{k}"] = v / total
        return out
