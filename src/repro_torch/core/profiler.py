"""Transparent profiler + launch-config search (paper §4.2).

The profiler measures each best-effort kernel under candidate launch
configurations (slicing degrees / persistent-worker counts) and selects the
config with the best execution time subject to

    estimated_turnaround <= TURNAROUND_LATENCY_BOUND      (default 0.0316 ms)

Turnaround estimation follows the paper:
  - sliced kernel      : completion time of a single slice,
  - preemptive kernel  : kernel_latency * worker_blocks / total_blocks (Eq 1).

Measurements are cached per *work configuration* (kernel identity + grid +
block dims) and averaged over ``PROFILE_RUNS`` runs; once collected they are
reused for the rest of execution (paper §5.7: profiling completes within
minutes and is negligible against hour-scale training).

The profiler is executor-agnostic: ``measure(kernel, config) -> ExecSample``
is supplied by the engine (here the real-mode server, which wall-clocks the
transformed CUDA kernels up to a device synchronize).

A copy of ``repro.core.profiler``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_TURNAROUND_BOUND = 0.0316e-3     # seconds (paper §5.6)
PROFILE_RUNS = 10                        # paper: averaged across many runs


@dataclass(frozen=True)
class LaunchConfig:
    """How to launch a best-effort kernel."""

    mode: str                  # "default" | "slice" | "preempt"
    param: int = 0             # num_slices (slice) / num_workers (preempt)

    def __str__(self) -> str:
        if self.mode == "default":
            return "default"
        return f"{self.mode}:{self.param}"


DEFAULT = LaunchConfig("default")


@dataclass(frozen=True)
class ExecSample:
    """One measurement of a kernel under a config."""

    exec_time: float           # full-kernel completion time under the config
    turnaround: float          # estimated resource-release latency


@dataclass
class ProfileEntry:
    config: LaunchConfig
    exec_time: float
    turnaround: float


def candidate_configs(blocks: int, sm_count: int, sliceable: bool = True,
                      max_worker_mult: int = 4,
                      slice_fracs: Tuple[float, ...] = (
                          1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2),
                      ) -> List[LaunchConfig]:
    """Candidate set (paper: preemption workers = multiples of #SMs that fit
    thread constraints; slicing degrees = percentages of total blocks,
    plus occupancy-aligned degrees of ~1-2 waves per slice)."""
    cands: List[LaunchConfig] = [DEFAULT]
    if not sliceable:
        return cands            # cooperative-kernel fallback: default only
    mult = 1
    while mult <= max_worker_mult:
        w = sm_count * mult
        if w >= blocks:
            break
        cands.append(LaunchConfig("preempt", w))
        mult *= 2
    if blocks <= sm_count:      # degenerate: whole kernel is one wave
        return cands
    ks = {max(2, int(round(1.0 / f))) for f in slice_fracs}
    waves = math.ceil(blocks / sm_count)
    ks |= {waves, max(2, math.ceil(waves / 2))}      # 1- and 2-wave slices
    for k in sorted(ks):
        if k < blocks:
            cands.append(LaunchConfig("slice", k))
    return cands


class TransparentProfiler:
    """Profile-guided launch-config provisioning (Fig. 4, lines 1-10)."""

    def __init__(self,
                 measure: Callable[[object, LaunchConfig], ExecSample],
                 sm_count: int,
                 turnaround_bound: float = DEFAULT_TURNAROUND_BOUND,
                 profile_runs: int = PROFILE_RUNS,
                 deterministic: bool = False):
        self._measure = measure
        self.sm_count = sm_count
        self.bound = turnaround_bound
        self.runs = profile_runs
        # a deterministic measure (device-model pricing) returns the same
        # sample every run, so one measurement IS the N-run average; the
        # profile_time ledger still charges all N runs
        self.deterministic = deterministic
        self._cache: Dict[Tuple, ProfileEntry] = {}
        self._measurements: Dict[Tuple, Dict[LaunchConfig, ExecSample]] = {}
        self.profile_time = 0.0          # accounting (overhead analysis)
        self.profiled_kernels = 0

    # -- measurement ---------------------------------------------------------

    def _work_key(self, kernel) -> Tuple:
        # kernel identity + work dims (paper profiles each unique
        # block/grid configuration separately)
        return (kernel.name, kernel.blocks)

    def lookup_measurement(self, kernel, cfg: LaunchConfig
                           ) -> Optional[ExecSample]:
        return self._measurements.get(self._work_key(kernel), {}).get(cfg)

    def profile(self, kernel, cfg: LaunchConfig) -> ExecSample:
        if self.deterministic:
            avg = self._measure(kernel, cfg)
        else:
            samples = [self._measure(kernel, cfg) for _ in range(self.runs)]
            avg = ExecSample(
                exec_time=sum(s.exec_time for s in samples) / len(samples),
                turnaround=sum(s.turnaround for s in samples) / len(samples))
        self._measurements.setdefault(self._work_key(kernel), {})[cfg] = avg
        self.profile_time += avg.exec_time * self.runs
        return avg

    # -- config selection (Fig. 4 launch_and_profile / set_launch_config) ----

    def lookup_launch_config(self, kernel) -> Optional[LaunchConfig]:
        entry = self._cache.get(self._work_key(kernel))
        return entry.config if entry is not None else None

    def launch_and_profile(self, kernel) -> LaunchConfig:
        """Measure all candidates, then fix the launch config (cached)."""
        key = self._work_key(kernel)
        if key in self._cache:
            return self._cache[key].config
        cands = candidate_configs(kernel.blocks, self.sm_count,
                                  getattr(kernel, "sliceable", True))
        for cfg in cands:
            if self.lookup_measurement(kernel, cfg) is None:
                self.profile(kernel, cfg)
        self.set_launch_config(kernel, cands, bound=self.bound)
        self.profiled_kernels += 1
        return self._cache[key].config

    def set_launch_config(self, kernel, candidates: List[LaunchConfig], *,
                          bound: float) -> None:
        """Best exec time subject to turnaround <= bound; if none complies,
        minimize turnaround (strictest isolation available)."""
        key = self._work_key(kernel)
        meas = self._measurements.get(key, {})
        ok = [(c, m) for c, m in ((c, meas[c]) for c in candidates
                                  if c in meas)
              if m.turnaround <= bound]
        if ok:
            cfg, m = min(ok, key=lambda cm: cm[1].exec_time)
        else:
            # nothing meets the bound: take the strictest isolation, and
            # among near-ties on turnaround (10%) prefer the fastest
            pool = [(c, meas[c]) for c in candidates if c in meas]
            best_ta = min(m.turnaround for _, m in pool)
            near = [(c, m) for c, m in pool if m.turnaround <= 1.1 * best_ta]
            cfg, m = min(near, key=lambda cm: cm[1].exec_time)
        self._cache[key] = ProfileEntry(cfg, m.exec_time, m.turnaround)

    def entry(self, kernel) -> Optional[ProfileEntry]:
        return self._cache.get(self._work_key(kernel))
