"""Fault tolerance for the training driver (the port's copy of
``repro.distributed.fault_tolerance``, pure Python):

  HeartbeatMonitor   per-host liveness from periodic beats; a host is DEAD
                     after ``timeout`` without a beat.
  StragglerDetector  per-step host timings; a host is a straggler when its
                     trailing-window median exceeds the fleet median by
                     ``ratio`` (robust to single slow steps from GC or
                     checkpoints).
  ElasticPlan        given dead hosts, the largest re-meshable device count
                     (the model axis kept whole, the data axes shrunk): the
                     new mesh shape and global batch, which the launcher
                     applies after restoring the last checkpoint (and which
                     ``launch.dryrun.remesh_cell`` prices).
  decide_recovery    the policy: none, restart on spares, or re-mesh.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple


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


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ElasticPlan:
    """Resolution after host loss: new mesh + data-axis reassignment."""

    new_mesh_shape: Tuple[int, ...]
    mesh_axis_names: Tuple[str, ...]
    surviving_hosts: List[int]
    dropped_hosts: List[int]
    new_global_batch: int


def plan_elastic_remesh(mesh_shape: Tuple[int, ...],
                        axis_names: Tuple[str, ...],
                        hosts: Sequence[int],
                        dead: Sequence[int],
                        devices_per_host: int,
                        global_batch: int,
                        data_axes: Tuple[str, ...] = ("pod", "data"),
                        ) -> ElasticPlan:
    """Shrink the data-parallel extent to the surviving hosts.

    The model axis (tensor-parallel groups) must stay intact: surviving
    hosts must still cover whole model-parallel groups, so only the axes
    in ``data_axes`` shrink, the outermost first, halving. The batch
    shrinks in proportion (the per-device batch stays as it was).
    """
    alive = [h for h in hosts if h not in set(dead)]
    if not alive:
        raise RuntimeError("no surviving hosts")
    target = len(alive) * devices_per_host
    shape = list(mesh_shape)
    for name in data_axes:
        if name not in axis_names:
            continue
        i = axis_names.index(name)
        while math.prod(shape) > target and shape[i] > 1:
            shape[i] //= 2
        if math.prod(shape) <= target:
            break
    if math.prod(shape) > target:
        raise RuntimeError(
            f"cannot re-mesh {mesh_shape} onto {len(alive)} hosts "
            f"({devices_per_host} devices each)")
    scale = math.prod(shape) / math.prod(mesh_shape)
    new_batch = max(1, int(global_batch * scale))
    return ElasticPlan(new_mesh_shape=tuple(shape),
                       mesh_axis_names=axis_names,
                       surviving_hosts=alive,
                       dropped_hosts=sorted(set(dead)),
                       new_global_batch=new_batch)


# ---------------------------------------------------------------------------
# Recovery orchestration (the launcher's host-side policy, pure)
# ---------------------------------------------------------------------------


@dataclass
class RecoveryAction:
    kind: str                         # "none" | "restart" | "remesh"
    plan: Optional[ElasticPlan] = None
    restore_step: Optional[int] = None


def decide_recovery(dead: Sequence[int], stragglers: Sequence[int],
                    latest_ckpt: Optional[int],
                    spare_hosts: int = 0) -> RecoveryAction:
    """Policy: stragglers are replaced only if spares exist (demoted, not
    fatal); dead hosts force a restart from the last checkpoint, on the
    same mesh with spares, else an elastic re-mesh."""
    if not dead and not stragglers:
        return RecoveryAction("none")
    if dead:
        if latest_ckpt is None:
            raise RuntimeError("host loss before first checkpoint")
        kind = "restart" if spare_hosts >= len(dead) else "remesh"
        return RecoveryAction(kind, restore_step=latest_ckpt)
    if spare_hosts >= len(stragglers):
        return RecoveryAction("restart", restore_step=latest_ckpt)
    return RecoveryAction("none")
