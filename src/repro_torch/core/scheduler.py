"""Tally's priority-aware scheduler (paper §4.2, Fig. 4).

A copy of ``repro.core.scheduler`` (the port imports nothing of ``repro``);
the policy code is unchanged line for line. It drives
``core.virtualization.RealExecutor``, which executes the (transformed)
CUDA kernels through the Tally server, through the ``Executor`` protocol.

Policy (mirrors Fig. 4 line-by-line):
  * high-priority clients: fetch + dispatch immediately with the DEFAULT
    config; a running best-effort launch is preempted first.
  * best-effort clients: run only when every high-priority client is
    inactive (no kernel pending or running). Each BE kernel is launched in
    its profiled config — sliced (one slice per decision) or preemptive
    (single open-ended launch, preempted via flag/budget) — chosen by the
    ``TransparentProfiler`` under the turnaround-latency bound.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, List, Optional, Protocol

from repro_torch.core.profiler import DEFAULT, LaunchConfig, TransparentProfiler
from repro_torch.core.workloads import SimKernel, Workload


# ---------------------------------------------------------------------------
# Client state (one per workload process attached to the Tally server)
# ---------------------------------------------------------------------------


@dataclass
class PendingKernel:
    kernel: Any                    # SimKernel | virtualization.LaunchJob
    request_id: int = -1           # HP: request this kernel belongs to
    last_of_request: bool = False
    last_of_iteration: bool = False
    progress: Optional["BEProgress"] = None   # pre-attached BE state


@dataclass
class BEProgress:
    """Partially executed best-effort kernel (paper: global task index)."""

    pending: PendingKernel
    watermark: int = 0             # tasks completed (resume point)
    state: Any = None              # substrate-specific (real-mode buffers)

    @property
    def remaining(self) -> int:
        return self.pending.kernel.blocks - self.watermark


class Client:
    """Per-workload launch queue + execution state at the server."""

    def __init__(self, workload: Workload, job_id: Optional[str] = None):
        self.workload = workload
        self.name = workload.name
        # stable fleet-wide identity: follows the client across BE
        # migrations (trace events keep one job_id per job, whichever
        # device they were recorded on)
        self.job_id = job_id if job_id is not None else workload.name
        self.priority = workload.priority
        self.queue: Deque[PendingKernel] = deque()
        self.kernel_running = False
        self.current: Optional[BEProgress] = None      # BE resume state
        self.iterations_done = 0
        self.not_ready_until = 0.0     # host-side gap (input pipeline stall)
        self._iter_idx = 0

    @property
    def is_high_priority(self) -> bool:
        return self.priority == 0

    # -- queue management -----------------------------------------------------

    def refill_training(self) -> None:
        """BE training clients stream iterations endlessly (Fig. 4 fetch)."""
        if self.workload.kind != "train" or self.queue:
            return
        kernels = self.workload.iteration(self._iter_idx)
        self._iter_idx += 1
        for i, k in enumerate(kernels):
            self.queue.append(PendingKernel(
                k, last_of_iteration=(i == len(kernels) - 1)))

    def fetch_next_kernel(self) -> Optional[PendingKernel]:
        if not self.is_high_priority:
            self.refill_training()
        return self.queue.popleft() if self.queue else None

    def get_curr_ex_kernel(self) -> Optional[BEProgress]:
        return self.current

    @property
    def active(self) -> bool:
        """HP activity test: anything pending or in flight."""
        return bool(self.queue) or self.kernel_running


# ---------------------------------------------------------------------------
# Executor protocol — the substrate the scheduler drives
# ---------------------------------------------------------------------------


class Executor(Protocol):
    def now(self) -> float: ...

    def device_busy(self) -> bool: ...

    def launch_hp(self, client: Client, pk: PendingKernel) -> None:
        """Dispatch an HP kernel immediately (DEFAULT config)."""

    def launch_be(self, client: Client, prog: BEProgress,
                  cfg: LaunchConfig) -> None:
        """Dispatch a BE launch: one slice (slice mode), an open-ended
        preemptive launch, or the whole kernel (default)."""

    def preempt_best_effort(self) -> None:
        """Signal the in-flight BE launch (if any) to stop at its next
        block boundary; its completion event reports the watermark."""

    def wait(self) -> bool:
        """Block/advance until the next event. False => nothing left."""


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------


class TallyScheduler:
    """Fig. 4's ``scheduler()`` — event-driven form of the while-True loop."""

    def __init__(self, clients: List[Client], profiler: TransparentProfiler,
                 executor: Executor, *, transforms_enabled: bool = True):
        self.clients = sorted(clients, key=lambda c: c.priority)
        self.profiler = profiler
        self.ex = executor
        self.transforms_enabled = transforms_enabled
        self.obs = None     # optional obs.DeviceProbe (observation-only;
        #                     None keeps every path branch-free)

    # -- client membership (fleet layer: jobs arrive / migrate at runtime) ----

    def add_client(self, client: Client) -> None:
        """Admit a client mid-run (stable priority order is preserved, so a
        fleet that attaches clients incrementally schedules identically to a
        constructor that received them all up front)."""
        self.clients.append(client)
        self.clients.sort(key=lambda c: c.priority)
        if self.obs is not None:
            # attach happens at synced decision points, so the timestamp
            # is core-invariant
            self.obs.residency(self.ex.now(), client.job_id,
                               client.priority, 1.0)

    def remove_client(self, client: Client) -> None:
        """Detach a client (BE migration). The caller must first cancel or
        drain any in-flight launch owned by this client."""
        self.clients.remove(client)
        if self.obs is not None:
            self.obs.residency(self.ex.now(), client.job_id,
                               client.priority, -1.0)

    # -- policy ---------------------------------------------------------------

    def hp_active(self) -> bool:
        return any(c.active for c in self.clients if c.is_high_priority)

    def schedule_once(self) -> bool:
        """One pass over clients by priority; True if something launched."""
        for client in self.clients:                      # sorted by priority
            if client.is_high_priority:
                if client.kernel_running or not client.queue:
                    continue
                self.ex.preempt_best_effort()            # Fig.4 line 17
                if self.ex.device_busy():
                    continue        # BE draining: HP starts at the watermark
                pk = client.fetch_next_kernel()
                assert pk is not None
                client.kernel_running = True
                self.ex.launch_hp(client, pk)
                return True
            else:
                if self.ex.device_busy():
                    continue
                if self.hp_active():                     # opportunistic only
                    continue
                if client.not_ready_until > self.ex.now():
                    continue                   # host-side gap (input stall)
                prog = client.get_curr_ex_kernel()
                if prog is None:
                    pk = client.fetch_next_kernel()
                    if pk is None:
                        continue
                    prog = pk.progress if pk.progress is not None \
                        else BEProgress(pk)
                    client.current = prog
                cfg = self._config_for(prog.pending.kernel)
                client.kernel_running = True
                self.ex.launch_be(client, prog, cfg)
                return True
        return False

    def _config_for(self, kernel: SimKernel) -> LaunchConfig:
        if not self.transforms_enabled:
            return DEFAULT                               # Fig. 7b ablation
        cfg = self.profiler.lookup_launch_config(kernel)
        if cfg is None:
            cfg = self.profiler.launch_and_profile(kernel)
            if self.obs is not None:
                self.obs.profiled(kernel.name)
        return cfg

    # -- completion callbacks (wired by the executor) --------------------------

    def on_hp_complete(self, client: Client) -> None:
        client.kernel_running = False

    def on_be_complete(self, client: Client, prog: BEProgress,
                       new_watermark: int) -> None:
        """BE launch finished or was preempted at ``new_watermark``."""
        client.kernel_running = False
        prog.watermark = new_watermark
        if prog.remaining <= 0:
            client.current = None
            if prog.pending.last_of_iteration:
                client.iterations_done += 1

    # -- main loop --------------------------------------------------------------

    def run(self, until: float, *, strict: bool = False) -> None:
        """Drive the executor until the clock passes ``until``.

        Default mode matches the original single-run semantics: the first
        event *past* the horizon is still processed (its completion is
        recorded) before the loop exits. ``strict`` stops *at* the horizon
        without consuming any later event — the fleet layer uses it at
        intermediate decision points so a client attached at time t joins a
        device whose clock is exactly t (requires the executor to expose
        ``next_event_time``)."""
        while self.ex.now() < until:
            if self.schedule_once():
                continue
            if strict:
                nxt = self.ex.next_event_time()
                if nxt is None or nxt > until:
                    break
            if not self.ex.wait():
                break
