"""Non-intrusive virtualization layer — real-mode execution (paper §4.3).

On GPU, Tally interposes via LD_PRELOAD: clients' device API calls are
intercepted and forwarded to a server process that owns the device and
applies kernel transformations. The in-process analog here:

  - the interception boundary is the ``KernelDescriptor`` emitted by the
    kernels — user model code is never touched;
  - ``TallyClient`` mirrors the client library: it forwards launches to the
    server and caches chatty context state locally (``device_info``);
  - ``TallyServer`` owns execution: ``TallyScheduler`` drives a
    ``RealExecutor`` that runs the CUDA kernels — plain launches for HP,
    sliced launches and budgeted persistent-worker launches for BE, with
    cooperative preemption between quanta.

CUDA launches return before the kernel ends, so the executor synchronizes
the device at the end of every quantum: before it reads the clock and
before the completion callbacks. The profiler's measurements do the same,
or it would time the launch and not the kernel.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import transforms as T
from repro_torch.core.descriptor import (KernelDescriptor, build_plain,
                                         new_outputs)
from repro_torch.core.profiler import (ExecSample, LaunchConfig,
                                       TransparentProfiler)
from repro_torch.core.scheduler import (BEProgress, Client, PendingKernel,
                                        TallyScheduler)
from repro_torch.core.workloads import Workload
from repro_torch.device import device_attributes, resolve_device, synchronize


# ---------------------------------------------------------------------------
# Launch job: a descriptor + operands + a future for the result
# ---------------------------------------------------------------------------


@dataclass
class LaunchJob:
    """One intercepted kernel launch."""

    desc: KernelDescriptor
    args: Tuple[Any, ...]
    done: threading.Event = field(default_factory=threading.Event)
    outputs: Any = None
    submit_t: float = 0.0
    complete_t: float = 0.0

    # SimKernel-compatible surface for the profiler/scheduler
    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def blocks(self) -> int:
        return self.desc.num_blocks

    @property
    def sliceable(self) -> bool:
        return bool(self.desc.parallel_axes)

    def result(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError(f"launch {self.desc.name} not completed")
        return self.outputs

    @property
    def latency(self) -> float:
        return self.complete_t - self.submit_t


# ---------------------------------------------------------------------------
# Real execution state carried on BEProgress
# ---------------------------------------------------------------------------


@dataclass
class RealBEState:
    job: LaunchJob
    buffers: List[torch.Tensor]         # outputs, filled in place by chunks
    preemptible: Optional[Callable] = None   # built persistent-worker form
    slice_plan: Optional[List[Tuple[int, int]]] = None
    slice_idx: int = 0


class RealExecutor:
    """Executor protocol over wall-clock + actual kernel execution.

    Single-threaded and synchronous: each launch executes to completion of
    its QUANTUM (whole HP kernel / one BE slice / one budgeted preemptive
    chunk) inside ``launch_*`` — up to a device synchronize — then the
    completion callback fires. The scheduler re-checks priorities between
    quanta: cooperative, block-granularity preemption.
    """

    def __init__(self, server: "TallyServer"):
        self.server = server
        self._busy = False
        self.scheduler: Optional[TallyScheduler] = None
        self.hp_wall_time = 0.0
        self.be_wall_time = 0.0

    def now(self) -> float:
        return time.monotonic()

    def device_busy(self) -> bool:
        return self._busy

    # -- HP: run the whole kernel, untransformed ------------------------------

    def launch_hp(self, client: Client, pk: PendingKernel) -> None:
        job: LaunchJob = pk.kernel          # type: ignore[assignment]
        t0 = time.monotonic()
        outs = self.server.run_plain(job.desc, job.args)
        self.server.sync()
        self.hp_wall_time += time.monotonic() - t0
        job.outputs = outs
        job.complete_t = time.monotonic()
        job.done.set()
        self.scheduler.on_hp_complete(client)
        if pk.last_of_request:
            self.server._note_request_done(client, pk)

    # -- BE: transformed quanta ------------------------------------------------

    def launch_be(self, client: Client, prog: BEProgress,
                  cfg: LaunchConfig) -> None:
        st: RealBEState = prog.state        # type: ignore[attr-defined]
        job = st.job
        t0 = time.monotonic()
        if cfg.mode == "slice":
            if st.slice_plan is None:
                st.slice_plan = T.slice_plan(job.desc, cfg.param)
                st.slice_idx = 0
            off, ln = st.slice_plan[st.slice_idx]
            st.buffers = list(self.server.run_slice(
                job.desc, off, ln, st.buffers, job.args))
            st.slice_idx += 1
            # watermark in flat-task units (slices cover one grid axis)
            ax = T._slice_axis(job.desc)
            if st.slice_idx >= len(st.slice_plan):
                new_wm = job.desc.num_blocks
            else:
                frac = (off + ln) / job.desc.grid[ax]
                new_wm = int(job.desc.num_blocks * frac)
        elif cfg.mode == "preempt":
            if st.preemptible is None:
                st.preemptible = self.server.build_preemptible(
                    job.desc, cfg.param)
            budget = self.server.preempt_budget
            outs, _done = st.preemptible(st.buffers, prog.watermark, budget,
                                         *job.args)
            st.buffers = list(outs)
            new_wm = st.preemptible.watermark(prog.watermark, budget)
        else:                               # default: whole kernel
            st.buffers = list(self.server.run_plain(job.desc, job.args))
            new_wm = job.desc.num_blocks
        self.server.sync()
        self.be_wall_time += time.monotonic() - t0
        self.scheduler.on_be_complete(client, prog, new_wm)
        if prog.remaining <= 0:
            job.outputs = st.buffers
            job.complete_t = time.monotonic()
            job.done.set()

    def preempt_best_effort(self) -> None:
        # cooperative: quanta are synchronous, nothing is ever mid-flight
        # when the scheduler runs — the flag-poll is implicit
        return

    def wait(self) -> bool:
        return self.server._wait_for_work()


# ---------------------------------------------------------------------------
# Client — the LD_PRELOAD-side library
# ---------------------------------------------------------------------------


class TallyClient:
    """Application-side interception stub.

    ``launch`` forwards to the server (the intercepted cuLaunchKernel);
    ``device_info`` is answered from a client-local cache (the paper's
    local-state optimization for chatty context APIs)."""

    def __init__(self, server: "TallyServer", name: str, priority: int,
                 kind: str = "infer"):
        self.server = server
        self.name = name
        self.priority = priority
        self.kind = kind
        self._local_state: Dict[str, Any] = {}
        self.forwarded_calls = 0
        self.cached_calls = 0

    def launch(self, desc: KernelDescriptor, *args) -> LaunchJob:
        job = LaunchJob(desc=desc, args=args, submit_t=time.monotonic())
        self.forwarded_calls += 1
        self.server._submit(self, job)
        return job

    def device_info(self, key: str) -> Any:
        """Chatty metadata call — served locally after first fetch."""
        if key not in self._local_state:
            self.forwarded_calls += 1
            self._local_state[key] = self.server.device_attributes[key]
        else:
            self.cached_calls += 1
        return self._local_state[key]


# ---------------------------------------------------------------------------
# Server — owns the device, the scheduler, and the kernel transformer
# ---------------------------------------------------------------------------


class TallyServer:
    """In-process Tally server: client registry + priority scheduling over
    real kernel execution, with a launch cache per descriptor.

    ``device`` defaults to the card (``resolve_device``); ``"cpu"`` runs
    the kernels' plain PyTorch versions. On the card the kernels are built
    and loaded here, so that no profiled measurement includes the build.
    """

    def __init__(self, device: Union[str, torch.device, None] = None,
                 turnaround_bound: float = 0.0316e-3,
                 preempt_budget: int = 1, profile_runs: int = 1):
        self.device = resolve_device(device)
        self.device_attributes = device_attributes(self.device)
        if self.device.type == "cuda":
            from repro_torch import kernels
            kernels.build_all()
        self.preempt_budget = preempt_budget
        self._clients: List[TallyClient] = []
        self._sched_clients: Dict[str, Client] = {}
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._plain_cache: Dict[str, Callable] = {}
        self._request_log: List[Tuple[str, float]] = []
        self.ex = RealExecutor(self)
        self.profiler = TransparentProfiler(
            self._measure, self.device_attributes["sm_count"],
            turnaround_bound=turnaround_bound, profile_runs=profile_runs)
        self.scheduler: Optional[TallyScheduler] = None

    def sync(self) -> None:
        synchronize(self.device)

    # -- client registry -------------------------------------------------------

    def register(self, name: str, priority: int, kind: str = "infer"
                 ) -> TallyClient:
        cl = TallyClient(self, name, priority, kind)
        wl = Workload(name=name, kind="infer", priority=priority,
                      iteration=lambda i: [])
        sc = Client(wl)
        with self._lock:
            self._clients.append(cl)
            self._sched_clients[name] = sc
            self.scheduler = TallyScheduler(
                list(self._sched_clients.values()), self.profiler, self.ex)
            self.ex.scheduler = self.scheduler
        return cl

    # -- submission --------------------------------------------------------------

    def _submit(self, client: TallyClient, job: LaunchJob) -> None:
        sc = self._sched_clients[client.name]
        pk = PendingKernel(job, last_of_request=True)  # type: ignore[arg-type]
        if client.priority > 0:
            prog = BEProgress(pk)
            # zeroed: slices and persistent chunks fill these buffers in
            # place (where the JAX version aliased its outputs)
            prog.state = RealBEState(          # type: ignore[attr-defined]
                job=job, buffers=new_outputs(job.desc, self.device, zero=True))
            pk.progress = prog                 # type: ignore[attr-defined]
        with self._lock:
            sc.queue.append(pk)
        self._work.set()

    def _note_request_done(self, client: Client, pk: PendingKernel) -> None:
        self._request_log.append((client.name, time.monotonic()))

    def _wait_for_work(self) -> bool:
        if any(c.queue or c.current for c in self._sched_clients.values()):
            return True
        got = self._work.wait(timeout=0.05)
        self._work.clear()
        return got

    # -- execution helpers (kernel transformer + launch cache) -----------------

    def run_plain(self, desc: KernelDescriptor, args) -> Tuple[Any, ...]:
        key = f"plain/{desc.name}"
        if key not in self._plain_cache:
            self._plain_cache[key] = build_plain(desc)
        return tuple(self._plain_cache[key](*args))

    def run_slice(self, desc: KernelDescriptor, off: int, ln: int,
                  prev, args) -> Tuple[Any, ...]:
        key = f"slice/{desc.name}/{off}/{ln}"
        if key not in self._plain_cache:
            self._plain_cache[key] = T.build_sliced(desc, off, ln)
        return tuple(self._plain_cache[key](prev, *args))

    def build_preemptible(self, desc: KernelDescriptor, workers: int):
        key = f"preempt/{desc.name}/{workers}"
        if key not in self._plain_cache:
            self._plain_cache[key] = T.make_preemptible(desc, workers)
        return self._plain_cache[key]

    # -- transparent profiling on real hardware ---------------------------------

    def _measure(self, kernel, cfg: LaunchConfig) -> ExecSample:
        """Wall-clock one full execution of `kernel` (a LaunchJob) under
        `cfg`, each quantum up to a device synchronize; turnaround =
        quantum time per the same estimators as §4.2."""
        job: LaunchJob = kernel
        desc, args = job.desc, job.args
        buffers = new_outputs(desc, self.device, zero=True)
        self.sync()
        t0 = time.monotonic()
        if cfg.mode == "slice":
            per_slice: List[float] = []
            for off, ln in T.slice_plan(desc, cfg.param):
                s0 = time.monotonic()
                buffers = list(self.run_slice(desc, off, ln, buffers, args))
                self.sync()
                per_slice.append(time.monotonic() - s0)
            return ExecSample(exec_time=time.monotonic() - t0,
                              turnaround=sum(per_slice) / len(per_slice))
        if cfg.mode == "preempt":
            pre = self.build_preemptible(desc, cfg.param)
            start = 0
            quanta: List[float] = []
            while start < pre.total_tasks:
                q0 = time.monotonic()
                outs, _ = pre(buffers, start, self.preempt_budget, *args)
                buffers = list(outs)
                self.sync()
                quanta.append(time.monotonic() - q0)
                start = pre.watermark(start, self.preempt_budget)
            return ExecSample(exec_time=time.monotonic() - t0,
                              turnaround=sum(quanta) / len(quanta))
        buffers = list(self.run_plain(desc, args))
        self.sync()
        dt = time.monotonic() - t0
        return ExecSample(exec_time=dt, turnaround=dt)

    # -- serving loop --------------------------------------------------------------

    def serve_until_idle(self, max_seconds: float = 60.0) -> None:
        """Pump the scheduler until all client queues drain (tests) or the
        deadline passes."""
        deadline = time.monotonic() + max_seconds
        while time.monotonic() < deadline:
            if self.scheduler is None:
                return
            progressed = self.scheduler.schedule_once()
            if progressed:
                continue
            if not any(c.queue or c.current
                       for c in self._sched_clients.values()):
                return
            time.sleep(0)       # yield to submitting threads

    def serve_forever(self, stop: threading.Event,
                      idle_sleep: float = 1e-4) -> None:
        while not stop.is_set():
            if self.scheduler is not None and self.scheduler.schedule_once():
                continue
            time.sleep(idle_sleep)
