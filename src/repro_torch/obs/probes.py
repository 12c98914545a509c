"""ObsHub + DeviceProbe + ServingProbe: the telemetry hook surface (the
port's copy of ``repro.obs.probes``).

Contract: opt-in (every engine-side call site is guarded by an ``obs is
None`` test so a bare run pays nothing), observation-only (hooks read
clocks and counts the engines already computed — they never feed
anything back). The port's ``ServingEngine`` calls the ``ServingProbe``
hooks at the reference engine's sites, so under one injected clock both
packages' registries are byte-identical (``tests/test_torch_obs.py``).

``ObsHub`` composes the deterministic parts (``MetricsRegistry`` +
``AuditLog`` + timelines) with the non-deterministic wall-clock
``SelfProfiler`` (kept out of the registry so the equality contract
holds). It registers every family the reference's hub registers —
the simulator's per-device and fleet families as well, which stay empty
in the port since it has no simulator — so the two expositions have the
same family set. ``for_device(i)`` hands out a ``DeviceProbe``, whose
methods are the per-engine hot hooks; ``serving()`` hands out the
``ServingProbe``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .audit import AuditLog
from .registry import DEFAULT_BUCKETS, MetricsRegistry
from .selfprof import SelfProfiler


class DeviceProbe:
    """Per-device telemetry hooks (engine side). Everything here must stay
    cheap and deterministic: these fire per HP request / BE kernel
    completion, not per simulated event."""

    __slots__ = ("hub", "index", "span", "_arr", "_req", "_lat", "_lat_tl",
                 "_preempt", "_be", "_resid", "_occ_hp", "_occ_be",
                 "_profiled")

    def __init__(self, hub: "ObsHub", index: int):
        self.hub = hub
        self.index = index
        self.span: Optional[float] = None
        d = str(index)
        self._arr = hub._arrivals.child(d)
        self._req = hub._requests.child(d)
        self._lat = hub._latency.child(d)
        self._lat_tl = hub._latency_tl.child(d)
        self._preempt = hub._preempts.child(d)
        self._profiled = hub._profiled
        self._resid = hub._residency
        self._occ_hp = hub._occ_hp.child(d)
        self._occ_be = hub._occ_be.child(d)
        self._be: Dict[str, Tuple] = {}      # job name -> (counter, bins)

    def bind(self, duration: float) -> None:
        """Called by the simulator's device engine at its start (the
        simulator is not ported); fixes the grid span of the pre-binned BE
        series."""
        if self.span is None or duration > self.span:
            self.span = duration

    # -- engine hooks (hot; the simulator's per-event hooks) ----------------

    def arrival(self, t: float) -> None:
        self._arr.v += 1.0

    def request_done(self, t: float, latency: float, samples: float) -> None:
        self._req.v += 1.0
        self._lat.observe(latency)
        self._lat_tl.append(t, latency)

    def iteration(self, t: float, name: str, samples: float) -> None:
        h = self._be.get(name)
        if h is None:
            d = str(self.index)
            ctr = self.hub._be_samples.child(d, name)
            bins = self.hub._be_series(self.span or 60.0).child(d, name)
            h = (ctr, bins)
            self._be[name] = h
        ctr, bins = h
        ctr.v += samples
        bins.add(t, samples)

    def preempt(self, t: float) -> None:
        self._preempt.v += 1.0

    def profiled(self, kernel_name: str) -> None:
        self._profiled.child(str(self.index), kernel_name).v += 1.0

    # -- scheduler / fleet hooks (decision-point frequency) -----------------

    def residency(self, t: float, job: str, priority: int,
                  delta: float) -> None:
        self._resid.child(str(self.index), job, str(priority)).append(
            t, delta)

    def occupancy(self, t: float, hp_busy: float, be_busy: float) -> None:
        self._occ_hp.append(t, hp_busy)
        self._occ_be.append(t, be_busy)

    def finalize(self, clock: float, hp_busy: float, be_busy: float,
                 requests: float, profiled: float) -> None:
        d = str(self.index)
        self.hub._g_clock.child(d).set(clock)
        self.hub._g_hp_busy.child(d).set(hp_busy)
        self.hub._g_be_busy.child(d).set(be_busy)
        self.hub._g_requests.child(d).set(requests)
        self.hub._g_profiled.child(d).set(profiled)


class ServingProbe:
    """Hooks for the real-execution serving engine. These observe
    wall-clock latencies (``time.monotonic``, or the engine's injected
    clock), so they are byte-equal across runs only under a fake clock;
    otherwise only the zero-cost-off contract covers them."""

    def __init__(self, hub: "ObsHub"):
        r = hub.registry
        self.requests = r.counter(
            "tally_serving_requests_total",
            "completed serving requests").child()
        self.latency = r.histogram(
            "tally_serving_request_latency_seconds",
            "wall-clock end-to-end request latency",
            buckets=DEFAULT_BUCKETS).child()
        self.ttft = r.histogram(
            "tally_serving_ttft_seconds",
            "wall-clock time to first token",
            buckets=DEFAULT_BUCKETS).child()
        self.quanta = r.counter(
            "tally_serving_be_quanta_total",
            "opportunistic best-effort training quanta granted").child()
        self.active = r.gauge(
            "tally_serving_active_slots", "decode slots in use").child()
        self.sheds = r.counter(
            "tally_serving_sheds_total",
            "requests shed after exceeding their deadline", ("where",))
        # request-level robustness: client-side retries, hedged
        # requests, and brownout degradation transitions
        self.retries = r.counter(
            "tally_serving_retries_total",
            "requests re-queued after a per-request timeout").child()
        self.hedges = r.counter(
            "tally_serving_hedges_total",
            "hedged duplicate requests by outcome", ("outcome",))
        self.brownouts = r.counter(
            "tally_serving_brownout_transitions_total",
            "brownout mode enter/exit transitions", ("state",))

    def admitted(self, ttft: float) -> None:
        self.ttft.observe(ttft)

    def retired(self, latency: float) -> None:
        self.requests.v += 1.0
        self.latency.observe(latency)

    def be_quantum(self) -> None:
        self.quanta.v += 1.0

    def slots(self, n: float) -> None:
        self.active.set(n)

    def shed_request(self, where: str) -> None:
        self.sheds.child(where).v += 1.0

    def retry(self) -> None:
        self.retries.v += 1.0

    def hedge(self, outcome: str) -> None:
        self.hedges.child(outcome).v += 1.0

    def brownout(self, state: str) -> None:
        self.brownouts.child(state).v += 1.0


class ObsHub:
    """Composition root of the telemetry layer; pass as ``obs=`` to
    ``ServingEngine`` / ``serve``."""

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 audit: Optional[AuditLog] = None,
                 audit_capacity: Optional[int] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.audit = audit if audit is not None else \
            AuditLog(capacity=audit_capacity)
        self.prof = SelfProfiler()
        self.meta: Dict = {}
        self._probes: Dict[int, DeviceProbe] = {}
        self._serving: Optional[ServingProbe] = None
        self._seen_rejects: set = set()
        r = self.registry
        # engine-level families (children resolved per DeviceProbe)
        self._arrivals = r.counter(
            "tally_hp_arrivals_total", "HP request arrivals", ("device",))
        self._requests = r.counter(
            "tally_hp_requests_done_total", "HP requests completed",
            ("device",))
        self._latency = r.histogram(
            "tally_hp_request_latency_seconds", "HP request latency",
            ("device",), buckets=DEFAULT_BUCKETS)
        self._latency_tl = r.timeline(
            "tally_hp_request_latency_series",
            "(t, latency) per completed HP request", ("device",))
        self._be_samples = r.counter(
            "tally_be_samples_total", "BE training samples processed",
            ("device", "job"))
        self._preempts = r.counter(
            "tally_be_preempts_total",
            "effective BE preemptions (in-flight launch truncated)",
            ("device",))
        self._profiled = r.counter(
            "tally_profiled_kernels_total",
            "transparent-profiler launch-config searches",
            ("device", "kernel"))
        self._residency = r.timeline(
            "tally_residency_series",
            "+1/-1 client attach/detach marks", ("device", "job", "priority"))
        self._occ_hp = r.timeline(
            "tally_hp_busy_seconds_series",
            "cumulative HP busy seconds at SLO-check points", ("device",))
        self._occ_be = r.timeline(
            "tally_be_busy_seconds_series",
            "cumulative BE busy seconds at SLO-check points", ("device",))
        # fleet-level families
        self._placements = r.counter(
            "tally_placements_total", "admitted placements", ("kind",))
        self._rejects = r.counter(
            "tally_admission_rejects_total",
            "jobs that found no device (deduped per placement revision)",
            ("kind",))
        self._migrations = r.counter(
            "tally_migrations_total", "SLO-driven BE migrations")
        self._slo_checks = r.counter(
            "tally_slo_checks_total", "SLO window evaluations")
        self._slo_breaches = r.counter(
            "tally_slo_breaches_total", "SLO window breaches")
        self._failures = r.counter(
            "tally_device_failures_total", "injected device failures")
        self._departures = r.counter(
            "tally_departures_total", "job departures (drained BE jobs)")
        # resilience-layer families (children only materialize when the
        # resilience machinery fires, so fault-free runs expose them empty
        # and stay byte-identical across cores)
        self._stalls = r.counter(
            "tally_device_stalls_total", "injected transient device stalls")
        self._recoveries = r.counter(
            "tally_device_recoveries_total",
            "devices returned to placement eligibility", ("reason",))
        self._requeues = r.counter(
            "tally_requeues_total",
            "BE jobs detached and re-queued for re-admission", ("reason",))
        self._quarantines = r.counter(
            "tally_quarantines_total",
            "circuit-breaker device quarantines")
        self._sheds = r.counter(
            "tally_sheds_total", "jobs dropped by overload shedding",
            ("kind",))
        self._be_preempts_fleet = r.counter(
            "tally_fleet_be_preempts_total",
            "fleet-level BE preemption events (storms, SLO pressure)",
            ("reason",))
        # HP failover families: children only materialize when a
        # failover policy fires
        self._failovers = r.counter(
            "tally_failovers_total",
            "HP services detached off faulted devices", ("reason",))
        self._failover_restores = r.counter(
            "tally_failover_restores_total",
            "HP failover restores (serving resumed)", ("warm",))
        # end-of-run per-device gauges
        self._g_clock = r.gauge(
            "tally_device_clock_seconds", "final device clock", ("device",))
        self._g_hp_busy = r.gauge(
            "tally_device_hp_busy_seconds", "final HP busy time", ("device",))
        self._g_be_busy = r.gauge(
            "tally_device_be_busy_seconds", "final BE busy time", ("device",))
        self._g_requests = r.gauge(
            "tally_device_requests_done", "final completed HP requests",
            ("device",))
        self._g_profiled = r.gauge(
            "tally_device_profiled_kernels", "profiled kernels on device",
            ("device",))

    def _be_series(self, span: float):
        return self.registry.binned(
            "tally_be_samples_series",
            "BE samples binned onto a fixed grid", ("device", "job"),
            span=span)

    def for_device(self, index: int) -> DeviceProbe:
        p = self._probes.get(index)
        if p is None:
            p = DeviceProbe(self, index)
            self._probes[index] = p
        return p

    def serving(self) -> ServingProbe:
        if self._serving is None:
            self._serving = ServingProbe(self)
        return self._serving

    def bind_run(self, **meta) -> None:
        for k, v in meta.items():
            self.meta.setdefault(k, v)

    # -- fleet decision hooks (audit + counters) ----------------------------
    # Record contents are core-invariant by construction: timestamps are
    # decision-point clocks, occupancy snapshots are only included when the
    # placement policy actually read one (the event core syncs devices for
    # exactly those), and admission rejects are deduped per placement
    # revision (the lockstep core retries every decision point; the event
    # core retries once per revision — the dedup makes the logs coincide).

    def placement(self, t: float, job: str, kind: str, device: int,
                  snapshot: List) -> None:
        self._placements.child(kind).v += 1.0
        self.audit.record(t, "placement", job, device, job_kind=kind,
                          candidates=snapshot)

    def admission_reject(self, t: float, job: str, kind: str, rev: int,
                         snapshot: List) -> None:
        key = (job, rev)
        if key in self._seen_rejects:
            return
        self._seen_rejects.add(key)
        self._rejects.child(kind).v += 1.0
        self.audit.record(t, "admission_reject", job, None, job_kind=kind,
                          rev=rev, candidates=snapshot)

    def slo_check(self, t: float, device: int, service: str, est: float,
                  bound: float, window: int, breach: bool) -> None:
        self._slo_checks.child().v += 1.0
        if breach:
            self._slo_breaches.child().v += 1.0
        self.audit.record(t, "slo_check", service, device, window_p99=est,
                          bound=bound, window=window, breach=breach)

    def migration(self, t: float, job: str, src: int, dst: int,
                  service: str, est: float, bound: float, window: int,
                  disruption: Dict[str, float], snapshot: List) -> None:
        self._migrations.child().v += 1.0
        self.audit.record(t, "migration", job, src, dst=dst, service=service,
                          window_p99=est, bound=bound, window=window,
                          disruption=disruption, candidates=snapshot)

    def migration_blocked(self, t: float, job: str, src: int, service: str,
                          est: float, bound: float, window: int) -> None:
        self.audit.record(t, "migration_blocked", job, src, service=service,
                          window_p99=est, bound=bound, window=window)

    def device_failure(self, t: float, device: int,
                       requeued: List[str]) -> None:
        self._failures.child().v += 1.0
        self.audit.record(t, "failure", "", device, requeued=requeued)

    def departure(self, t: float, job: str, device: int) -> None:
        self._departures.child().v += 1.0
        self.audit.record(t, "departure", job, device)

    # -- resilience hooks (fired only when faults/policies are active, so
    #    fault-free audit logs and registries stay byte-identical to
    #    pre-resilience runs) ---------------------------------------------

    def device_stall(self, t: float, device: int, until: float,
                     requeued: List[str]) -> None:
        self._stalls.child().v += 1.0
        self.audit.record(t, "stall", "", device, until=until,
                          requeued=requeued)

    def device_recover(self, t: float, device: int, reason: str) -> None:
        self._recoveries.child(reason).v += 1.0
        self.audit.record(t, "recover", "", device, reason=reason)

    def requeue(self, t: float, name: str, device: int, reason: str,
                attempt: int, eligible_at: float, lost: float,
                gang: Optional[str]) -> None:
        self._requeues.child(reason).v += 1.0
        self.audit.record(t, "requeue", name, device, reason=reason,
                          attempt=attempt, eligible_at=eligible_at,
                          lost_work=lost, gang=gang)

    def quarantine(self, t: float, device: int, fault_count: int,
                   until: float) -> None:
        self._quarantines.child().v += 1.0
        self.audit.record(t, "quarantine", "", device,
                          fault_count=fault_count, until=until)

    def shed(self, t: float, name: str, kind: str, reason: str,
             device: Optional[int] = None) -> None:
        self._sheds.child(kind).v += 1.0
        self.audit.record(t, "shed", name, device, job_kind=kind,
                          reason=reason)

    def be_preempt(self, t: float, device: int, requeued: List[str],
                   reason: str) -> None:
        self._be_preempts_fleet.child(reason).v += 1.0
        self.audit.record(t, "be_preempt", "", device, requeued=requeued,
                          reason=reason)

    # -- HP failover hooks (fired only with a failover= policy attached) ----

    def failover(self, t: float, job: str, device: int, reason: str,
                 interrupted: int, future: int, attempt: int) -> None:
        """An HP service left ``device`` (fault ``reason``) carrying
        ``interrupted`` arrived-but-unfinished requests and ``future``
        un-fired arrivals; ``attempt`` counts this service's failovers."""
        self._failovers.child(reason).v += 1.0
        self.audit.record(t, "failover", job, device, reason=reason,
                          interrupted=interrupted, future=future,
                          attempt=attempt)

    def failover_restore(self, t: float, job: str, device: int, warm: bool,
                         delay: float, interrupted: int,
                         future: int) -> None:
        """The matching restore: serving resumed on ``device`` after the
        warm/cold ``delay``, replaying exactly the carried backlog."""
        self._failover_restores.child("warm" if warm else "cold").v += 1.0
        self.audit.record(t, "failover_restore", job, device, warm=warm,
                          delay=delay, interrupted=interrupted,
                          future=future)
