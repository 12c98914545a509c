"""Structured scheduler-decision audit log (the port's copy of
``repro.obs.audit``).

Every fleet-level decision — placement, admission rejection, SLO check
(and breach), BE migration (or a breach with no destination), device
failure, departure — is recorded with the *inputs* the scheduler saw and
the alternative it chose, so a run can answer "why was job X moved at
t=Y" (``AuditLog.why``). ``fingerprint()`` is the canonical comparable
form; ``to_jsonl`` / ``from_jsonl`` round-trip it, byte-equal with the
reference's (``tests/test_torch_obs.py``).

``capacity=N`` turns the log into a flight recorder: a ring buffer of the
last N records (``dropped`` counts evictions), bounding memory on long
runs while keeping the most recent decision history for post-mortems.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

KINDS = ("placement", "admission_reject", "slo_check", "migration",
         "migration_blocked", "be_preempt", "failure", "departure",
         # resilience layer: transient stalls, recoveries,
         # fault/pressure requeues, circuit-breaker quarantines, and
         # shed (dropped) jobs — recorded only when faults or
         # recovery/shedding policies are active, so fault-free logs are
         # byte-identical to pre-resilience runs
         "stall", "recover", "requeue", "quarantine", "shed",
         # HP failover: an HP service detached off a faulted
         # device with its carried request backlog, and the matching
         # restore once the re-placement's warm/cold delay elapsed —
         # recorded only when a failover policy is attached
         "failover", "failover_restore")


@dataclass
class AuditRecord:
    t: float
    kind: str
    job: str = ""                    # subject job/service name ("" = fleet)
    device: Optional[int] = None
    details: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"t": self.t, "kind": self.kind, "job": self.job,
                "device": self.device, "details": self.details}

    @classmethod
    def from_dict(cls, d: Dict) -> "AuditRecord":
        return cls(t=d["t"], kind=d["kind"], job=d.get("job", ""),
                   device=d.get("device"), details=d.get("details", {}))


class AuditLog:
    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self._records: deque = deque(maxlen=capacity)
        self.total = 0                       # including evicted records

    # -- recording ----------------------------------------------------------

    def record(self, t: float, kind: str, job: str = "",
               device: Optional[int] = None, **details) -> None:
        self.total += 1
        self._records.append(AuditRecord(t, kind, job, device, details))

    @property
    def dropped(self) -> int:
        return self.total - len(self._records)

    # -- access -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._records)

    def __iter__(self) -> Iterator[AuditRecord]:
        return iter(self._records)

    @property
    def records(self) -> List[AuditRecord]:
        return list(self._records)

    def filter(self, kind: Optional[str] = None, job: Optional[str] = None,
               device: Optional[int] = None) -> List[AuditRecord]:
        out = []
        for r in self._records:
            if kind is not None and r.kind != kind:
                continue
            if job is not None and r.job != job:
                continue
            if device is not None and r.device != device:
                continue
            out.append(r)
        return out

    def why(self, job: str, t: Optional[float] = None,
            tol: float = 1e-9) -> List[AuditRecord]:
        """Decision records explaining what happened to ``job`` — at time
        ``t`` when given (within ``tol``), across the whole run otherwise.
        A migration record is self-contained: it embeds the SLO inputs
        (window p99 vs bound, window support) that triggered it."""
        out = [r for r in self._records if r.job == job]
        if t is not None:
            out = [r for r in out if abs(r.t - t) <= tol]
        return out

    def fingerprint(self) -> List:
        """Canonical, comparable form (exact floats via repr-round-trip
        JSON) — byte-equal across packages for the same scenario."""
        return [(r.t, r.kind, r.job, r.device,
                 json.dumps(r.details, sort_keys=True))
                for r in self._records]

    # -- persistence --------------------------------------------------------

    def to_jsonl(self, path: Optional[str] = None) -> str:
        text = "".join(json.dumps(r.to_dict(), sort_keys=True) + "\n"
                       for r in self._records)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_jsonl(cls, text_or_path: str,
                   capacity: Optional[int] = None) -> "AuditLog":
        text = text_or_path
        if "\n" not in text_or_path and not text_or_path.lstrip().startswith("{"):
            with open(text_or_path) as f:
                text = f.read()
        log = cls(capacity=capacity)
        for line in text.splitlines():
            if not line.strip():
                continue
            r = AuditRecord.from_dict(json.loads(line))
            log.total += 1
            log._records.append(r)
        return log
