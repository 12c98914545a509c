"""Batched serving engine: continuous batching + Tally co-location hook
(the port of ``repro.serving.engine``: the model runs eager on tensors, on
the device its parameters lie on; the request logic is the reference's).

Slot-based continuous batching (vLLM-style at batch granularity):
  - a fixed decode batch of ``capacity`` slots over a shared KV cache of
    ``max_len`` per slot,
  - arriving requests are prefilled (B=1) and their KV written into a free
    slot; decode steps run over ALL active slots each iteration with
    per-slot cache indices,
  - finished slots (EOS / max_new_tokens) are freed immediately and can be
    re-admitted within the same decode loop — no head-of-line blocking.

Tally co-location: the engine is the HIGH-PRIORITY client. When the
request queue is empty and all slots are idle, the engine invokes the
``best_effort_hook`` (e.g. one budgeted quantum of a co-located training
job) — the same opportunistic policy as Fig. 4, applied at the engine
level; the kernel-level path is exercised by ``core.virtualization``.

Request-level robustness, all opt-in:
  - admission is earliest-deadline-first (least deadline slack; requests
    without a deadline sort last, FIFO within ties), so a late-arriving
    tight-deadline request is never starved behind a lax one;
  - ``RetryPolicy``: a request whose per-request timeout expires is
    re-queued (tokens reset, same ``Request`` handle) behind a
    deterministic crc32-jittered backoff gate instead of being shed —
    shed only once retries are exhausted; latency keeps counting from the
    original submit;
  - ``HedgePolicy``: a request stuck in the queue past a p99-based hedge
    delay spawns a duplicate; the first copy to finish wins (its output
    lands on the original handle) and every other copy is cancelled;
  - ``BrownoutPolicy``: sustained queue-delay pressure shrinks the
    effective decode batch and sheds the lowest-deadline-slack queued
    requests (the ones least likely to make their cutoff) until pressure
    clears — with hysteresis so the engine doesn't flap.
"""
from __future__ import annotations

import math
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import kv_cache_specs
from repro_torch.core.metrics import percentile
from repro_torch.models.transformer import TransformerLM, pad_cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    submit_t: float = field(default_factory=time.monotonic)
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    deadline: Optional[float] = None      # absolute engine-clock cutoff
    shed: bool = False                    # dropped past its deadline
    timeout: Optional[float] = None       # relative budget (re-arms retries)
    attempt: int = 0                      # completed retry count
    eligible_t: float = 0.0               # backoff gate: not admissible before
    hedge_of: Optional[int] = None        # primary rid when this is a hedge

    @property
    def done(self) -> bool:
        return self.done_t is not None

    @property
    def ttft(self) -> Optional[float]:
        return (self.first_token_t - self.submit_t
                if self.first_token_t is not None else None)

    @property
    def latency(self) -> Optional[float]:
        return (self.done_t - self.submit_t
                if self.done_t is not None else None)


@dataclass(frozen=True)
class ServingConfig:
    capacity: int = 4                     # decode slots
    max_len: int = 256                    # per-slot KV capacity
    greedy: bool = True
    request_timeout: Optional[float] = None   # default per-request deadline


@dataclass(frozen=True)
class RetryPolicy:
    """Client-side timeout retries: a request whose deadline expires is
    reset and re-queued behind a deterministic backoff gate (crc32
    jitter, same discipline as ``resilience.policies``), at most
    ``max_retries`` times; its deadline re-arms to the backoff gate plus
    the original relative timeout."""
    max_retries: int = 2
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_max: float = 1.0
    jitter: float = 0.0

    def __post_init__(self) -> None:
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")
        if self.backoff_base < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff_base >= 0 and backoff_factor >= 1 "
                             "required")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def backoff(self, rid: int, attempt: int) -> float:
        delay = min(self.backoff_max,
                    self.backoff_base * self.backoff_factor ** (attempt - 1))
        if self.jitter > 0.0 and delay > 0.0:
            u = zlib.crc32(f"{rid}:{attempt}".encode()) / 0xFFFFFFFF
            delay *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return delay


@dataclass(frozen=True)
class HedgePolicy:
    """Hedged requests: a primary stuck in the queue longer than the
    hedge delay spawns a duplicate; first copy to finish wins, the rest
    are cancelled. The delay tracks the engine's own completed-latency
    p99 (the classic tail-tolerance heuristic) once ``min_samples``
    completions exist, floored at ``min_delay`` before that."""
    quantile: float = 99.0
    min_delay: float = 0.05
    max_hedges: int = 1
    min_samples: int = 16

    def __post_init__(self) -> None:
        if not 0.0 < self.quantile <= 100.0:
            raise ValueError("quantile must be in (0, 100]")
        if self.min_delay < 0.0:
            raise ValueError("min_delay must be >= 0")
        if self.max_hedges < 1 or self.min_samples < 1:
            raise ValueError("max_hedges and min_samples must be >= 1")

    def delay(self, latencies: List[float]) -> float:
        if len(latencies) < self.min_samples:
            return self.min_delay
        return max(self.min_delay, percentile(latencies, self.quantile))


@dataclass(frozen=True)
class BrownoutPolicy:
    """Queue-pressure degradation: when the oldest queued request has
    waited longer than ``queue_delay``, the engine enters brownout —
    the decode batch shrinks to ``min_capacity`` slots and queued
    requests with the least deadline slack (the ones least likely to
    make their cutoff) are shed until the queue fits — and exits once
    the oldest wait drops below ``exit_delay`` (hysteresis)."""
    queue_delay: float = 1.0
    min_capacity: int = 1
    exit_delay: float = 0.5

    def __post_init__(self) -> None:
        if not self.queue_delay > 0.0:
            raise ValueError("queue_delay must be positive")
        if self.min_capacity < 1:
            raise ValueError("min_capacity must be >= 1")
        if not 0.0 <= self.exit_delay <= self.queue_delay:
            raise ValueError("exit_delay must be in [0, queue_delay]")


class ServingEngine:
    def __init__(self, model: TransformerLM, params, scfg: ServingConfig,
                 best_effort_hook: Optional[Callable[[], None]] = None,
                 obs: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 retry: Optional[RetryPolicy] = None,
                 hedge: Optional[HedgePolicy] = None,
                 brownout: Optional[BrownoutPolicy] = None):
        if model.cfg.encoder_layers:
            # the reference's engine prefills token prompts alone and fails
            # in the encoder for want of its frame embeddings
            raise NotImplementedError(
                f"{model.cfg.name}: the serving engine prefills token "
                "prompts alone; the audio family's decoder needs the "
                "encoder's frame embeddings with each request, which "
                "neither this engine nor the reference's takes (call "
                "TransformerLM.prefill with encoder_embeds, then "
                "decode_step)")
        self.model = model
        self.params = params
        self.scfg = scfg
        self.cfg = model.cfg
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self.shed_requests: List[Request] = []
        self.be_hook = best_effort_hook
        self.be_quanta = 0
        # request-level robustness (all opt-in; None = off)
        self.retry = retry
        self.hedge = hedge
        self.brownout = brownout
        self.brownout_active = False
        self._next_rid = 0
        # primary rid -> {"primary": Request, "clones": [...], "spawned": n}
        self._hedge_group: Dict[int, Dict] = {}
        # injectable clock: tests drive deadlines deterministically with
        # a fake clock; production uses the wall monotonic clock
        self._clock = clock
        # optional telemetry, duck-typed (an object with ``serving()``, or
        # a probe with admitted/retired/...); observation-only and opt-in
        if obs is not None and hasattr(obs, "serving"):
            obs = obs.serving()
        self.obs = obs
        cap, T = scfg.capacity, scfg.max_len
        self._lengths = np.zeros(cap, np.int32)        # tokens in cache
        self._active = np.zeros(cap, bool)
        self._slot_req: List[Optional[Request]] = [None] * cap
        self._next_tok = np.zeros(cap, np.int32)
        self.device = params["embed"].device
        self.cache = self._empty_cache()
        # eager: the prefill and decode calls run as they are
        self._decode = self._decode_impl
        self._prefill = self.model.prefill

    # -- cache plumbing --------------------------------------------------------

    def _empty_cache(self) -> Dict[str, torch.Tensor]:
        specs = kv_cache_specs(self.cfg, self.scfg.capacity,
                               self.scfg.max_len)
        return {k: torch.zeros(shape, dtype=dtype, device=self.device)
                for k, (shape, dtype) in specs.items()}

    def _insert_slot(self, slot: int, req_cache: Dict[str, torch.Tensor]
                     ) -> None:
        """Write a prefilled (B=1) cache into slot `slot` (in place: the
        engine owns its cache)."""
        full = pad_cache(req_cache, self.scfg.max_len)
        for key, arr in full.items():
            tgt = self.cache[key]
            idx = (slice(None), slice(slot, slot + 1)) + tuple(
                slice(0, n) for n in arr.shape[2:])
            tgt[idx] = arr.to(tgt.dtype)

    def _decode_impl(self, params, tokens, cache, lengths):
        logits, new_cache = self.model.decode_step(
            params, tokens, cache, lengths)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, new_cache

    # -- public API --------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               timeout: Optional[float] = None) -> Request:
        now = self._clock()
        t_out = timeout if timeout is not None else self.scfg.request_timeout
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      submit_t=now, timeout=t_out,
                      deadline=None if t_out is None else now + t_out)
        self._next_rid += 1
        self.queue.append(req)
        return req

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    def _slack_key(self, req: Request, now: float) -> Tuple[float, int]:
        """EDF admission/shed order: least deadline slack first, requests
        without a deadline last, FIFO (rid) within ties."""
        slack = math.inf if req.deadline is None else req.deadline - now
        return (slack, req.rid)

    def _effective_capacity(self) -> int:
        if self.brownout is not None and self.brownout_active:
            return min(self.scfg.capacity, self.brownout.min_capacity)
        return self.scfg.capacity

    def _admit(self) -> bool:
        if not self.queue:
            return False
        if self.n_active >= self._effective_capacity():
            return False
        free = np.flatnonzero(~self._active)
        if len(free) == 0:
            return False
        slot = int(free[0])
        now = self._clock()
        ready = [r for r in self.queue if r.eligible_t <= now]
        if not ready:
            return False                  # every queued request backoff-gated
        req = min(ready, key=lambda r: self._slack_key(r, now))
        self.queue.remove(req)
        toks = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                               device=self.device)
        logits, cache = self._prefill(self.params, toks)
        self._insert_slot(slot, cache)
        first = int(torch.argmax(logits[0, -1]))
        req.tokens.append(first)
        req.first_token_t = self._clock()
        if self.obs is not None:
            self.obs.admitted(req.ttft)
        self._slot_req[slot] = req
        self._lengths[slot] = len(req.prompt)
        self._next_tok[slot] = first
        self._active[slot] = True
        return True

    def _free_slot(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._active[slot] = False
        self._lengths[slot] = 0

    def _cancel(self, req: Request) -> None:
        """Silently withdraw ``req`` from the queue or its slot (hedge
        first-wins cancellation — not a shed: no probe, no shed list)."""
        if req in self.queue:
            self.queue.remove(req)
            return
        for slot in np.flatnonzero(self._active):
            if self._slot_req[slot] is req:
                self._free_slot(slot)
                return

    def _resolve_group(self, primary: Request,
                       winner: Optional[Request]) -> None:
        """First-wins resolution of ``primary``'s hedge group: cancel
        every member other than ``winner`` (``None`` = the primary
        terminally failed; cancel all clones)."""
        group = self._hedge_group.pop(primary.rid, None)
        if group is None:
            return
        for clone in group["clones"]:
            if clone is winner or clone.done:
                continue
            self._cancel(clone)
            if self.obs is not None and hasattr(self.obs, "hedge"):
                self.obs.hedge("lost")
        if winner is not None and winner is not primary:
            self._cancel(primary)
            if self.obs is not None and hasattr(self.obs, "hedge"):
                self.obs.hedge("won")

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        assert req is not None
        self._free_slot(slot)
        now = self._clock()
        if req.hedge_of is not None:
            group = self._hedge_group.get(req.hedge_of)
            if group is None:
                return                        # orphaned clone: already lost
            primary = group["primary"]
            # the hedge won: its output lands on the caller's handle
            primary.tokens = list(req.tokens)
            primary.first_token_t = req.first_token_t
            req.done_t = now
            primary.done_t = now
            self._resolve_group(primary, winner=req)
            req = primary
        else:
            req.done_t = now
            self._resolve_group(req, winner=req)
        if self.obs is not None:
            self.obs.retired(req.latency)
        self.done.append(req)

    def _shed_one(self, req: Request, now: float, where: str) -> None:
        req.shed = True
        req.done_t = now
        self.shed_requests.append(req)
        self._resolve_group(req, winner=None)
        if self.obs is not None and hasattr(self.obs, "shed_request"):
            self.obs.shed_request(where)

    def _expire_one(self, req: Request, now: float, where: str) -> bool:
        """Deadline hit for ``req``: re-queue it under the retry policy
        (returns True — the caller keeps it out of queue/slot; the same
        ``Request`` handle re-enters the queue with tokens reset behind a
        deterministic backoff gate), or shed it terminally (returns
        False). Hedge clones never retry — their primary's budget does."""
        rp = self.retry
        if (rp is None or req.hedge_of is not None
                or req.timeout is None or req.attempt >= rp.max_retries):
            self._shed_one(req, now, where)
            return False
        req.attempt += 1
        req.tokens = []
        req.first_token_t = None
        req.eligible_t = now + rp.backoff(req.rid, req.attempt)
        req.deadline = req.eligible_t + req.timeout
        self.queue.append(req)
        if self.obs is not None and hasattr(self.obs, "retry"):
            self.obs.retry()
        return True

    def _shed_expired(self) -> int:
        """Deadline enforcement, checked at every step boundary: queued
        requests past their deadline are dropped without prefilling
        (or retried, with a ``RetryPolicy``), and slot-stuck ones (e.g.
        an EOS that never comes) are force-evicted so the slot frees
        instead of being occupied forever."""
        now = self._clock()
        n = 0
        if self.queue:
            keep: Deque[Request] = deque()
            expired: List[Request] = []
            for req in self.queue:
                if req.deadline is not None and now >= req.deadline:
                    expired.append(req)
                else:
                    keep.append(req)
            self.queue = keep
            for req in expired:
                self._expire_one(req, now, "queued")
                n += 1
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            if req is None:
                continue    # freed mid-loop by a hedge group resolution
            if req.deadline is not None and now >= req.deadline:
                self._free_slot(slot)
                self._expire_one(req, now, "slot")
                n += 1
        return n

    def _brownout_tick(self) -> bool:
        """Enter/exit brownout on queue-delay pressure (hysteresis) and,
        while active, shed the least-slack queued requests — the ones
        least likely to make their cutoff — until the queue fits the
        shrunk batch. Brownout sheds are terminal (no retry)."""
        bp = self.brownout
        if bp is None:
            return False
        now = self._clock()
        wait = max((now - r.submit_t for r in self.queue), default=0.0)
        changed = False
        if not self.brownout_active and wait > bp.queue_delay:
            self.brownout_active = True
            changed = True
            if self.obs is not None and hasattr(self.obs, "brownout"):
                self.obs.brownout("enter")
        elif self.brownout_active and wait < bp.exit_delay:
            self.brownout_active = False
            changed = True
            if self.obs is not None and hasattr(self.obs, "brownout"):
                self.obs.brownout("exit")
        if self.brownout_active:
            cap = self._effective_capacity()
            while len(self.queue) > cap:
                victim = min(self.queue,
                             key=lambda r: self._slack_key(r, now))
                self.queue.remove(victim)
                self._shed_one(victim, now, "brownout")
                changed = True
        return changed

    def _spawn_hedges(self) -> bool:
        """Spawn duplicates for primaries stuck in the queue longer than
        the p99-based hedge delay (first-wins; see ``HedgePolicy``)."""
        hp = self.hedge
        if hp is None or not self.queue:
            return False
        now = self._clock()
        delay = hp.delay([r.latency for r in self.done])
        spawned = False
        for req in list(self.queue):
            if req.hedge_of is not None or now - req.submit_t <= delay:
                continue
            group = self._hedge_group.get(req.rid)
            if group is not None and group["spawned"] >= hp.max_hedges:
                continue
            clone = Request(rid=self._next_rid, prompt=req.prompt,
                            max_new_tokens=req.max_new_tokens,
                            eos_id=req.eos_id, submit_t=now,
                            deadline=req.deadline, hedge_of=req.rid)
            self._next_rid += 1
            if group is None:
                group = {"primary": req, "clones": [], "spawned": 0}
                self._hedge_group[req.rid] = group
            group["clones"].append(clone)
            group["spawned"] += 1
            self.queue.append(clone)
            if self.obs is not None and hasattr(self.obs, "hedge"):
                self.obs.hedge("spawned")
            spawned = True
        return spawned

    def step(self) -> bool:
        """One engine iteration. Returns True if any work was done."""
        shed = self._shed_expired() > 0
        changed = self._brownout_tick()
        changed = self._spawn_hedges() or changed
        # admit as many as possible (priority: serving work first)
        admitted = False
        while self._admit():
            admitted = True
        if not self._active.any():
            if admitted or shed or changed:
                return True
            if self.be_hook is not None:
                # opportunistic best-effort quantum (Fig. 4 policy at the
                # engine level): only when the HP engine is fully idle
                self.be_hook()
                self.be_quanta += 1
                if self.obs is not None:
                    self.obs.be_quantum()
                return True
            return False
        tokens = torch.as_tensor(self._next_tok[:, None], dtype=torch.long,
                                 device=self.device)
        lengths = torch.as_tensor(self._lengths, device=self.device)
        next_tok, self.cache = self._decode(self.params, tokens,
                                            self.cache, lengths)
        next_np = next_tok.cpu().numpy()
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            if req is None:
                continue    # freed mid-loop by a hedge first-wins cancel
            tok = int(next_np[slot])
            req.tokens.append(tok)
            self._lengths[slot] += 1
            self._next_tok[slot] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            out_of_room = self._lengths[slot] + 1 >= self.scfg.max_len
            if (len(req.tokens) >= req.max_new_tokens or hit_eos
                    or out_of_room):
                self._retire(slot)
        if self.obs is not None:
            self.obs.slots(float(self._active.sum()))
        return True

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and not self._active.any():
                return
            self.step()
