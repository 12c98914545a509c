"""Serving driver: batched inference on a reduced model (the port of
``repro.launch.serve``).

The paper's end-to-end scenario on real (reduced) models: a high-priority
serving engine handles MAF2-style traffic while a best-effort training job
(``--colocate-train``) takes one train step in each idle quantum through
the engine's opportunistic hook: the engine-level mirror of Fig. 4 (the
kernel-level path is ``core.virtualization``).

    python -m repro_torch.launch.serve --arch qwen2.5-14b --requests 24 \
        --colocate-train

Request-level resilience: ``--chaos`` injects a mid-run outage (the engine
blocks, queued requests blow their per-request timeout); ``--failover``
arms the client-side failover stack — timeout retries with deterministic
backoff, hedged requests, brownout degradation — so the outage degrades
latency instead of losing requests. Runs on the card unless ``--device
cpu``. Every family but audio is served; the audio family's engine
refuses it (its decoder needs frame embeddings with each request, which
the reference's engine does not pass either).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, all_arch_names, get_config
from repro_torch.core.metrics import LatencyStats
from repro_torch.core.traffic import maf2_like_trace
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.transformer import TransformerLM, build_model
from repro_torch.serving import (BrownoutPolicy, HedgePolicy, RetryPolicy,
                                 ServingConfig, ServingEngine)


class BestEffortTrainer:
    """The co-located best-effort job: each call is one train step of
    ``model`` (parameters drawn from ``seed + 1``, the optimizer that
    ``model.cfg.optimizer`` names) on batch ``quanta`` of a synthetic
    dataset seeded with ``seed``, as the reference's ``be_step``. It runs
    on the serving process's one device, in a process group or not (the
    reference's trainer steps on ``make_host_mesh()``, every device of
    the host)."""

    def __init__(self, model: TransformerLM, *, batch: int = 2,
                 seq: int = 32, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.step_fn = make_train_step(
            model, Mesh(("data", "model"), (1, 1), self.device.type),
            ShapeConfig("be", seq, batch, "train")).fn
        self.params = model.init(seed + 1, device=self.device)
        self.opt_state = make_optimizer(model.cfg).init(self.params)
        self.data = SyntheticLMDataset(DataConfig(model.cfg.vocab_size, seq,
                                                  batch, seed=seed))
        self.quanta = 0
        self.losses = []

    def __call__(self) -> None:
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=self.device)
                 for k, v in self.data.batch_at(self.quanta).items()}
        self.params, self.opt_state, m = self.step_fn(
            self.params, self.opt_state, batch)
        self.losses.append(m["loss"])
        self.quanta += 1


def failover_policies(timeout: float, capacity: int
                      ) -> Tuple[RetryPolicy, HedgePolicy, BrownoutPolicy]:
    """``serve``'s client-side failover stack for a request budget of
    ``timeout`` seconds on an engine of ``capacity`` slots."""
    # thresholds scale off the request budget: retries re-arm fast,
    # hedges fire at half a budget of queue wait, brownout only under
    # pressure far beyond one budget (it sheds terminally)
    return (RetryPolicy(max_retries=3, backoff_base=0.1, backoff_factor=2.0,
                        jitter=0.25),
            HedgePolicy(min_delay=timeout / 2),
            BrownoutPolicy(queue_delay=3.0 * timeout,
                           min_capacity=max(1, capacity // 2),
                           exit_delay=1.5 * timeout))


def drive(engine: ServingEngine, vocab_size: int, *, requests: int,
          max_new_tokens: int, seed: int = 0, mean_rate: float = 50.0,
          chaos: bool = False, stall_s: float = 8.0) -> float:
    """``serve``'s request loop: ``requests`` prompts of 4 to 11 tokens
    drawn from ``seed``, submitted to ``engine`` at the arrivals of a
    MAF2-like trace, the engine stepped until it is idle (with ``chaos``,
    dark for ``stall_s`` seconds once half the requests are in). Returns
    the wall seconds."""
    rng = np.random.default_rng(seed)
    trace = maf2_like_trace(duration=requests / mean_rate * 2,
                            mean_rate=mean_rate, seed=seed)
    arrivals = trace.arrivals[:requests]
    t0 = time.monotonic()
    submitted = 0
    stall_after = len(arrivals) // 2 if chaos else None
    while submitted < len(arrivals) or engine.queue or engine.n_active:
        now = time.monotonic() - t0
        while submitted < len(arrivals) and arrivals[submitted] <= now:
            prompt = rng.integers(0, vocab_size,
                                  size=int(rng.integers(4, 12)))
            engine.submit(prompt.astype(np.int32),
                          max_new_tokens=max_new_tokens)
            submitted += 1
        if stall_after is not None and submitted >= stall_after:
            # injected outage: the engine goes dark mid-run; everything
            # queued/in-flight blows its per-request timeout
            stall_after = None
            time.sleep(stall_s)
        if not engine.step():
            time.sleep(0.001)
    return time.monotonic() - t0


def serve(arch: str, *, requests: int = 16, capacity: int = 4,
          max_len: int = 96, max_new_tokens: int = 8,
          colocate_train: bool = False, seed: int = 0,
          mean_rate: float = 50.0, obs=None,
          timeout: Optional[float] = None, chaos: bool = False,
          failover: bool = False, stall_s: float = 8.0,
          device: Union[str, torch.device, None] = None) -> dict:
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    dev = resolve_device(device)
    params = model.init(seed, device=dev)
    be = (BestEffortTrainer(model, seed=seed, device=dev) if colocate_train
          else None)

    if chaos and timeout is None:
        # chaos without deadlines is invisible; the default budget sits
        # above the baseline p99 (queueing-dominated) but below the
        # injected outage, so only outage victims time out
        timeout = 6.0
    retry = hedge = brownout = None
    if failover and timeout is not None:
        retry, hedge, brownout = failover_policies(timeout, capacity)
    engine = ServingEngine(model, params,
                           ServingConfig(capacity, max_len,
                                         request_timeout=timeout),
                           best_effort_hook=be, obs=obs, retry=retry,
                           hedge=hedge, brownout=brownout)
    wall = drive(engine, cfg.vocab_size, requests=requests,
                 max_new_tokens=max_new_tokens, seed=seed,
                 mean_rate=mean_rate, chaos=chaos, stall_s=stall_s)
    lat = LatencyStats()
    for r in engine.done:
        lat.record(r.latency)
    return {
        "arch": arch,
        "requests": len(engine.done),
        "shed": len(engine.shed_requests),
        "retries": sum(r.attempt for r in engine.done
                       + engine.shed_requests),
        "p50_ms": lat.p50() * 1e3,
        "p99_ms": lat.p99() * 1e3,
        "be_quanta": 0 if be is None else be.quanta,
        "wall_s": wall,
        "device": str(params["embed"].device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=all_arch_names(),
                    default="qwen2.5-14b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--colocate-train", action="store_true",
                    help="a best-effort trainer takes one step in each "
                         "idle quantum of the engine")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a mid-run engine outage (arms per-request "
                         "timeouts)")
    ap.add_argument("--failover", action="store_true",
                    help="client-side failover stack: timeout retries, "
                         "hedged requests, brownout degradation")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request timeout in seconds")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = serve(args.arch, requests=args.requests, capacity=args.capacity,
                max_new_tokens=args.max_new_tokens,
                colocate_train=args.colocate_train, chaos=args.chaos,
                failover=args.failover, timeout=args.timeout,
                device=args.device)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
