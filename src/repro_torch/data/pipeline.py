"""Deterministic synthetic LM data pipeline (the port's copy of
``repro.data.pipeline``, pure numpy: ``batch_at`` is bit-equal to the
reference's).

Production shape without production data: a seeded, order-markov token
stream that is
  - deterministic per (seed, step, host_shard): restart-safe — resuming
    from step k reproduces exactly the batches a non-failed run would have
    seen (required by the fault-tolerance layer),
  - host-sharded: each host materializes only its slice of the global
    batch (`host_shard_slice`), the standard multi-pod input pattern,
  - double-buffered: a background thread prefetches `prefetch` batches so
    host input work overlaps device compute.

The synthetic distribution is a per-document power-law unigram mix with
short-range repetition, so cross-entropy actually *decreases* under
training (tests assert this) instead of the flat loss a uniform stream
gives.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2
    zipf_s: float = 1.3          # unigram skew
    repeat_p: float = 0.35       # P(copy a recent token) — learnable signal
    doc_len: int = 512


def host_shard_slice(global_batch: int, num_hosts: int, host_id: int
                     ) -> Tuple[int, int]:
    """[lo, hi) rows of the global batch owned by this host."""
    if global_batch % num_hosts != 0:
        raise ValueError(f"global_batch {global_batch} not divisible by "
                         f"num_hosts {num_hosts}")
    per = global_batch // num_hosts
    return host_id * per, (host_id + 1) * per


class SyntheticLMDataset:
    """Stateless batch generator: ``batch_at(step)`` is a pure function of
    (config, step) — the property checkpoint-restart relies on."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        lo, hi = host_shard_slice(cfg.global_batch, cfg.num_hosts,
                                  cfg.host_id)
        self.rows = (lo, hi)
        # fixed unigram distribution (shared across hosts)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_s)
        self.unigram = p / p.sum()
        self.perm = rng.permutation(cfg.vocab_size)   # stable token identity

    def _row_rng(self, step: int, row: int) -> np.random.Generator:
        # independent, reproducible stream per (step, global row)
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row]))

    def _sample_row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._row_rng(step, row)
        n = cfg.seq_len + 1
        base = self.perm[rng.choice(cfg.vocab_size, size=n, p=self.unigram)]
        toks = base.copy()
        # short-range repetition: copy one of the previous 8 tokens
        rep = rng.random(n) < cfg.repeat_p
        back = rng.integers(1, 9, size=n)
        for i in range(1, n):
            if rep[i]:
                toks[i] = toks[max(0, i - back[i])]
        return toks.astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        lo, hi = self.rows
        rows = np.stack([self._sample_row(step, r) for r in range(lo, hi)])
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Prefetcher:
    """Background-thread double buffering over ``batch_at``."""

    def __init__(self, ds: SyntheticLMDataset, start_step: int, depth: int):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.ds.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self.q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def build_pipeline(cfg: DataConfig, start_step: int = 0,
                   prefetch: Optional[bool] = None):
    """Dataset + (optionally) a prefetching iterator resuming at a step."""
    ds = SyntheticLMDataset(cfg)
    use_prefetch = cfg.prefetch > 0 if prefetch is None else prefetch
    if not use_prefetch:
        def gen():
            step = start_step
            while True:
                yield step, ds.batch_at(step)
                step += 1
        return ds, gen()
    return ds, _Prefetcher(ds, start_step, cfg.prefetch)
