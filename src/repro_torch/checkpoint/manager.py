"""Sharded checkpointing: atomic, asynchronous, retention-managed (the
port of ``repro.checkpoint.manager``, on its on-disk layout).

Layout (one directory per step):

    <dir>/step_000000123/
        meta.json                  {step, num_hosts, n_leaves, treedef}
        shard_00000.npz            this host's leaves (leaf_{i} -> array)
    <dir>/step_000000123.done      commit marker (atomicity)

The leaves are numbered in ``jax.tree.flatten``'s order (``repro_torch.
tree``), so a checkpoint written by either package restores in the other:
restore checks the leaf count and shapes, never the ``treedef`` string,
which each package writes in its own words. A bf16 leaf is stored as the
JAX package's ``np.savez`` stores one (2-byte void, ``|V2``) and read
back as its bits.

  - **Atomic commit**: shards are written to ``step_k.tmp``, the dir is
    renamed and a ``.done`` marker placed: a crash mid-write never yields
    a checkpoint that ``latest_step`` would pick up.
  - **Async save**: ``save_async`` copies the leaves to host memory
    synchronously and writes them in a background thread.
  - **Retention**: keep the newest ``keep`` checkpoints, always retaining
    step-aligned "milestone" checkpoints (``keep_every``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

BF16_DISK = np.dtype("V2")     # how np.savez stores an ml_dtypes bfloat16


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    keep_every: int = 0            # 0 = no milestones
    host_id: int = 0
    num_hosts: int = 1


def _step_dir(base: Path, step: int) -> Path:
    return base / f"step_{step:09d}"


def to_numpy(x) -> np.ndarray:
    """A leaf on the host; a bf16 tensor as its 2-byte bit patterns."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16_DISK)
        return x.numpy()
    return np.asarray(x)


def from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on its device (a
    ``|V2`` leaf read as bf16 bits)."""
    if a.dtype == BF16_DISK:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype)


def save(cfg: CheckpointConfig, step: int, tree) -> Path:
    """Synchronous sharded save with atomic commit."""
    base = Path(cfg.directory)
    base.mkdir(parents=True, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    leaves = [to_numpy(x) for x in leaves]
    final = _step_dir(base, step)
    tmp = Path(str(final) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / f"shard_{cfg.host_id:05d}.npz",
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    meta = {"step": step, "num_hosts": cfg.num_hosts,
            "n_leaves": len(leaves), "treedef": repr(treedef)}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    done = Path(str(final) + ".done")
    done.write_text(str(step))
    _apply_retention(cfg)
    return final


def restore(cfg: CheckpointConfig, like, step: Optional[int] = None):
    """Restore into the structure of ``like`` (a tree of tensors: each leaf
    comes back in its dtype, on its device). Returns (step, tree)."""
    base = Path(cfg.directory)
    if step is None:
        step = latest_step(cfg)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {base}")
    d = _step_dir(base, step)
    meta = json.loads((d / "meta.json").read_text())
    leaves_like, treedef = tree_flatten(like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                         f"expected {len(leaves_like)}")
    with np.load(d / f"shard_{cfg.host_id:05d}.npz") as z:
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    out = []
    for got, want in zip(leaves, leaves_like):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch: {got.shape} vs "
                             f"{tuple(want.shape)}")
        out.append(from_numpy(got, want))
    return step, tree_unflatten(treedef, out)


def _all_steps(cfg: CheckpointConfig) -> List[int]:
    base = Path(cfg.directory)
    if not base.exists():
        return []
    steps = []
    for p in base.glob("step_*.done"):
        try:
            steps.append(int(p.stem.split("_")[1].split(".")[0]))
        except (IndexError, ValueError):
            continue
    return sorted(steps)


def latest_step(cfg: CheckpointConfig) -> Optional[int]:
    steps = _all_steps(cfg)
    return steps[-1] if steps else None


def _apply_retention(cfg: CheckpointConfig) -> None:
    steps = _all_steps(cfg)
    if cfg.keep <= 0 or len(steps) <= cfg.keep:
        return
    base = Path(cfg.directory)
    for s in steps[:-cfg.keep]:
        if cfg.keep_every and s % cfg.keep_every == 0:
            continue          # milestone
        d = _step_dir(base, s)
        Path(str(d) + ".done").unlink(missing_ok=True)
        if d.exists():
            shutil.rmtree(d)


class CheckpointManager:
    """Async wrapper with one in-flight write (a second save waits for the
    first)."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree) -> None:
        self.wait()
        # snapshot to host synchronously (a copy: a CPU tensor's numpy view
        # shares its memory), so the caller may change the tensors at once
        leaves, treedef = tree_flatten(tree)
        host_tree = tree_unflatten(treedef,
                                   [np.array(to_numpy(x)) for x in leaves])

        def work():
            try:
                save(self.cfg, step, host_tree)
            except BaseException as e:    # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree) -> Path:
        self.wait()
        return save(self.cfg, step, tree)

    def restore(self, like, step: Optional[int] = None):
        self.wait()
        return restore(self.cfg, like, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.cfg)
