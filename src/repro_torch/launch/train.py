"""Training driver (the port of ``repro.launch.train``): real steps on one
card, or on the CPU when asked, or sharded over a process group of one
process per device.

Reduced configs by default (examples, smoke tests); ``--full`` takes the
full config, as ``examples/train_lm.py`` does for the ~100 M end-to-end
run of mamba2-130m. Integrates the deterministic data pipeline,
checkpoint/restart, heartbeats and the straggler log. ``--nproc N`` runs
N ranks of one gloo group on this host (``mesh.run_ranks``) on a
(N // k, k) mesh for ``--model-parallel k``, and prints each rank's
result.

    python -m repro_torch.launch.train --arch mamba2-130m --device cpu
    python -m repro_torch.launch.train --arch mamba2-130m --full \\
        --steps 300 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch mamba2-130m --device cpu \\
        --nproc 2 --model-parallel 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs.base import ShapeConfig, all_arch_names, get_config
from repro_torch.data import DataConfig, build_pipeline
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerDetector)
from repro_torch.distributed.sharding import ShardGroup
from repro_torch.launch.mesh import (RANK_ENV, init_from_env, local_device,
                                     make_host_mesh, run_ranks)
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.transformer import build_model
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.tree import tree_leaves


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          reduced: bool = True, lr: float = 3e-3,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          resume: bool = False, seed: int = 0, num_microbatches: int = 1,
          log_every: int = 10, model_parallel: int = 1,
          total_steps: Optional[int] = None,
          device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
    """``total_steps`` fixes the LR-schedule horizon independently of this
    invocation's ``steps`` so a checkpoint-restart run matches a straight
    run exactly (defaults to ``steps``). The mesh is the reference's,
    ``make_host_mesh(model_parallel)``: (n // k, k) over the n processes
    of this run's group (one per device) with the model axis k clamped
    to them, so a single process trains on a (1, 1) mesh however many
    cards the host holds. On a mesh of more than one process, every rank
    draws the same global batch and lays it out by the step's shardings,
    as it lays out the parameters and optimizer state
    (``ShardGroup.layout``; the step is ``make_train_step``'s sharded
    one); only rank 0 logs, and rank 0 writes each checkpoint, once, from
    the gathered state in ``CheckpointManager``'s format, which every
    rank restores and lays out again. Returns the reference's keys, equal
    on every rank (``params`` whole), plus ``device``, ``step_ms`` (host
    ms of each step, ending in a synchronize), ``mesh``, ``rank``,
    ``comm_ms`` (host ms of each step's all-reduces),
    ``argument_bytes`` (the bytes this rank holds of the parameters,
    optimizer state and last batch) and ``devices`` (where they lie)."""
    dev = resolve_device(device)
    mesh = make_host_mesh(model_parallel, device=dev)
    group = None
    if mesh.size > 1:
        dev = local_device(mesh)
        group = ShardGroup(mesh, dev)
    rank = 0 if group is None else group.rank
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    shape = ShapeConfig("driver", seq, batch, "train")
    horizon = total_steps or steps
    sched = linear_warmup_cosine(max(horizon // 20, 1), horizon)
    bundle = make_train_step(model, mesh, shape, schedule=sched,
                             num_microbatches=num_microbatches, lr=lr,
                             group=group)
    p_sh, o_sh, b_sh = bundle.in_shardings
    specs = bundle.abstract_inputs[2]
    params = model.init(seed, device=dev)
    opt_state = make_optimizer(cfg, lr).init(params)

    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(CheckpointConfig(ckpt_dir))
        if resume and mgr.latest_step() is not None:
            start_step, (params, opt_state) = mgr.restore(
                (params, opt_state))
            start_step += 1
            if rank == 0:
                print(f"[train] resumed from step {start_step - 1}")
    if group is not None:
        params = group.layout(params, p_sh)
        opt_state = group.layout(opt_state, o_sh)

    def whole():
        """(params, opt_state) whole, on every rank."""
        if group is None:
            return params, opt_state
        return group.gather((params, opt_state), (p_sh, o_sh))

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed)
    _, it = build_pipeline(dcfg, start_step=start_step)

    hb = HeartbeatMonitor(timeout=60.0)
    straggle = StragglerDetector()
    losses, step_ms, comm_ms = [], [], []
    dev_batch = {}
    t_start = time.time()
    try:
        for step in range(start_step, steps):
            got_step, host_batch = next(it)
            assert got_step == step, (got_step, step)
            if group is None:
                dev_batch = {k: torch.as_tensor(v, dtype=torch.long,
                                                device=dev)
                             for k, v in host_batch.items()}
            else:
                dev_batch = group.layout(
                    {k: torch.as_tensor(v, dtype=specs[k].dtype)
                     for k, v in host_batch.items()}, b_sh)
                comm0 = group.comm_s
            t0 = time.monotonic()
            params, opt_state, metrics = (bundle.sharded_fn or bundle.fn)(
                params, opt_state, dev_batch)
            synchronize(dev)
            dt = time.monotonic() - t0
            loss = float(metrics["loss"])
            hb.beat(rank, time.time())
            straggle.record(rank, dt)
            losses.append(loss)
            step_ms.append(dt * 1e3)
            if group is not None:
                comm_ms.append((group.comm_s - comm0) * 1e3)
            if rank == 0 and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms", flush=True)
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                state = whole()
                if rank == 0:
                    mgr.save_async(step, state)
    finally:
        if hasattr(it, "close"):
            it.close()
        if mgr:
            mgr.wait()
    final = whole()
    if mgr and rank == 0:
        mgr.save(steps - 1, final)
    if group is not None:
        torch.distributed.barrier()   # the checkpoint is there for all
    held = tree_leaves((params, opt_state, dev_batch))
    local = [t.to_local() if group is not None else t for t in held]
    wall = time.time() - t_start
    return {"arch": arch, "steps": steps, "first_loss": losses[0],
            "last_loss": losses[-1],
            "loss_drop": losses[0] - losses[-1],
            "wall_s": wall, "params": final[0], "losses": losses,
            "device": str(dev), "step_ms": step_ms,
            "mesh": list(mesh.shape), "rank": rank, "comm_ms": comm_ms,
            "argument_bytes": sum(t.numel() * t.element_size()
                                  for t in local),
            "devices": sorted({str(t.device) for t in local})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=all_arch_names(), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks of one gloo group on this host, each on "
                         "its own process (every rank on cuda:0 on a host "
                         "of one card)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds the ranks of --nproc may take")
    args = ap.parse_args(argv)
    if args.nproc > 1 and RANK_ENV not in os.environ:
        argv = sys.argv[1:] if argv is None else list(argv)
        ranks = run_ranks([sys.executable, "-m", "repro_torch.launch.train",
                           *argv], args.nproc, args.timeout)
        for r, (code, out, err) in enumerate(ranks):
            if code != 0:
                print(f"[train] rank {r} exited {code}:\n{err[-4000:]}",
                      file=sys.stderr)
        print(ranks[0][1], end="")
        print(json.dumps([json.loads(out.strip().splitlines()[-1])
                          if code == 0 else None
                          for code, out, _ in ranks]))
        return max(abs(code) for code, _, _ in ranks)
    init_from_env()
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                reduced=args.reduced, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                num_microbatches=args.microbatches,
                model_parallel=args.model_parallel, device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "params"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
