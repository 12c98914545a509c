"""Training driver (the port of ``repro.launch.train``): real steps on one
card, or on the CPU when asked.

Reduced configs by default (examples, smoke tests); ``--full`` takes the
full config, as ``examples/train_lm.py`` does for the ~100 M end-to-end
run of mamba2-130m. Integrates the deterministic data pipeline,
checkpoint/restart, heartbeats and the straggler log.

    python -m repro_torch.launch.train --arch mamba2-130m --device cpu
    python -m repro_torch.launch.train --arch mamba2-130m --full \\
        --steps 300 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs.base import ShapeConfig, all_arch_names, get_config
from repro_torch.data import DataConfig, build_pipeline
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerDetector)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.transformer import build_model
from repro_torch.optim.schedule import linear_warmup_cosine


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
    ``make_host_mesh(model_parallel)``: the model axis clamped to the
    devices of this run (one per process), so a single process trains on
    a (1, 1) mesh with any ``model_parallel`` on a host of any number of
    cards, and a larger mesh is refused. Returns the reference's keys
    plus ``device`` and ``step_ms`` (host ms of each step, ending in a
    synchronize)."""
    dev = resolve_device(device)
    mesh = make_host_mesh(model_parallel, device=dev)
    if mesh.size > 1:
        raise NotImplementedError(
            f"training sharded over the {mesh.size} processes of {mesh} is "
            "not ported (it needs the parameters as DTensors); run one "
            "process")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    shape = ShapeConfig("driver", seq, batch, "train")
    horizon = total_steps or steps
    sched = linear_warmup_cosine(max(horizon // 20, 1), horizon)
    step_fn = make_train_step(model, mesh, shape, schedule=sched,
                              num_microbatches=num_microbatches, lr=lr).fn
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
            print(f"[train] resumed from step {start_step - 1}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed)
    _, it = build_pipeline(dcfg, start_step=start_step)

    hb = HeartbeatMonitor(timeout=60.0)
    straggle = StragglerDetector()
    losses, step_ms = [], []
    t_start = time.time()
    try:
        for step in range(start_step, steps):
            got_step, host_batch = next(it)
            assert got_step == step, (got_step, step)
            dev_batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                         for k, v in host_batch.items()}
            t0 = time.monotonic()
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 dev_batch)
            synchronize(dev)
            dt = time.monotonic() - t0
            loss = float(metrics["loss"])
            hb.beat(0, time.time())
            straggle.record(0, dt)
            losses.append(loss)
            step_ms.append(dt * 1e3)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms", flush=True)
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save_async(step, (params, opt_state))
    finally:
        if hasattr(it, "close"):
            it.close()
        if mgr:
            mgr.wait()
    if mgr:
        mgr.save(steps - 1, (params, opt_state))
    wall = time.time() - t_start
    return {"arch": arch, "steps": steps, "first_loss": losses[0],
            "last_loss": losses[-1],
            "loss_drop": losses[0] - losses[-1],
            "wall_s": wall, "params": params, "losses": losses,
            "device": str(dev), "step_ms": step_ms}


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
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                reduced=args.reduced, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                num_microbatches=args.microbatches,
                model_parallel=args.model_parallel, device=args.device)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("params", "losses", "step_ms")},
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
