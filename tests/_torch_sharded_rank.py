"""One rank of ``tests/test_torch_sharded_train.py``'s process groups (run
by ``repro_torch.launch.mesh.run_ranks``, which sets its rank, world size
and file store in the environment; imports nothing of JAX).

    python tests/_torch_sharded_rank.py JOB.json OUT_PREFIX

JOB.json holds ``model_parallel`` and a list of cases. A ``step`` case
runs ``make_train_step``'s sharded step for ``steps`` steps from the
parameters in its ``.npz`` (the JAX model's leaves in ``jax.tree``
order, carried across by ``params_from_jax``) on the seeded batches
``batch(vocab, step)``; a ``train`` case runs ``train()`` as the
one-process tests do: 12 steps, then 8 straight against 4, a checkpoint
and a resume, with the checkpoints left in ``dir``. Each rank writes
its results to OUT_PREFIX.<rank>.json.
"""
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.distributed.sharding import ShardGroup
from repro_torch.launch.mesh import init_from_env, make_host_mesh
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.launch.train import train
from repro_torch.models.transformer import build_model
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax


def batch(cfg, shape, step: int):
    """The global batch of ``step``, the same on every rank and in the
    reference's process: tokens and targets of one draw, and the inputs
    that the vlm and audio families take."""
    r = np.random.default_rng(1000 + step)
    b, s = shape.global_batch, shape.seq_len
    toks = r.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.mrope_sections is not None:
        out["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)).copy()
    if cfg.encoder_layers:
        out["encoder_embeds"] = r.standard_normal(
            (b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def case_config(case):
    return dataclasses.replace(get_config(case["arch"]).reduced(),
                               dtype=torch.float32,
                               optimizer=case["optimizer"])


def run_step_case(case, mesh, group):
    cfg = case_config(case)
    model = build_model(cfg)
    shape = ShapeConfig("t", case["seq"], case["batch"], "train")
    bundle = make_train_step(model, mesh, shape, lr=case["lr"], group=group)
    p_sh, o_sh, b_sh = bundle.in_shardings
    specs = bundle.abstract_inputs[2]
    with np.load(case["params"]) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    td = tree_flatten(model.param_shapes())[1]
    params = params_from_jax(tree_unflatten(td, leaves), "cpu")
    opt_state = make_optimizer(cfg, case["lr"]).init(params)
    params, opt_state = (group.layout(params, p_sh),
                         group.layout(opt_state, o_sh))
    losses, norms = [], []
    for step in range(case["steps"]):
        b = group.layout({k: torch.as_tensor(v, dtype=specs[k].dtype)
                          for k, v in batch(cfg, shape, step).items()},
                         b_sh)
        params, opt_state, m = bundle.sharded_fn(params, opt_state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    local = [t.to_local() for t in tree_leaves((params, opt_state, b))]
    return {"losses": losses, "grad_norms": norms,
            "argument_bytes": sum(t.numel() * t.element_size()
                                  for t in local),
            "devices": sorted({str(t.device) for t in local}),
            "dtensors": all(type(t).__name__ == "DTensor" for t in
                            tree_leaves((params, opt_state)))}


def run_train_case(case, mp):
    """``train()``'s driver cases on this group's mesh: 12 steps; with
    ``restart``, 8 steps straight against 4 + checkpoint + resume to 8.
    Rank 0 leaves the resumed run's final parameters beside the
    checkpoints."""
    kw = dict(seq=32, log_every=100, device="cpu", model_parallel=mp)
    twelve = train("mamba2-130m", steps=12, batch=4, **kw)
    keys = ("mesh", "rank", "losses", "first_loss", "last_loss",
            "loss_drop", "devices", "argument_bytes")
    out = {"twelve": {k: twelve[k] for k in keys}}
    if not case["restart"]:
        return out
    kw.update(steps=8, batch=2, lr=1e-2)
    straight = train("mamba2-130m", **kw)
    d = case["dir"]
    train("mamba2-130m", ckpt_dir=d, ckpt_every=4, total_steps=8,
          **{**kw, "steps": 4})
    resumed = train("mamba2-130m", ckpt_dir=d, ckpt_every=100,
                    resume=True, **kw)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(straight["params"]), tree_leaves(resumed["params"])))
    if twelve["rank"] == 0:
        np.savez(f"{d}/straight_params.npz",
                 **{f"leaf_{i}": t.numpy() for i, t in
                    enumerate(tree_leaves(resumed["params"]))})
    return {**out, "straight": straight["losses"],
            "resumed": resumed["losses"], "params_equal": same}


def main(job_path: str, out_prefix: str) -> None:
    torch.set_num_threads(1)
    init_from_env()
    with open(job_path) as f:
        job = json.load(f)
    mesh = make_host_mesh(job["model_parallel"], device="cpu")
    group = ShardGroup(mesh)
    out = {"rank": group.rank, "mesh": list(mesh.shape),
           "coords": group.coords, "cases": {}}
    for case in job["cases"]:
        if case["kind"] == "step":
            out["cases"][case["name"]] = run_step_case(case, mesh, group)
        else:
            out["cases"][case["name"]] = run_train_case(
                case, job["model_parallel"])
    with open(f"{out_prefix}.{group.rank}.json", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
