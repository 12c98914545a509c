"""One rank of ``tests/test_torch_sharded_serving.py``'s process groups (run
by ``repro_torch.launch.mesh.run_ranks``, which sets its rank, world size
and file store in the environment; imports nothing of JAX).

    python tests/_torch_sharded_serving_rank.py JOB.json OUT_PREFIX

JOB.json holds ``model_parallel`` and a list of cases. Each case runs
``make_prefill_step``'s and ``make_decode_step``'s ``sharded_fn`` from
the parameters in its ``.npz`` (the JAX model's leaves in ``jax.tree``
order, carried across by ``params_from_jax`` and cast to the model
dtype, each rank keeping its shards): the prefill of ``inputs(...)``'s
prompts, the cache resharded and padded to the decode capacity
(``decode_cache``), then one decode step per entry of ``indices``. Rank
0 writes the gathered logits and every cache leaf of each step to
OUT_PREFIX.<case>.npz; every rank writes its bytes (``cache_index`` as
the bundle's abstract scalar where the model reads it) and whether each
weight is held as its shard to OUT_PREFIX.<rank>.json.
"""
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.distributed.sharding import ShardGroup
from repro_torch.launch.mesh import init_from_env, make_host_mesh
from repro_torch.launch.steps import (decode_cache, make_decode_step,
                                      make_prefill_step)
from repro_torch.models.transformer import build_model
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)
from repro_torch.weights import params_from_jax

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def case_config(case):
    return dataclasses.replace(get_config(case["arch"]).reduced(),
                               dtype=DTYPES[case["dtype"]],
                               use_pallas=case.get("use_pallas", False))


def inputs(cfg, case):
    """The prefill's batch and each decode step's (numpy, as
    ``input_specs`` lays them out; the decode steps' cache apart):
    seeded tokens, M-RoPE positions for the vlm family, and each step's
    ``cache_index`` (a scalar or per-slot lengths)."""
    rng = np.random.default_rng(7)
    B, S = case["batch"], case["prompt"]
    pre = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(B, S)).astype(np.int32)}
    if cfg.mrope_sections is not None:
        base = np.arange(S, dtype=np.int32)
        pre["positions"] = np.stack([base, base // 2, base % 3])[:, None] \
            .repeat(B, axis=1).astype(np.int32)
    steps = []
    for idx in case["indices"]:
        ci = np.asarray(idx, dtype=np.int32)
        d = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, 1)).astype(np.int32),
             "cache_index": ci}
        if cfg.mrope_sections is not None:
            at = np.broadcast_to(ci, (B,)).astype(np.int32)
            d["positions"] = np.stack([at, at // 2, at % 3])[:, :, None]
        steps.append(d)
    return pre, steps


def load_params(model, path, dtype):
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    td = tree_flatten(model.param_shapes())[1]
    return tree_map(lambda t: t.to(dtype),
                    params_from_jax(tree_unflatten(td, leaves), "cpu"))


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in (x.to_local() if hasattr(x, "to_local") else x
                         for x in tree_leaves(tree)))


def run_case(case, mesh, group, out_prefix):
    cfg = case_config(case)
    model = build_model(cfg)
    B, S, T = case["batch"], case["prompt"], case["capacity"]
    pre = make_prefill_step(model, mesh, ShapeConfig("p", S, B, "prefill"),
                            group)
    dec = make_decode_step(model, mesh, ShapeConfig("d", T, B, "decode"),
                           group)
    p_sh = pre.in_shardings[0]
    params = group.layout(load_params(model, case["params"], cfg.dtype),
                          p_sh)
    shards_ok = all(
        tuple(t.to_local().shape) == s.shard_shape(t.shape)
        for t, s in zip(tree_leaves(params), tree_leaves(p_sh)))
    pb, steps = inputs(cfg, case)
    batch = group.layout({k: torch.as_tensor(v) for k, v in pb.items()},
                         pre.in_shardings[1])
    out = {"argument_bytes": {"prefill": _bytes((params, batch))},
           "shards_ok": shards_ok}
    logits, cache = pre.sharded_fn(params, batch)
    whole = {"prefill/logits": group.gather(logits, pre.out_shardings[0])}
    whole.update({f"prefill/{k}": v for k, v in group.gather(
        cache, pre.out_shardings[1]).items()})
    cache = decode_cache(cache, pre, dec, group)
    d_sh = dec.in_shardings[1]
    for i, d in enumerate(steps):
        ci = torch.as_tensor(d.pop("cache_index"))
        db = group.layout({k: torch.as_tensor(v) for k, v in d.items()},
                          {k: d_sh[k] for k in d})
        db.update(cache=cache, cache_index=ci)
        if i == 0:     # cache_index as the bundle's scalar, if read
            out["argument_bytes"]["decode"] = _bytes(
                (params, {k: v for k, v in db.items()
                          if k != "cache_index"})) + 4 * ("k" in cache)
        logits, cache = dec.sharded_fn(params, db)
        whole[f"decode{i}/logits"] = group.gather(logits,
                                                  dec.out_shardings[0])
        whole.update({f"decode{i}/{k}": v for k, v in group.gather(
            cache, dec.out_shardings[1]).items()})
    if group.rank == 0:
        np.savez(f"{out_prefix}.{case['name'].replace('/', '_')}.npz",
                 **{k: v.float().numpy() for k, v in whole.items()})
    return out


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
        out["cases"][case["name"]] = run_case(case, mesh, group, out_prefix)
    with open(f"{out_prefix}.{group.rank}.json", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
