"""Dry run: every (arch x shape x mesh) cell priced at H100 rates (the port
of ``repro.launch.dryrun``).

The reference compiles each cell with XLA's SPMD partitioner on 512 fake
host devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
collectives of the optimized HLO. Torch has no partitioner, so the port's
dry run is a cost model over the steps of ``launch.steps``: each step runs
once on its abstract inputs (meta tensors: shapes and dtypes, no storage,
no card) on the path the reference prices (``exact_costs``: attention
without the chunk scan, FLOP for FLOP the Pallas kernel's), and

  FLOPs       come from ``torch.utils.flop_counter.FlopCounterMode``
              (matrix products; torch runs a product with no contraction
              as an elementwise multiply, which it does not count), per
              device as the global count over the mesh size: compute
              that the partitioner would replicate is not modeled;
  bytes       are the operand and result bytes of every aten op that
              moves data (views move none), summed by a dispatch mode and
              divided by the mesh size: what the eager step moves if
              each op reads its operands from memory once and writes its
              result there once. It is no bound either way: a tiled
              matmul rereads its operands, the L2 cache saves rereads,
              and a compiler that fuses elementwise chains saves their
              round trips;
  memory      per device: the arguments are the shard bytes of the
              abstract inputs that the step reads, under ``in_shardings``
              (equal to the reference's ``argument_size_in_bytes``); the
              outputs the shard bytes of the step's outputs under
              ``out_shardings`` and XLA's 8-byte pointer a leaf (equal to
              its ``output_size_in_bytes``);
              the aliases the donated inputs that an output of the same
              shard shape and dtype can reuse; the temporaries an
              ESTIMATE: the peak of the bytes of the storages made during
              the step that are alive at once (tracked on the meta
              storages), less those the outputs hold at its end, over the
              mesh size (``temporaries``: a serving step's on the
              kernels' path at full depth, a train step's from the depth
              probe);
  collectives are modeled from the shardings, not parsed from a program
              (``collective_terms``): the FSDP all-gather of every
              parameter leaf sharded over the data axes (forward and
              backward) and the gradient reduce-scatter (all-reduce where
              a leaf is not sharded over them); the tensor-parallel
              reduction of every projection whose contracting dim is
              sharded over ``model`` (reduce-scatter plus all-gather of
              the residual stream under sequence parallelism,
              ``REPRO_OPT_SP=1``, else an all-reduce), and the all-gather
              of a residual-stream output sharded over ``model`` (the
              serving steps' fallback); the MoE dispatch and combine
              (all-to-all over the expert axes); the vocab-sharded
              embedding lookup and cross-entropy. Bytes are the result
              bytes per device, x2 for an all-reduce, as the reference
              counts them. A train step's activation collectives run in
              the forward, the remat recompute and the backward.
              Sequence-sharded decode attention's small reductions are
              not modeled.

A collective over a group of mesh axes is priced at the NVLink rate when
the group fits inside one node of 8 consecutive devices (the devices
numbered row-major over the mesh, as ``Mesh.device_mesh`` numbers them),
and at the InfiniBand rate otherwise: on the production meshes every
group of 16 crosses nodes.

``probe_costs`` is the reference's depth probe: the step at one layer
period and at two, extrapolated to the trip count. The port's stack is a
Python loop, so a full-depth count is exact too, but slow where the SSD
chunk loop runs (about a minute for a jamba-1.5-large prefill); FLOPs,
bytes, outputs, aliases and collectives are linear in depth, so the probe
equals the full count.

Usage (CPU-only; imports no JAX):
    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      all_arch_names, get_config,
                                      shape_applicable)
from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              is_axes_leaf, use_mesh)
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_info
from repro_torch.launch.steps import StepBundle, make_step
from repro_torch.models.moe import _capacity as moe_capacity
from repro_torch.models.transformer import build_model, layer_period
from repro_torch.tree import tree_leaves

# NVIDIA H100 SXM5 80GB, data-sheet figures (not measurements): the
# roofline's denominators, per device
DEVICE = "NVIDIA H100 SXM5 80GB (data sheet)"
PEAK_FLOPS = 989e12            # bf16 dense
HBM_BW = 3.35e12               # bytes/s
HBM_BYTES = 80 * 2 ** 30
NVLINK_BW = 450e9              # bytes/s per direction per GPU, in a node
IB_BW = 50e9                   # bytes/s per GPU across nodes (NDR)
NODE_DEVICES = 8               # GPUs per NVLink node

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_DATA_AXES = ("pod", "data")
# aten ops that move no data: their outputs alias their inputs
_FREE = {torch.ops.aten._unsafe_view.default,
         torch.ops.aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# Counting one step on meta tensors
# ---------------------------------------------------------------------------


class _BytesMode(TorchDispatchMode):
    """Sums the operand and result bytes of every aten op that moves data,
    and tracks the bytes of the storages made under it that are alive at
    once (a storage leaves the count when the last tensor on it dies)."""

    def __init__(self, inputs=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        leaves = list(_tensors(inputs))
        self._inputs = {id(t): i for i, t in enumerate(leaves)}
        self.used: set = set()          # flat indices of the inputs read
        self._refs: Dict[int, Optional[weakref.ref]] = {
            t.untyped_storage()._cdata: None for t in leaves}

    def _free(self, key: int, nbytes: int) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = list(_tensors((args, kwargs or {})))
        self.used.update(self._inputs[id(t)] for t in ins
                         if id(t) in self._inputs)
        if func.is_view or func in _FREE:
            return out
        outs = list(_tensors(out))
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._free(key, n))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def shard_bytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    """One device's bytes of ``t`` under ``sharding``."""
    return math.prod(sharding.shard_shape(t.shape)) * t.element_size()


def _sharded_bytes(tree, shardings) -> int:
    return sum(shard_bytes(t, s)
               for t, s in zip(tree_leaves(tree), tree_leaves(shardings)))


def argument_bytes(bundle: StepBundle, used=None) -> int:
    """Per-device bytes of the step's inputs under ``in_shardings``; with
    ``used`` (flat leaf indices), only those: ``jax.jit`` drops an input
    that the step never reads (``keep_unused=False``), and so does the
    reference's ``argument_size_in_bytes``."""
    pairs = zip(tree_leaves(bundle.abstract_inputs),
                tree_leaves(bundle.in_shardings))
    return sum(shard_bytes(t, s) for i, (t, s) in enumerate(pairs)
               if used is None or i in used)


def output_bytes(bundle: StepBundle, outputs) -> int:
    """Per-device bytes of the step's outputs under ``out_shardings``, and
    the 8-byte pointer of each leaf in the output tuple, which XLA's
    ``output_size_in_bytes`` counts too."""
    return (_sharded_bytes(outputs, bundle.out_shardings)
            + 8 * len(tree_leaves(outputs)))


def alias_bytes(bundle: StepBundle, outputs) -> int:
    """Per-device bytes of the donated inputs that an output of the same
    shard shape and dtype reuses (each input at most once)."""
    free: Dict[Tuple, int] = {}
    for i in bundle.donate_argnums:
        for t, s in zip(tree_leaves(bundle.abstract_inputs[i]),
                        tree_leaves(bundle.in_shardings[i])):
            key = (s.shard_shape(t.shape), t.dtype)
            free[key] = free.get(key, 0) + 1
    total = 0
    for t, s in zip(tree_leaves(outputs), tree_leaves(bundle.out_shardings)):
        key = (s.shard_shape(t.shape), t.dtype)
        if free.get(key):
            free[key] -= 1
            total += shard_bytes(t, s)
    return total


def _count(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
           flops: bool = True) -> Dict[str, Any]:
    """The step of one cell run once on meta tensors: global FLOPs and
    bytes, the peak of the storages alive at once over those alive at its
    end, the per-device output, alias and collective figures, and the
    flat indices of the inputs it read; without ``flops``, no FLOP count
    (0)."""
    with use_mesh(mesh):
        bundle = make_step(cfg, mesh, shape)
        mode = _BytesMode(bundle.abstract_inputs)
        counter = FlopCounterMode(display=False)
        with counter if flops else contextlib.nullcontext(), mode:
            out = bundle.fn(*bundle.abstract_inputs)
        coll = collective_terms(cfg, shape, mesh, bundle)
    return {"flops": counter.get_total_flops(), "bytes": mode.bytes,
            "temp": mode.peak - mode.live,
            "output": output_bytes(bundle, out),
            "alias": alias_bytes(bundle, out), "terms": coll,
            "used": frozenset(mode.used)}


def _per_device(c: Dict[str, Any], mesh: Mesh):
    coll = collectives(c["terms"])
    return c["flops"] / mesh.size, c["bytes"] / mesh.size, coll


def cell_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """(flops, bytes, collective dict) per device for one step, counted at
    the config's own depth (the counterpart of the reference's
    ``_cell_costs``)."""
    return _per_device(_count(cfg, shape, mesh), mesh)


def _probe(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh
           ) -> Dict[str, Any]:
    """``_count`` at one layer period and at two, extrapolated to the trip
    count (the encoder stack scaled with it, as the reference scales it):
    body = C(2) - C(1), total = C(1) + (trips - 1) * body."""
    period = layer_period(cfg)
    trips = cfg.num_layers // period
    if trips <= 1:
        return _count(dataclasses.replace(cfg, exact_costs=True,
                                          unroll_stack=True), shape, mesh)
    enc1 = max(1, cfg.encoder_layers // trips) if cfg.encoder_layers else 0
    c1, c2 = (_count(dataclasses.replace(
        cfg, num_layers=k * period, encoder_layers=k * enc1,
        unroll_stack=True, exact_costs=True), shape, mesh) for k in (1, 2))

    def extrap(x1, x2):
        return x1 + (trips - 1) * max(x2 - x1, 0)

    out = {k: extrap(c1[k], c2[k])
           for k in ("flops", "bytes", "temp", "output", "alias")}
    out["used"] = c1["used"]
    out["terms"] = {
        name: {**t, "count": extrap(t["count"], c2["terms"][name]["count"]),
               "bytes": extrap(t["bytes"], c2["terms"][name]["bytes"])}
        for name, t in c1["terms"].items()}
    return out


def temporaries(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                probe: Dict[str, Any]) -> int:
    """Global temporaries of a step. A serving step's are counted on the
    path that the card runs, the kernels' (``use_pallas``: attention
    without materialized scores), at full depth: quick, since a launch on
    meta tensors only checks its shapes, and exact where a peak is
    not linear in depth (a decode step's cache, collected layer by layer,
    shows only past a few periods). A train step runs torch ops (the
    kernels have no backward) whose chunk loops are slow on meta tensors,
    so its are the depth probe's (``probe``), on the ``exact_costs``
    path, whose attention materializes the scores. So are a serving
    step's where a kernel's ``check`` refuses its shapes (a reduced
    config's bf16 head dim of 16): there the step runs torch ops."""
    if shape.kind == "train":
        return probe["temp"]
    try:
        return _count(dataclasses.replace(cfg, use_pallas=True), shape,
                      mesh, flops=False)["temp"]
    except (TypeError, ValueError):
        return probe["temp"]


def probe_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """Per-device (flops, bytes, collective dict) by the reference's depth
    probe (``_probe``)."""
    return _per_device(_probe(cfg, shape, mesh), mesh)


# ---------------------------------------------------------------------------
# Collectives, modeled from the shardings
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _group_size(mesh: Mesh, axes: Iterable[str]) -> int:
    return math.prod(mesh.sizes[a] for a in axes)


def link(mesh: Mesh, axes: Iterable[str]) -> str:
    """``nvlink`` when the group over ``axes`` that holds device 0 lies in
    one node of NODE_DEVICES consecutive devices, else ``ib``."""
    strides, s = {}, 1
    for name, n in reversed(list(zip(mesh.axis_names, mesh.shape))):
        strides[name] = s
        s *= n
    last = sum((mesh.sizes[a] - 1) * strides[a] for a in axes)
    return "nvlink" if last < NODE_DEVICES else "ib"


def collective_terms(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                     bundle: StepBundle) -> Dict[str, Dict[str, Any]]:
    """The modeled collectives of one step, by term: for each, the op, the
    count, the per-device result bytes (x2 for an all-reduce), the mesh
    axes of its group and the link it crosses (see the module
    docstring)."""
    sizes = mesh.sizes
    train = shape.kind == "train"
    batch_sh = bundle.in_shardings[-1]["tokens"]
    dp = tuple(_axes_of(batch_sh.spec[0])) if batch_sh.spec else ()
    b_loc = shape.global_batch // _group_size(mesh, dp)
    s_tok = shape.seq_len if shape.kind in ("train", "prefill") else 1
    act = torch.empty((), dtype=cfg.dtype).element_size()
    # activation collectives: forward, remat recompute, backward
    passes = (3 if cfg.remat else 2) if train else 1
    sp = (DEFAULT_RULES["seq"] == "model" and s_tok > 1
          and s_tok % sizes.get("model", 1) == 0)
    model_n = sizes.get("model", 1)
    terms: Dict[str, Dict[str, Any]] = {}

    def add(name, op, count, nbytes, axes):
        if _group_size(mesh, axes) <= 1 or not count:
            return
        t = terms.setdefault(name, {"op": op, "count": 0, "bytes": 0,
                                    "axes": list(axes),
                                    "link": link(mesh, axes)})
        t["count"] += count
        t["bytes"] += nbytes * (2 if op == "all-reduce" else 1)

    leaves = zip(tree_leaves(bundle.abstract_inputs[0]),
                 tree_leaves(build_model(cfg).param_axes(),
                             is_leaf=is_axes_leaf),
                 tree_leaves(bundle.in_shardings[0]))
    for t, axes, sh in leaves:
        first = 1 if axes[:1] == ("layer",) else 0
        layers = t.shape[0] if first else 1
        spec = list(sh.spec) + [None] * (t.ndim - len(sh.spec))
        whole = shard_bytes(t, sh)
        if train:
            data = [a for e in spec for a in _axes_of(e) if a in _DATA_AXES]
            # gathered for the forward and again for the backward
            add("fsdp_all_gather", "all-gather", 2 * layers,
                2 * whole * _group_size(mesh, data), data)
            own = [a for a in data if a in dp]
            add("grad_reduce_scatter", "reduce-scatter", layers, whole, own)
            add("grad_all_reduce", "all-reduce", layers, whole,
                [a for a in dp if a not in own])
        dims, dspec = axes[first:], spec[first:]
        if "vocab" in dims:
            # the lookup all-reduces the looked-up rows; in training the
            # cross-entropy over vocab-sharded logits all-reduces three
            # f32 a token (the max, the sum of exponentials, the gold)
            ax = _axes_of(dspec[dims.index("vocab")])
            lookup = dims[0] == "vocab"
            if lookup:
                add("vocab_embed_all_reduce", "all-reduce", 1,
                    b_loc * s_tok * cfg.d_model * act, ax)
            if train and (not lookup or cfg.tie_embeddings):
                add("vocab_logits_all_reduce", "all-reduce", 3,
                    3 * b_loc * s_tok * 4, ax)
            continue
        if "expert" in dims:
            # a (dispatch, combine) pair per MoE layer, counted on its wo:
            # each the (b_loc, E, C, D) buffer that a rank sends into the
            # sharded serving step's all-to-all (``moe.dispatch``,
            # ``moe.combine_back``); the router weight's gather beside
            # them (d_model x E a layer) is not modeled
            if dims[-1] == "embed":
                buf = (b_loc * cfg.moe.num_experts
                       * moe_capacity(s_tok, cfg) * cfg.d_model * act)
                n = 2 * layers * passes
                add("moe_all_to_all", "all-to-all", n, n * buf,
                    _axes_of(dspec[0]))
            continue
        if len(dims) < 2 or "embed" not in (dims[0], dims[-1]):
            continue                   # not a projection of the stream
        n_in = 1 if dims[0] == "embed" else len(dims) - 1
        n = layers * passes
        y = b_loc * s_tok * math.prod(t.shape[first + n_in:]) * act
        resid = dims[-1] == "embed"
        if any("model" in _axes_of(e) for e in dspec[:n_in]):
            # partial sums over the sharded contracting dim
            if resid and sp:
                add("tp_reduce_scatter", "reduce-scatter", n,
                    n * y // model_n, ("model",))
                add("tp_all_gather", "all-gather", n, n * y, ("model",))
            else:
                add("tp_all_reduce", "all-reduce", n, n * y, ("model",))
        elif resid and any("model" in _axes_of(e) for e in dspec[n_in:]):
            add("tp_all_gather", "all-gather", n, n * y, ("model",))
    return terms


def collectives(terms: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The terms in the reference's layout: per op a count and bytes, and
    ``total_bytes``."""
    out: Dict[str, Any] = {k: {"count": 0, "bytes": 0.0} for k in _COLLECTIVES}
    for t in terms.values():
        out[t["op"]]["count"] += int(t["count"])
        out[t["op"]]["bytes"] += float(t["bytes"])
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    return out


def collective_seconds(terms: Dict[str, Dict[str, Any]]) -> float:
    rate = {"nvlink": NVLINK_BW, "ib": IB_BW}
    return sum(t["bytes"] / rate[t["link"]] for t in terms.values())


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def model_block(cfg: ModelConfig, shape: ShapeConfig, n_dev: int,
                flops: float) -> Dict[str, Any]:
    """The reference's ``model`` block: 6 (train) or 2 FLOPs per active
    parameter per token."""
    params = cfg.param_count()
    active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    per_dev = mult * active * tokens / n_dev
    return {"params": params, "active_params": active, "tokens": tokens,
            "model_flops_per_device": per_dev,
            "useful_flop_ratio": per_dev / flops if flops else 0.0}


def price(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, Any]:
    """Every figure of one cell (no status): costs by the depth probe,
    memory per device, the roofline at H100 rates and the model block."""
    t0 = time.monotonic()
    with use_mesh(mesh):
        bundle = make_step(cfg, mesh, shape)
    c = _probe(cfg, shape, mesh)
    args = argument_bytes(bundle, c["used"])
    n_dev, _ = mesh_info(mesh)
    flops, nbytes, coll = _per_device(c, mesh)
    mem = {"argument_size_in_bytes": int(args),
           "output_size_in_bytes": int(c["output"]),
           "temp_size_in_bytes": int(
               max(temporaries(cfg, shape, mesh, c), 0) // n_dev),
           "alias_size_in_bytes": int(c["alias"])}
    per_dev_hbm = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                   + mem["output_size_in_bytes"]
                   - mem["alias_size_in_bytes"])
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = collective_seconds(c["terms"])
    model = model_block(cfg, shape, n_dev, flops)
    bound = max(compute_s, memory_s, collective_s)
    ideal = model["model_flops_per_device"] / PEAK_FLOPS
    return {
        "mesh_shape": list(mesh.shape), "n_devices": n_dev,
        "trace_s": round(time.monotonic() - t0, 2),
        "flops_per_device": flops, "bytes_per_device": nbytes,
        "collectives": coll, "collective_terms": c["terms"],
        "memory": mem, "per_device_hbm_bytes": int(per_dev_hbm),
        "fits_hbm": bool(per_dev_hbm <= HBM_BYTES),
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max((("compute", compute_s), ("memory", memory_s),
                             ("collective", collective_s)),
                            key=lambda kv: kv[1])[0]},
        "model": model,
        "device": DEVICE, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
        "hbm_bytes": HBM_BYTES,
        "ideal_s": ideal, "step_bound_s": bound,
        "fraction": ideal / bound if bound > 0 else 0.0,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """One cell with the reference's status: ``skip`` where
    ``shape_applicable`` says so, ``error`` with the traceback where
    pricing raises, else ``ok`` and every figure of ``price``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cell: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": "multi" if multi_pod else "single"}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        cell.update(status="skip", reason=reason)
        return cell
    try:
        cell.update(price(cfg, shape,
                          make_production_mesh(multi_pod=multi_pod)))
    except Exception as e:                     # noqa: BLE001
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-4000:])
        return cell
    cell["status"] = "ok"
    return cell


def remesh_cell(arch: str, shape_name: str, plan) -> Dict[str, Any]:
    """The cell on the mesh and global batch of an ``ElasticPlan``
    (``distributed.fault_tolerance.plan_elastic_remesh``)."""
    shape = dataclasses.replace(SHAPES[shape_name],
                                global_batch=plan.new_global_batch)
    mesh = Mesh(tuple(plan.mesh_axis_names), tuple(plan.new_mesh_shape))
    return {"arch": arch, "shape": shape_name, "mesh": "remesh",
            **price(get_config(arch), shape, mesh), "status": "ok"}


def cell_line(cell: Dict[str, Any]) -> str:
    """One line for a cell: the roofline terms, the dominant one, GiB per
    device and whether it fits."""
    if cell["status"] == "skip":
        return f"skip: {cell['reason']}"
    if cell["status"] != "ok":
        return f"ERROR: {cell['error']}"
    r = cell["roofline"]
    return (f"ok: trace={cell['trace_s']}s "
            f"hbm={cell['per_device_hbm_bytes'] / 2 ** 30:.2f}GiB "
            f"fits={cell['fits_hbm']} dominant={r['dominant']} "
            f"(c={r['compute_s']:.4f}s m={r['memory_s']:.4f}s "
            f"coll={r['collective_s']:.4f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=all_arch_names())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results_torch/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in all_arch_names() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_name in cells:
        for multi in meshes:
            tag = "multi" if multi else "single"
            path = out_dir / f"{arch}__{shape_name}__{tag}.json"
            if args.skip_existing and path.exists():
                prev = json.loads(path.read_text())
                if prev.get("status") in ("ok", "skip"):
                    print(f"[skip existing] {path.name}")
                    continue
            print(f"[dryrun] {arch} x {shape_name} x {tag} ...", flush=True)
            cell = run_cell(arch, shape_name, multi)
            path.write_text(json.dumps(cell, indent=1))
            failures += cell["status"] == "error"
            print(f"  {cell_line(cell)}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
