"""Step builders: train / prefill / decode steps for every arch (the port
of ``repro.launch.steps``).

Shared by the training driver (``launch/train.py``), the serving driver's
co-located trainer (``launch/serve.py``) and ``chip_smoke.py``. Every
builder is pure: (model, mesh, shape, options) -> ``StepBundle``, the
step function with its abstract inputs (meta tensors) and the shardings
of its inputs and outputs on ``mesh``, equal to the reference's leaf for
leaf. On one device the function runs eagerly on whole tensors. Donation
has no meaning in eager torch; ``donate_argnums`` is the reference's
metadata, and the decode step may write into the cache it is given.

The train step: ``loss_fn``'s gradients (the cross-entropy plus the MoE
auxiliary loss; a batch's ``encoder_embeds`` go to the audio family's
encoder) by ``torch.autograd.grad`` over the parameter leaves,
microbatches summed and divided by their count, the schedule read at
``opt_state.step`` before the update. On a mesh of more than one process
(one per device) it takes its inputs as ``DTensor``s laid out by its
``in_shardings`` (``ShardGroup.layout``) and returns them so: storage
follows the reference's shardings, compute runs on gathered tensors (see
``make_train_step``). The serving steps hold the weights in the model
dtype (``serving_param_shapes``), not as f32 masters; on a mesh of more
than one process their ``sharded_fn`` computes on the shards,
tensor-parallel over the model axis (``sharding.ModelAxis``), on any
model axis, and the MoE blocks expert-parallel over the data axes
(``sharding.ExpertAxis``), for every family (``sharded_serving``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig, input_specs,
                                      kv_cache_specs)
from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                              INFER_PARAM_RULES, LOCAL,
                                              PARAM_RULES, ExpertAxis,
                                              ModelAxis, NamedSharding,
                                              PartitionSpec, ShardGroup,
                                              entry_axes, expert_axes,
                                              is_axes_leaf, logical_to_spec,
                                              tree_shardings, use_batch_mean,
                                              use_expert_axis, use_model_axis)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import (TransformerLM, build_model,
                                           loss_fn, pad_cache)
from repro_torch.optim.adafactor import (AdafactorConfig, adafactor_init,
                                         adafactor_slot_axes,
                                         adafactor_slot_shapes,
                                         adafactor_update)
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import Schedule, constant
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

# ---------------------------------------------------------------------------
# Logical axes for non-param inputs
# ---------------------------------------------------------------------------


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    ax: Dict[str, Any] = {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        ax["targets"] = ("batch", "seq")
    if cfg.encoder_layers and shape.kind in ("train", "prefill"):
        ax["encoder_embeds"] = ("batch", "frames", None)
    if cfg.mrope_sections is not None:
        ax["positions"] = (None, "batch", "seq")
    if shape.kind in ("decode", "long_decode"):
        ax["cache"] = kv_cache_axes(cfg)
        ax["cache_index"] = ()
    return ax


def kv_cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    axes: Dict[str, Any] = {}
    n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.num_layers))
    if n_attn:
        axes["k"] = ("layer", "batch", "kv_seq", "kv_heads", None)
        axes["v"] = ("layer", "batch", "kv_seq", "kv_heads", None)
    if cfg.family in ("ssm", "hybrid"):
        axes["ssm_state"] = ("layer", "batch", "ssm_heads", None, None)
        axes["conv_state"] = ("layer", "batch", None, "conv_dim")
    if cfg.encoder_layers:
        axes["cross_k"] = ("layer", "batch", "frames", "kv_heads", None)
        axes["cross_v"] = ("layer", "batch", "frames", "kv_heads", None)
    return axes


# ---------------------------------------------------------------------------
# Optimizer plumbing (adamw | adafactor, selected per config)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptBundle:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any, torch.Tensor]]
    state_shapes: Callable[[Any], Any]
    state_axes: Callable[[Any], Any]
    # the update is elementwise given the global norm (``gnorm=``), so a
    # sharded step runs it on shards; else on gathered state
    elementwise: bool = False


def _adamw_state_shapes(param_shapes) -> OptState:
    def f32(s):
        return torch.empty(s.shape, dtype=torch.float32, device="meta")
    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    mu=tree_map(f32, param_shapes),
                    nu=tree_map(f32, param_shapes))


def _adamw_state_axes(param_axes) -> OptState:
    return OptState(step=(), mu=param_axes,
                    nu=tree_map(lambda a: a, param_axes,
                                is_leaf=is_axes_leaf))


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4) -> OptBundle:
    if cfg.optimizer == "adafactor":
        return OptBundle(init=adafactor_init,
                         update=partial(adafactor_update,
                                        AdafactorConfig(lr=lr)),
                         state_shapes=adafactor_slot_shapes,
                         state_axes=adafactor_slot_axes)
    return OptBundle(init=adamw_init,
                     update=partial(adamw_update, AdamWConfig(lr=lr)),
                     state_shapes=_adamw_state_shapes,
                     state_axes=_adamw_state_axes, elementwise=True)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepBundle:
    """Everything a driver needs for one (arch x shape) cell."""

    fn: Callable                      # the step function
    abstract_inputs: Tuple[Any, ...]  # meta-tensor trees (positional)
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    # on a mesh of more than one process: the step each rank calls on its
    # shards (``fn`` is the global step, as the reference jits it)
    sharded_fn: Optional[Callable] = None


def compute_grads(model: TransformerLM, params,
                  batch: Dict[str, torch.Tensor]):
    """(loss, gradient tree) of ``loss_fn`` at ``params``; a leaf that the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = loss_fn(model, tree_unflatten(treedef, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


def _grads(model: TransformerLM, params, batch, n: int):
    """(loss, gradients) of ``batch``, in ``n`` microbatches summed and
    divided by their count."""
    if n == 1:
        return compute_grads(model, params, batch)
    mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
          for k, v in batch.items()}
    for i in range(n):
        li, gi = compute_grads(model, params,
                               {k: v[i] for k, v in mb.items()})
        grads, loss = ((gi, li) if i == 0 else
                       (tree_map(torch.add, grads, gi), loss + li))
    return loss / n, tree_map(lambda g: g / n, grads)


def make_train_step(model: TransformerLM, mesh: Mesh, shape: ShapeConfig, *,
                    schedule: Optional[Schedule] = None,
                    num_microbatches: int = 1,
                    lr: float = 3e-4,
                    group: Optional[ShardGroup] = None) -> StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})`` for ``model``, with its shardings on ``mesh``.

    On a mesh of more than one process, ``sharded_fn`` is called on every
    rank with ``DTensor``s laid out by ``in_shardings`` (parameters and
    optimizer state by ``PARAM_RULES``: FSDP on ``embed`` over data, the
    tensor-parallel axes over model; the batch by ``DEFAULT_RULES``) and
    returns them so. It gathers every weight whole and the batch's rows
    of this rank's data shard with the whole sequence (a causal model
    cannot run on a slice of it, and ``seq`` maps to model under
    ``REPRO_OPT_SP=1``), runs ``compute_grads`` on plain tensors (so the
    model axis shards storage, not compute: the ranks of a model group
    compute the same rows), and averages loss and gradients over the data
    shards, which leaves the whole gradients on every rank. The MoE
    router's load is averaged over the data shards before its product
    with the router's mean probability (``sharding.batch_mean``). AdamW's
    update is elementwise given the global norm, taken from the whole
    gradients, so it runs on the shards of the parameters, gradients and
    moments; Adafactor's row and column means and RMS need whole tensors
    and its factored state is small, so it runs on the whole parameters,
    gradients and gathered state, and each rank keeps its shards.
    ``loss`` and ``grad_norm`` are global and equal on every rank; with
    as many microbatches as data shards, one process computes the same
    rows and sums. ``num_microbatches`` splits this rank's rows. All
    collectives are all-reduces on the default group, through ``group``
    (made at the first call if not given)."""
    cfg = model.cfg
    if cfg.use_pallas:
        raise NotImplementedError(
            f"{cfg.name}: use_pallas training is not supported: the kernels "
            "have no backward (the port launches them without an autograd "
            "graph, so the weights upstream of a kernel would get no "
            "gradient), and the reference cannot differentiate its Pallas "
            "kernels either; train with use_pallas=False (torch ops)")
    if shape.global_batch % num_microbatches:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{num_microbatches} microbatches")
    opt = make_optimizer(cfg, lr)
    sched = schedule or constant(1.0)

    def train_step(params, opt_state, batch):
        loss, grads = _grads(model, params, batch, num_microbatches)
        new_params, new_state, gnorm = opt.update(params, grads, opt_state,
                                                  sched(opt_state.step))
        return new_params, new_state, {"loss": loss.float(),
                                       "grad_norm": gnorm.float()}

    param_shapes = model.param_shapes()
    param_axes = model.param_axes()
    opt_shapes = opt.state_shapes(param_shapes)
    opt_axes = opt.state_axes(param_axes)
    bspecs = input_specs(cfg, shape)
    baxes = batch_axes(cfg, shape)

    p_sh = tree_shardings(param_axes, mesh, PARAM_RULES, param_shapes)
    o_sh = tree_shardings(opt_axes, mesh, PARAM_RULES, opt_shapes)
    b_sh = tree_shardings(baxes, mesh, DEFAULT_RULES, bspecs)
    rep = NamedSharding(mesh, PartitionSpec())
    m_sh = {"loss": rep, "grad_norm": rep}
    groups = [group]

    def sharded_train_step(params, opt_state, batch):
        if groups[0] is None:         # the process group exists by now
            groups[0] = ShardGroup(mesh)
        g = groups[0]
        whole = g.gather(params, p_sh)
        # this rank's rows with the whole sequence; the mesh axes of the
        # batch dim are the data shards that loss and gradients average over
        data = entry_axes(b_sh["tokens"].spec[0])
        mine = g.slices(NamedSharding(mesh, PartitionSpec(data or None)),
                        (shape.global_batch,))[0]
        rows = {}
        for k, v in g.gather(batch, b_sh).items():
            sl = [slice(None)] * v.ndim
            sl[baxes[k].index("batch")] = mine
            v = v[tuple(sl)]
            rows[k] = v if v.is_floating_point() else v.long()
        if rows["tokens"].shape[0] % num_microbatches:
            raise ValueError(f"{rows['tokens'].shape[0]} rows per data "
                             f"shard do not split into {num_microbatches} "
                             "microbatches")
        with use_batch_mean(lambda x: g.mean_over([x], data)[0]):
            loss, grads = _grads(model, whole, rows, num_microbatches)
        leaves, treedef = tree_flatten(grads)
        loss, *leaves = g.mean_over([loss] + leaves, data)
        grads = tree_unflatten(treedef, leaves)
        lr_scale = sched(opt_state.step.to_local())
        mine_of = partial(tree_map, lambda x, s: g.local(x, s))
        if opt.elementwise:
            new_p, new_s, gnorm = opt.update(
                tree_map(lambda t: t.to_local(), params),
                mine_of(grads, p_sh),
                tree_map(lambda t: t.to_local(), opt_state), lr_scale,
                gnorm=global_norm(grads))
        else:
            new_p, new_s, gnorm = opt.update(
                whole, grads, g.gather(opt_state, o_sh), lr_scale)
            new_p, new_s = mine_of(new_p, p_sh), mine_of(new_s, o_sh)
        return (_as_dtensors(new_p, params), _as_dtensors(new_s, opt_state),
                {"loss": loss.float(), "grad_norm": gnorm.float()})

    return StepBundle(
        fn=train_step,
        abstract_inputs=(param_shapes, opt_shapes, bspecs),
        in_shardings=(p_sh, o_sh, b_sh),
        out_shardings=(p_sh, o_sh, m_sh),
        donate_argnums=(0, 1),
        sharded_fn=sharded_train_step if mesh.size > 1 else None,
    )


def _as_dtensors(shards, like):
    """Each shard of ``shards`` as a ``DTensor`` with the global shape and
    placements of the matching leaf of ``like``."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t, d: DTensor.from_local(
        t, d.device_mesh, d.placements, run_check=False, shape=d.shape,
        stride=d.stride()), shards, like)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def serving_param_shapes(model: TransformerLM):
    """Serving weights are model-dtype (bf16), not f32 masters
    (``model.init(..., dtype=model.cfg.dtype)`` draws them)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=model.cfg.dtype,
                                          device="meta"),
                    model.param_shapes())


# dims eligible for the serving fallback shard (any of these divisible by
# the model axis => the weight need not be replicated)
_FALLBACK_AXES = ("embed", "mlp", "expert_mlp", "vocab")


def serving_param_shardings(param_axes, param_shapes, mesh: Mesh):
    """INFER_PARAM_RULES + fallback: a weight whose preferred dims do not
    divide the model axis (e.g. 56 heads / 8 kv heads over 16) falls back
    to sharding its embed dim — never replicate multi-GB weights."""
    model_size = mesh.sizes.get("model", 1)

    def one(axes, shp):
        spec = logical_to_spec(axes, mesh, INFER_PARAM_RULES, shp.shape)
        if any(e is not None for e in spec) or model_size == 1:
            return NamedSharding(mesh, spec)
        entries = [None] * len(axes)
        for i, ax in enumerate(axes):
            if ax in _FALLBACK_AXES and shp.shape[i] % model_size == 0:
                entries[i] = "model"
                break
        return NamedSharding(mesh, PartitionSpec(*entries))

    return tree_map(one, param_axes, param_shapes, is_leaf=is_axes_leaf)


def _logits_sharding(cfg: ModelConfig, mesh: Mesh,
                     shape: ShapeConfig) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(
        ("batch", None, "vocab"), mesh, DEFAULT_RULES,
        shape=(shape.global_batch, 1, cfg.vocab_size)))


# families whose serving steps run sharded on a mesh of processes: every
# family, tensor-parallel over the model axis, the MoE blocks also
# expert-parallel over the data axes
SHARDED_SERVING_FAMILIES = ("dense", "vlm", "ssm", "audio", "moe", "hybrid")


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def cache_layout(cache_sh) -> Dict[str, Any]:
    """``ModelAxis``'s cache keywords from the cache's shardings: the
    k/v cache split over positions ("seq"), kv heads ("heads") or
    neither; conv_state's channels split or not. The cross cache needs
    no keyword: its leaves hold every kv head or this rank's."""
    def on_model(sh, dim):
        return "model" in entry_axes(sh.spec[dim])
    kv = None
    if "k" in cache_sh:
        kv = ("seq" if on_model(cache_sh["k"], 2) else
              "heads" if on_model(cache_sh["k"], 3) else None)
    conv = "conv_state" in cache_sh and on_model(cache_sh["conv_state"], 3)
    return {"kv": kv, "conv": conv}


def serving_axes(cfg: ModelConfig, group: ShardGroup, layout: Dict[str, Any],
                 rows: Tuple[int, int]):
    """This rank's (``ModelAxis`` or None, ``ExpertAxis`` or None) in a
    sharded serving step: the model axis where it is larger than 1, with
    the cache's ``layout`` (``cache_layout``); the expert axis for a
    model with experts, its rows at ``rows`` = (start, total) of the
    step's batch."""
    mesh = group.mesh
    ax = (ModelAxis(group, **layout) if mesh.sizes.get("model", 1) > 1
          else None)
    ex = (ExpertAxis(group, expert_axes(mesh, cfg.moe.num_experts), rows)
          if cfg.moe is not None else None)
    return ax, ex


@contextlib.contextmanager
def use_serving_axes(axes):
    """``serving_axes``' pair active on this thread."""
    with use_model_axis(axes[0]), use_expert_axis(axes[1]):
        yield


def sharded_serving(model: TransformerLM, mesh: Mesh, b_sh, out_sh,
                    run: Callable, cache_shapes: Callable,
                    group: Optional[ShardGroup] = None):
    """The ``sharded_fn`` of a serving step on ``mesh`` (more than one
    process): ``fn(params, batch)`` on every rank with ``DTensor``s laid
    out by ``in_shardings`` (``cache_index`` may also come as a plain
    tensor), returning (logits, cache) as ``DTensor``s by
    ``out_shardings``, the cache's global shapes ``cache_shapes(batch)``.
    Each rank takes the rows of its data shard (the token batch,
    gathered whole, is small; ``encoder_embeds``, split over the data
    axes only, is its local shard; the cache holds only those rows),
    runs ``run(params, inputs, cache)`` on its local shards inside its
    ``ModelAxis`` (tensor-parallel over the model axis, which need not
    divide the heads) and, for a model with experts, its ``ExpertAxis``
    (the MoE blocks expert-parallel over the data axes, by all-to-all;
    the router's weight is the one weight gathered) and keeps its share
    of the outputs."""
    cfg = model.cfg
    logits_sh, cache_sh = out_sh
    layout = cache_layout(cache_sh)
    data = entry_axes(b_sh["tokens"].spec[0])
    groups = [group]

    def step(params, batch):
        if groups[0] is None:         # the process group exists by now
            groups[0] = ShardGroup(mesh)
        g = groups[0]
        B = batch["tokens"].shape[0]
        mine = g.slices(NamedSharding(mesh, PartitionSpec(data or None)),
                        (B,))[0]
        small = {k: batch[k] for k in ("tokens", "positions") if k in batch}
        rows = {}
        for k, v in g.gather(small, {k: b_sh[k] for k in small}).items():
            v = v.narrow(v.ndim - 2, mine.start, mine.stop - mine.start)
            rows[k] = v if k == "positions" else v.long()
        if "encoder_embeds" in batch:
            rows["encoder_embeds"] = _local(batch["encoder_embeds"])
        if "cache_index" in batch:
            ci = _local(batch["cache_index"])
            rows["cache_index"] = ci[mine] if ci.ndim == 1 else ci
        local = tree_map(_local, params)
        cache = (tree_map(_local, batch["cache"]) if "cache" in batch
                 else None)
        axes = serving_axes(cfg, g, layout, (mine.start, B))
        with use_serving_axes(axes):
            logits, new_cache = run(local, rows, cache)
        shapes = cache_shapes(batch)
        return (g.wrap(logits, logits_sh, (B, 1, cfg.vocab_size)),
                {k: g.wrap(v, cache_sh[k], shapes[k])
                 for k, v in new_cache.items()})

    return step


def make_prefill_step(model: TransformerLM, mesh: Mesh,
                      shape: ShapeConfig,
                      group: Optional[ShardGroup] = None) -> StepBundle:
    """``fn(params, batch) -> (last-token logits (B, 1, V), cache)``; on a
    mesh of more than one process, ``sharded_fn`` (``sharded_serving``).
    """
    cfg = model.cfg

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"],
                             positions=batch.get("positions"),
                             encoder_embeds=batch.get("encoder_embeds"))

    param_shapes = serving_param_shapes(model)
    bspecs = input_specs(cfg, shape)
    p_sh = serving_param_shardings(model.param_axes(), param_shapes, mesh)
    b_sh = tree_shardings(batch_axes(cfg, shape), mesh, DEFAULT_RULES, bspecs)
    cache_specs = {k: torch.empty(s, dtype=d, device="meta") for k, (s, d)
                   in kv_cache_specs(cfg, shape.global_batch,
                                     shape.seq_len).items()}
    cache_sh = tree_shardings(kv_cache_axes(cfg), mesh, DEFAULT_RULES,
                              cache_specs)
    out_sh = (_logits_sharding(cfg, mesh, shape), cache_sh)
    return StepBundle(
        fn=prefill_step,
        abstract_inputs=(param_shapes, bspecs),
        in_shardings=(p_sh, b_sh),
        out_shardings=out_sh,
        donate_argnums=(),
        sharded_fn=(sharded_serving(
            model, mesh, b_sh, out_sh, lambda p, b, _: model.prefill(
                p, b["tokens"], positions=b.get("positions"),
                encoder_embeds=b.get("encoder_embeds")),
            lambda b: {k: s for k, (s, _) in kv_cache_specs(
                cfg, *b["tokens"].shape).items()}, group)
            if mesh.size > 1 else None),
    )


def make_decode_step(model: TransformerLM, mesh: Mesh,
                     shape: ShapeConfig,
                     group: Optional[ShardGroup] = None) -> StepBundle:
    """``fn(params, batch) -> (logits (B, 1, V), new cache)``; the batch
    holds one token per sequence, the cache and ``cache_index``. On a
    mesh of more than one process, ``sharded_fn`` (``sharded_serving``).
    """
    cfg = model.cfg

    def serve_step(params, batch):
        return model.decode_step(params, batch["tokens"], batch["cache"],
                                 batch["cache_index"],
                                 positions=batch.get("positions"))

    param_shapes = serving_param_shapes(model)
    bspecs = input_specs(cfg, shape)
    p_sh = serving_param_shardings(model.param_axes(), param_shapes, mesh)
    b_sh = tree_shardings(batch_axes(cfg, shape), mesh, DEFAULT_RULES, bspecs)
    out_sh = (_logits_sharding(cfg, mesh, shape), b_sh["cache"])
    return StepBundle(
        fn=serve_step,
        abstract_inputs=(param_shapes, bspecs),
        in_shardings=(p_sh, b_sh),
        out_shardings=out_sh,
        donate_argnums=(1,),          # cache buffers are reused
        sharded_fn=(sharded_serving(
            model, mesh, b_sh, out_sh, lambda p, b, c: model.decode_step(
                p, b["tokens"], c, b["cache_index"],
                positions=b.get("positions")),
            lambda b: {k: tuple(v.shape) for k, v in b["cache"].items()},
            group)
            if mesh.size > 1 else None),
    )


def init_serving_shards(model: TransformerLM, bundle: StepBundle,
                        group: ShardGroup, seed: int = 0):
    """This rank's shards of ``model.init(seed, dtype=cfg.dtype)`` as
    ``DTensor``s by a serving step's parameter shardings, drawn on the
    rank's device: every leaf is drawn in ``init``'s generator order and
    only the rank's part kept, so the shards equal one process's weights
    and the rank never holds more than its shards and one draw."""
    shapes, p_sh = bundle.abstract_inputs[0], bundle.in_shardings[0]
    parts = tree_map(lambda t, s: group.slices(s, t.shape), shapes, p_sh)
    local = model.init(seed, device=group.device, dtype=model.cfg.dtype,
                       parts=parts)
    return tree_map(lambda t, s, m: group.wrap(t, s, m.shape), local, p_sh,
                    shapes)


def reshard_cache_leaf(local: torch.Tensor, src: NamedSharding,
                       dst: NamedSharding, ax, capacity: Optional[int] = None
                       ) -> torch.Tensor:
    """This rank's part of one cache leaf by ``src`` as its part by
    ``dst``: gathered over the model axis ``ax`` where ``src`` splits it,
    k/v positions padded to ``capacity`` where given, and this rank's
    part kept where ``dst`` splits it (the batch rows stay on their data
    shard)."""
    for dim, e in enumerate(src.spec):
        if "model" in entry_axes(e):
            local = ax.gather(local, dim)
    if capacity is not None:
        local = pad_cache({"k": local}, capacity)["k"]
    for dim, e in enumerate(dst.spec):
        if "model" in entry_axes(e):
            local = ax.mine(local, dim, local.shape[dim] // ax.size)
    return local.contiguous()


def decode_cache(cache, prefill: StepBundle, decode: StepBundle,
                 group: ShardGroup):
    """``pad_cache`` between a sharded prefill and decode step: the
    prefill's cache (``DTensor``s by its out-shardings, k/v of length S)
    as the decode step's (by its in-shardings, k/v padded to its T). The
    rank boundaries over positions move, so each leaf is resharded
    (``reshard_cache_leaf``)."""
    src, dst = prefill.out_shardings[1], decode.in_shardings[1]["cache"]
    specs = decode.abstract_inputs[1]["cache"]
    ax = (ModelAxis(group) if group.mesh.sizes.get("model", 1) > 1
          else LOCAL)
    out = {}
    for k, t in cache.items():
        if src[k] == dst[k] and tuple(t.shape) == tuple(specs[k].shape):
            out[k] = t                # the ssm states: no positions
            continue
        out[k] = group.wrap(reshard_cache_leaf(
            _local(t), src[k], dst[k], ax,
            specs[k].shape[2] if k in ("k", "v") else None),
            dst[k], specs[k].shape)
    return out


def make_step(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig,
              **kw) -> StepBundle:
    model = build_model(cfg)
    if shape.kind == "train":
        return make_train_step(model, mesh, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(model, mesh, shape)
    return make_decode_step(model, mesh, shape)
