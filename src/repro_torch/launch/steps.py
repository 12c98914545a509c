"""Step builders: train / prefill / decode steps for every arch (the port
of ``repro.launch.steps``).

Shared by the training driver (``launch/train.py``), the serving driver's
co-located trainer (``launch/serve.py``) and ``chip_smoke.py``. Every
builder is pure: (model, mesh, shape, options) -> ``StepBundle``, the
step function with its abstract inputs (meta tensors) and the shardings
of its inputs and outputs on ``mesh``, equal to the reference's leaf for
leaf. The function runs eagerly in one process on one device: a mesh
larger than that is described, not run (tensors are split across devices
only as DTensors, ``distributed.sharding``). Donation has no meaning in
eager torch; ``donate_argnums`` is the reference's metadata, and the
decode step may write into the cache it is given.

The train step: ``loss_fn``'s gradients (the cross-entropy plus the MoE
auxiliary loss; a batch's ``encoder_embeds`` go to the audio family's
encoder) by ``torch.autograd.grad`` over the parameter leaves,
microbatches summed and divided by their count, the schedule read at
``opt_state.step`` before the update. The serving steps hold the weights
in the model dtype (``serving_param_shapes``), not as f32 masters.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig, input_specs,
                                      kv_cache_specs)
from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                              INFER_PARAM_RULES, PARAM_RULES,
                                              NamedSharding, PartitionSpec,
                                              is_axes_leaf, logical_to_spec,
                                              tree_shardings)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import TransformerLM, build_model, loss_fn
from repro_torch.optim.adafactor import (AdafactorConfig, adafactor_init,
                                         adafactor_slot_axes,
                                         adafactor_slot_shapes,
                                         adafactor_update)
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update)
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
                     state_axes=_adamw_state_axes)


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


def make_train_step(model: TransformerLM, mesh: Mesh, shape: ShapeConfig, *,
                    schedule: Optional[Schedule] = None,
                    num_microbatches: int = 1,
                    lr: float = 3e-4) -> StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})`` for ``model``, with its shardings on ``mesh``."""
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
        if num_microbatches > 1:
            n = num_microbatches
            mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            for i in range(n):
                li, gi = compute_grads(model, params,
                                       {k: v[i] for k, v in mb.items()})
                grads, loss = ((gi, li) if i == 0 else
                               (tree_map(torch.add, grads, gi), loss + li))
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
        else:
            loss, grads = compute_grads(model, params, batch)
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
    return StepBundle(
        fn=train_step,
        abstract_inputs=(param_shapes, opt_shapes, bspecs),
        in_shardings=(p_sh, o_sh, b_sh),
        out_shardings=(p_sh, o_sh, m_sh),
        donate_argnums=(0, 1),
    )


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


def make_prefill_step(model: TransformerLM, mesh: Mesh,
                      shape: ShapeConfig) -> StepBundle:
    """``fn(params, batch) -> (last-token logits (B, 1, V), cache)``."""
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
    return StepBundle(
        fn=prefill_step,
        abstract_inputs=(param_shapes, bspecs),
        in_shardings=(p_sh, b_sh),
        out_shardings=(_logits_sharding(cfg, mesh, shape), cache_sh),
        donate_argnums=(),
    )


def make_decode_step(model: TransformerLM, mesh: Mesh,
                     shape: ShapeConfig) -> StepBundle:
    """``fn(params, batch) -> (logits (B, 1, V), new cache)``; the batch
    holds one token per sequence, the cache and ``cache_index``."""
    cfg = model.cfg

    def serve_step(params, batch):
        return model.decode_step(params, batch["tokens"], batch["cache"],
                                 batch["cache_index"],
                                 positions=batch.get("positions"))

    param_shapes = serving_param_shapes(model)
    bspecs = input_specs(cfg, shape)
    p_sh = serving_param_shardings(model.param_axes(), param_shapes, mesh)
    b_sh = tree_shardings(batch_axes(cfg, shape), mesh, DEFAULT_RULES, bspecs)
    return StepBundle(
        fn=serve_step,
        abstract_inputs=(param_shapes, bspecs),
        in_shardings=(p_sh, b_sh),
        out_shardings=(_logits_sharding(cfg, mesh, shape), b_sh["cache"]),
        donate_argnums=(1,),          # cache buffers are reused
    )


def make_step(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig,
              **kw) -> StepBundle:
    model = build_model(cfg)
    if shape.kind == "train":
        return make_train_step(model, mesh, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(model, mesh, shape)
    return make_decode_step(model, mesh, shape)
