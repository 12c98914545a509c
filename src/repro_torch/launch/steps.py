"""The train step (the port of the train-step half of
``repro.launch.steps``).

``make_optimizer`` picks AdamW or Adafactor by ``cfg.optimizer``;
``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, {"loss", "grad_norm"})``: gradients of ``loss_fn`` (the
cross-entropy plus the MoE auxiliary loss; a batch's ``encoder_embeds``
go to the audio family's encoder) by ``torch.autograd.grad`` over the
parameter leaves, microbatches summed and divided by their count, the
schedule read at ``opt_state.step`` before the update. On one card the reference's shardings, mesh and abstract inputs
drop out (they come with the port's ``torch.distributed`` layer, ROADMAP
Queue 1 item 8); the serving steps, which only the reference's dry run
uses, are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import TransformerLM, loss_fn
from repro_torch.optim.adafactor import (AdafactorConfig, adafactor_init,
                                         adafactor_update)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import Schedule, constant
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class OptBundle:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any, torch.Tensor]]


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4) -> OptBundle:
    if cfg.optimizer == "adafactor":
        return OptBundle(init=adafactor_init,
                         update=partial(adafactor_update,
                                        AdafactorConfig(lr=lr)))
    return OptBundle(init=adamw_init,
                     update=partial(adamw_update, AdamWConfig(lr=lr)))


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


def make_train_step(model: TransformerLM, shape: Optional[ShapeConfig] = None,
                    *, schedule: Optional[Schedule] = None,
                    num_microbatches: int = 1, lr: float = 3e-4):
    """``train_step(params, opt_state, batch)`` for ``model``. ``shape``
    (the reference's mesh-and-sharding input) is only checked against the
    microbatch count."""
    cfg = model.cfg
    if cfg.use_pallas:
        raise NotImplementedError(
            f"{cfg.name}: use_pallas training is not supported: the kernels "
            "have no backward (the port launches them without an autograd "
            "graph, so the weights upstream of a kernel would get no "
            "gradient), and the reference cannot differentiate its Pallas "
            "kernels either; train with use_pallas=False (torch ops)")
    if shape is not None and shape.global_batch % num_microbatches:
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

    return train_step
