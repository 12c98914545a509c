"""AdamW on trees of tensors (the port of ``repro.optim.adamw``).

Moments are stored in f32 whatever the parameter's dtype; the update is
decoupled weight decay (Loshchilov & Hutter), in the reference's order of
operations: clip by the global norm, bias correction from the incremented
step, ``p32 - lr * (delta + wd * p32)`` in f32, cast back to the
parameter's dtype. ``adamw_update`` is a pure function of its arguments
(new tensors out, none changed in place); the state mirrors the parameter
tree, so a JAX ``OptState`` carried across through numpy
(``weights.opt_state_from_jax``) runs unchanged. Apart from the global
norm, the update is elementwise, so a sharded step runs it on each
rank's shards, given the norm of the whole gradients (``gnorm``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import (flatten_up_to, tree_flatten, tree_leaves,
                              tree_map, tree_unflatten)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak LR if a schedule is applied
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0           # 0 disables


class OptState(NamedTuple):
    step: torch.Tensor               # int32 scalar
    mu: Any                          # first moments (param tree, f32)
    nu: Any                          # second moments (param tree, f32)


def adamw_init(params) -> OptState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """(clipped grads, pre-clip norm); ``norm`` if the caller has it."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState,
                 lr_scale: Union[torch.Tensor, float] = 1.0,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, OptState, torch.Tensor]:
    """One AdamW step. Returns (new_params, new_state, grad_norm); the
    global norm is ``gnorm`` where the caller has it (the trees then hold
    shards of tensors whose whole gradients have that norm)."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)
    elif gnorm is None:
        gnorm = global_norm(grads)
    step = state.step + 1
    t = step.to(torch.float32)
    b1t = 1.0 - cfg.b1 ** t
    b2t = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g32 = g.float()
        m = cfg.b1 * m + (1.0 - cfg.b1) * g32
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g32)
        mhat = m / b1t
        vhat = v / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        p32 = p32 - lr * (delta + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    flat_p, treedef = tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, flatten_up_to(treedef, grads),
        flatten_up_to(treedef, state.mu), flatten_up_to(treedef, state.nu))]
    new_p, new_m, new_v = (tree_unflatten(treedef, [o[i] for o in out])
                           for i in range(3))
    return new_p, OptState(step=step, mu=new_m, nu=new_v), gnorm
