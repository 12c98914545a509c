"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment (the port of ``repro.optim.adafactor``), for the archs whose
parameters and optimizer state would not fit with AdamW's two moments.

For a parameter of shape (..., R, C) the second-moment estimate is stored
as a row factor (..., R) and a column factor (..., C): O(R+C) instead of
O(R*C), so a stacked (n, R, C) weight gets vr (n, R) and vc (n, C). 0/1-D
parameters keep a full second moment. Update clipping by root-mean-square
(d=1.0) per the paper. The state's NamedTuples have the reference's names
and fields, so it flattens to the reference's leaf order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple, Union

import torch

from repro_torch.optim.adamw import global_norm
from repro_torch.tree import (flatten_up_to, tree_flatten, tree_leaves,
                              tree_map, tree_unflatten)


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8             # beta2_t = 1 - step^-decay
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


class _Factored(NamedTuple):
    vr: torch.Tensor               # (..., R)
    vc: torch.Tensor               # (..., C)


class _Full(NamedTuple):
    v: torch.Tensor


AfSlot = Union[_Factored, _Full]


class AfState(NamedTuple):
    step: torch.Tensor
    slots: Any                     # param tree of AfSlot


def adafactor_init(params) -> AfState:
    def slot(p):
        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return _Factored(vr=zeros(p.shape[:-1]),
                             vc=zeros(p.shape[:-2] + p.shape[-1:]))
        return _Full(v=zeros(p.shape))
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AfState(step=torch.zeros((), dtype=torch.int32, device=dev),
                   slots=tree_map(slot, params))


def adafactor_slot_shapes(param_shapes) -> AfState:
    """Meta-tensor mirror of ``adafactor_init`` (a step's abstract
    inputs)."""
    def meta(shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def slot(p):
        if len(p.shape) >= 2:
            return _Factored(vr=meta(p.shape[:-1]),
                             vc=meta(p.shape[:-2] + p.shape[-1:]))
        return _Full(v=meta(p.shape))
    return AfState(step=torch.empty((), dtype=torch.int32, device="meta"),
                   slots=tree_map(slot, param_shapes))


def adafactor_slot_axes(param_axes) -> AfState:
    """Logical-axis mirror for sharding the factored state."""
    def slot(axes):
        axes = tuple(axes)
        if len(axes) >= 2:
            return _Factored(vr=axes[:-1], vc=axes[:-2] + axes[-1:])
        return _Full(v=axes)
    return AfState(step=(),
                   slots=tree_map(slot, param_axes,
                                  is_leaf=lambda t: isinstance(t, tuple)))


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, params, grads, state: AfState,
                     lr_scale: Any = 1.0) -> Tuple[Any, AfState, torch.Tensor]:
    step = state.step + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - t ** (-cfg.decay)
    lr = cfg.lr * lr_scale
    gnorm = global_norm(grads)

    def upd(p, g, slot: AfSlot):
        g32 = g.float()
        g2 = torch.square(g32) + cfg.eps1
        if isinstance(slot, _Factored):
            vr = beta2 * slot.vr + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * slot.vc + (1 - beta2) * torch.mean(g2, dim=-2)
            # vhat = vr x vc / mean(vr)  (outer product, factored)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            vhat = (vr / torch.clamp(denom, min=cfg.eps1))[..., :, None] \
                * vc[..., None, :]
            new_slot: AfSlot = _Factored(vr, vc)
        else:
            v = beta2 * slot.v + (1 - beta2) * g2
            vhat = v
            new_slot = _Full(v)
        u = g32 / torch.sqrt(torch.clamp(vhat, min=cfg.eps1))
        u = u / torch.clamp(_rms(u) / cfg.clip_threshold, min=1.0)
        p32 = p.float()
        scale = lr * torch.clamp(_rms(p32), min=cfg.eps2)
        p32 = p32 - scale * u - lr * cfg.weight_decay * p32
        return p32.to(p.dtype), new_slot

    flat_p, treedef = tree_flatten(params)
    out = [upd(p, g, s) for p, g, s in zip(
        flat_p, flatten_up_to(treedef, grads),
        flatten_up_to(treedef, state.slots))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            AfState(step=step,
                    slots=tree_unflatten(treedef, [o[1] for o in out])),
            gnorm)
