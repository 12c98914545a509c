"""Mixture-of-Experts: top-k router + capacity-based einsum dispatch (GShard
style), the port of ``repro.models.moe``. Supports an arctic-style
parallel dense residual branch.

The reference computes the block as einsums outside any Pallas kernel, so
the port's block is torch ops on both paths (``use_pallas`` or not). Three
points where torch's defaults differ from JAX's are taken the reference's
way:

  - the top k experts are the first k of a *stable* descending sort, so
    that ties go to the lower expert index as ``lax.top_k`` gives them
    (``torch.topk`` orders ties arbitrarily, and bf16 router logits tie
    often);
  - a choice dropped for capacity gets an all-zero one-hot row (JAX's
    ``one_hot`` of an out-of-range index), built by comparison;
  - capacity positions are counted k-major, so every token's first choice
    wins capacity before any token's second.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import batch_mean
from repro_torch.models.common import P


def moe_specs(cfg) -> Dict[str, P]:
    e = cfg.moe
    d = cfg.d_model
    specs: Dict[str, P] = {
        "router": P((d, e.num_experts), ("embed", "expert")),
        "wi": P((e.num_experts, d, e.d_ff), ("expert", "embed", "expert_mlp")),
        "wg": P((e.num_experts, d, e.d_ff), ("expert", "embed", "expert_mlp")),
        "wo": P((e.num_experts, e.d_ff, d), ("expert", "expert_mlp", "embed")),
    }
    if e.dense_residual_d_ff:
        f = e.dense_residual_d_ff
        specs["dense_wi"] = P((d, f), ("embed", "mlp"))
        specs["dense_wg"] = P((d, f), ("embed", "mlp"))
        specs["dense_wo"] = P((f, d), ("mlp", "embed"))
    return specs


def _capacity(tokens_per_group: int, cfg) -> int:
    e = cfg.moe
    c = math.ceil(tokens_per_group * e.experts_per_token / e.num_experts
                  * e.capacity_factor)
    return max(4, c)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis and their indices, largest first,
    ties to the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def choose(params, x: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's choice for x (G, S, D): the f32 probabilities (G, S, E),
    the normalised gate values and the chosen experts (G, S, K)."""
    logits = torch.einsum("gsd,de->gse", x, params["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)                # (G,S,E)
    gate_vals, expert_idx = top_k(probs, cfg.moe.experts_per_token)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def route(params, x: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """The router of ``moe_block``: for x (G, S, D), the chosen experts
    ``expert_idx`` (G, S, K), the normalised ``gate_vals``, the 0/1
    ``dispatch`` and the gate-weighted ``combine`` tensors (G, S, E, C) in
    x's type, and the unweighted load-balancing ``aux`` loss (f32)."""
    e = cfg.moe
    B, S, _ = x.shape
    E, K = e.num_experts, e.experts_per_token
    C = _capacity(S, cfg)
    dt = x.dtype
    probs, gate_vals, expert_idx = choose(params, x, cfg)

    # load-balancing auxiliary loss (Switch/GShard); in a sharded step the
    # load ce is the whole batch's (a product of means is not a mean over
    # batch shards), while me's mean over the shards is the step's own
    # average of the loss and gradients, since aux is linear in me
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = batch_mean(F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1)))
    aux = (E * torch.sum(me * ce)).float()

    # position-in-expert via cumsum over the flattened (token, k) choices,
    # k-major: every k = 0 choice wins capacity before any k = 1 choice
    choice_1h = F.one_hot(expert_idx, E).to(torch.int32)         # (G,S,K,E)
    flat = choice_1h.permute(0, 2, 1, 3).reshape(B, K * S, E)
    pos = torch.cumsum(flat, dim=1) - 1                          # (G,KS,E)
    pos = pos.reshape(B, K, S, E).permute(0, 2, 1, 3)            # (G,S,K,E)
    within = (pos < C) & (choice_1h > 0)                         # (G,S,K,E)

    # one-hot of the slot, all zero for a choice past capacity (index C)
    slot = torch.where(within, pos, C)
    pos_c = (slot[..., None] == torch.arange(C, device=x.device)).to(dt)
    w = within[..., None].to(dt)
    dispatch = (w * pos_c).sum(dim=2)                            # (G,S,E,C)
    combine = (gate_vals[..., None, None].to(dt) * w * pos_c).sum(dim=2)
    return {"expert_idx": expert_idx, "gate_vals": gate_vals,
            "dispatch": dispatch, "combine": combine, "aux": aux}


def moe_block(params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    Each batch row is a dispatch group; tokens routed to top-k experts with
    per-group capacity C. Overflow tokens are dropped (standard GShard);
    the dense residual (if any) catches them. Weights are cast to x's type
    at each call, as the reference casts them.
    """
    e = cfg.moe
    dt = x.dtype
    r = route(params, x, cfg)

    expert_in = torch.einsum("gsec,gsd->gecd", r["dispatch"], x)   # (G,E,C,D)
    h = torch.einsum("gecd,edf->gecf", expert_in, params["wg"].to(dt))
    g = torch.einsum("gecd,edf->gecf", expert_in, params["wi"].to(dt))
    h = F.silu(h) * g
    expert_out = torch.einsum("gecf,efd->gecd", h, params["wo"].to(dt))

    out = torch.einsum("gsec,gecd->gsd", r["combine"], expert_out)  # (G,S,D)

    if e.dense_residual_d_ff:
        dh = (F.silu(x @ params["dense_wg"].to(dt))
              * (x @ params["dense_wi"].to(dt)))
        out = out + dh @ params["dense_wo"].to(dt)

    return out, r["aux"] * e.aux_loss_weight
