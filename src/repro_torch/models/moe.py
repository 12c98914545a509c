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

Inside a sharded serving step the block runs expert-parallel over the
step's ``ExpertAxis`` (the data axes that split the experts) and
tensor-parallel over its ``ModelAxis``. The router runs on the rank's own
rows (capacity is per row, so routing needs nothing of the other rows);
its weight, split over the expert axis on its expert columns, is the one
weight gathered whole (d_model x E), and the rank's rows are laid out at
their places in the step's batch, zeros elsewhere, so that the logits
come from the same product as one process's. The dispatched
``expert_in`` (G_loc, E, C, D) goes to the experts' ranks by an
all-to-all, each rank then holding every row's inputs to its own E_loc
experts in the data ranks' order (one process's layout sliced to
E_loc); the experts' SwiGLU runs on the rank's ``expert_mlp`` columns
(their ``mlp_columns`` where the model axis does not divide them), the
``wo`` partials summed over the model axis in f32 and rounded once; the
outputs go back by the reverse all-to-all before ``combine``. Where the
data axes do not divide the experts, every rank holds them all and
nothing is exchanged. Arctic's dense residual is the dense MLP's
column- and row-parallel products (``layers.swiglu_mlp``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (LOCAL, ExpertAxis, batch_mean,
                                              expert_axis, model_axis)
from repro_torch.models.common import P
from repro_torch.models.layers import mlp_columns, swiglu_mlp


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


def router_logits(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (G, S, D) times the router's weight, in x's type. Inside a
    sharded step the weight is gathered whole over the expert axis (or
    over the model axis, where the serving fallback splits its embed
    dim) and the rank's rows sit at their places in the step's batch
    (``ExpertAxis.rows``), zeros elsewhere: one product of one
    process's shape, whose rows are one process's rows bit for bit."""
    w = params["router"]
    ex = expert_axis()
    if ex is None:
        return torch.einsum("gsd,de->gse", x, w.to(x.dtype))
    if w.shape[1] != cfg.moe.num_experts:
        w = ex.gather(w, 1)
    if w.shape[0] != cfg.d_model:
        w = (model_axis() or LOCAL).gather(w, 0)
    start, total = ex.rows
    G = x.shape[0]
    if total != G:
        x = torch.cat([x.new_zeros((start,) + x.shape[1:]), x,
                       x.new_zeros((total - start - G,) + x.shape[1:])])
    return torch.einsum("gsd,de->gse", x, w.to(x.dtype))[start:start + G]


def choose(params, x: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's choice for x (G, S, D): the f32 probabilities (G, S, E),
    the normalised gate values and the chosen experts (G, S, K)."""
    logits = router_logits(params, x, cfg)
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


def wide_bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (G, E, C, K) times w (E, K, N), expert by expert, in f32 from
    operands in a's dtype: on the card one batched GEMM with an f32
    output, elsewhere in f32 (exact products either way), as
    ``layers.wide_product``."""
    w = w.to(a.dtype)
    if a.is_cuda and a.dtype != torch.float32:
        G, E, C, K = a.shape
        out = torch.bmm(a.transpose(0, 1).reshape(E, G * C, K), w,
                        out_dtype=torch.float32)
        return out.view(E, G, C, -1).transpose(0, 1)
    return torch.einsum("gecf,efd->gecd", a.float(), w.float())


def experts(params, xin: torch.Tensor, cfg) -> torch.Tensor:
    """The SwiGLU of each expert whose weights this rank holds on its
    inputs xin (G, E', C, D) -> (G, E', C, D), in xin's type. Inside a
    sharded step on the rank's ``expert_mlp`` columns: its split, or its
    ``mlp_columns`` of weights whole on every rank of the model axis;
    ``wo``'s partial products summed over the axis in f32 and rounded
    once (``layers.row_parallel``'s rule). Where the serving fallback
    splits the embed dim instead, ``wg`` and ``wi`` multiply the rank's
    slice of xin (summed) and ``wo`` gives its output columns
    (gathered)."""
    dt = xin.dtype
    ax = model_axis() or LOCAL
    D, ff = cfg.d_model, cfg.moe.d_ff
    wg, wi, wo = params["wg"], params["wi"], params["wo"]
    if ax.size > 1 and tuple(wo.shape[1:]) == (ff, D):
        lo, hi = mlp_columns(ff, ax.size, ax.index)
        wg, wi, wo = wg[..., lo:hi], wi[..., lo:hi], wo[:, lo:hi]

    def up(w):
        if w.shape[1] == D:
            return torch.einsum("gecd,edf->gecf", xin, w.to(dt))
        return ax.sum(wide_bmm(ax.mine(xin, -1, w.shape[1]), w)).to(dt)
    h = F.silu(up(wg)) * up(wi)
    if wo.shape[-1] != D:
        return ax.gather(torch.einsum("gecf,efd->gecd", h, wo.to(dt)), -1)
    if ax.size == 1:
        return torch.einsum("gecf,efd->gecd", h, wo.to(dt))
    return ax.sum(wide_bmm(h, wo)).to(dt)


def dispatch(ex: ExpertAxis, expert_in: torch.Tensor) -> torch.Tensor:
    """(G_loc, E, C, D) inputs of this rank's rows to every expert ->
    (size x G_loc, E_loc, C, D) inputs of every rank's rows (in the
    axis's order) to this rank's E_loc experts, by one all-to-all."""
    G, E, C, D = expert_in.shape
    n = ex.size
    parts = expert_in.reshape(G, n, E // n, C, D).transpose(0, 1)
    return ex.all_to_all(parts).reshape(n * G, E // n, C, D)


def combine_back(ex: ExpertAxis, expert_out: torch.Tensor) -> torch.Tensor:
    """``dispatch``'s inverse: (size x G_loc, E_loc, C, D) outputs of this
    rank's experts -> (G_loc, E, C, D) outputs for this rank's rows."""
    GN, El, C, D = expert_out.shape
    n = ex.size
    back = ex.all_to_all(expert_out.reshape(n, GN // n, El, C, D))
    return back.transpose(0, 1).reshape(GN // n, n * El, C, D)


def moe_block(params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    Each batch row is a dispatch group; tokens routed to top-k experts with
    per-group capacity C. Overflow tokens are dropped (standard GShard);
    the dense residual (if any) catches them. Weights are cast to x's type
    at each call, as the reference casts them. Inside a sharded step,
    expert-parallel (the module docstring).
    """
    e = cfg.moe
    r = route(params, x, cfg)

    expert_in = torch.einsum("gsec,gsd->gecd", r["dispatch"], x)   # (G,E,C,D)
    split = params["wo"].shape[0] != e.num_experts
    if split:                      # to the experts' ranks
        expert_in = dispatch(expert_axis(), expert_in)
    expert_out = experts(params, expert_in, cfg)
    if split:                      # and back
        expert_out = combine_back(expert_axis(), expert_out)

    out = torch.einsum("gsec,gecd->gsd", r["combine"], expert_out)  # (G,S,D)

    if e.dense_residual_d_ff:
        out = out + swiglu_mlp(
            {w: params[f"dense_{w}"] for w in ("wi", "wg", "wo")}, x, cfg,
            d_ff=e.dense_residual_d_ff, kernel=False)

    return out, r["aux"] * e.aux_loss_weight
