"""Common layers: RMSNorm, RoPE / M-RoPE, SwiGLU MLP, GQA attention (the
port of ``repro.models.layers``).

Attention has two execution paths with identical math:
  - chunked online-softmax attention in torch ops (a Python loop over the
    reference's query and key chunks), and
  - the flash-attention kernel (``kernels.ops.flash_attention``, CUDA on
    the card) when ``cfg.use_pallas``; the SwiGLU MLP then runs its three
    products through the matmul kernel (``kernels.ops.matmul``).

Products the reference accumulates in f32 (``preferred_element_type``) take
f32 operands here: a product of two bf16 values is exact in f32, so the
sums are the same up to their order. The chunked path upcasts one key
chunk at a time, never a whole k or v. The reference's sharding
constraints are dropped: one card has no mesh, and the reference's own
``constrain`` does nothing without one.

Inside a sharded serving step (``sharding.model_axis()`` is set) each rank
holds its shards of the weights, by the serving shardings, and computes
its share (tensor parallelism over the model axis): ``wq``, ``wk``, ``wv``
and the MLP's ``wg``, ``wi`` column-parallel on its heads and hidden
columns, ``wo`` row-parallel (``row_parallel``: the partial products
summed over the axis in f32, rounded once); a weight split on its embed
dim (the serving fallback where heads do not divide the axis) multiplies
the rank's slice of ``x`` and sums, or, for an output projection, gives
the rank's output columns (``out_product``). Where the axis does not
divide the heads, a rank computes a range of whole kv groups
(``head_split``), which a weight whole on every rank gives by slicing,
with no collective. Decode against a cache split over positions is
split-KV attention (``decode_gqa_attention`` on the axis): q gathered,
each rank attending over its positions, the parts combined by their max
and sums. One device runs the same bodies on ``LOCAL``, whose
collectives are the identity; where a split would change one device's
arithmetic (the row-parallel products, decode's softmax) the size-1 axis
keeps it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (LOCAL, LocalAxis, ceil_split,
                                              model_axis)

Index = Union[int, torch.Tensor]

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x (..., S, H, D) by angles (..., S, 1, D/2),
    in f32, cast back to x's type."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    return _rotate(x, angles[..., None, :])


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, D); positions: (3, B, S) — t/h/w position ids. The D/2
    frequency slots are split into `sections` (t, h, w); each section rotates
    by its own position component.
    """
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    # the position component of each frequency slot
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=d // 2)                                   # (D/2,)
    pos_per_slot = positions.float()[sec_id]                  # (D/2, B, S)
    angles = torch.einsum("fbs,f->bsf", pos_per_slot, freqs)  # (B, S, D/2)
    return _rotate(x, angles[..., None, :])


# ---------------------------------------------------------------------------
# GQA attention — chunked online-softmax (torch ops) path
# ---------------------------------------------------------------------------


def _chunk_size(seq: int, target: int) -> int:
    """Largest divisor of `seq` that is <= `target`."""
    c = max(1, min(seq, target))
    while seq % c:
        c -= 1
    return c


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """q times 1/sqrt(D), the factor rounded to q's type first."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype,
                         device=q.device)
    return q * scale


def full_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, q_offset: Index = 0
                       ) -> torch.Tensor:
    """Plain (materialized-scores) attention: the reference's cost-probe
    path (``cfg.exact_costs``), O(S*T) memory."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qr = _scaled(q).reshape(B, S, KVH, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qr.float(), k.float())
    if causal:
        dev = q.device
        mask = ((torch.arange(S, device=dev)[:, None] + q_offset)
                >= torch.arange(T, device=dev)[None, :])
        s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def chunked_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: Index = 0,
                          q_chunk: int = 512,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded attention with online softmax (flash-style).

    q: (B, S, H, D);  k, v: (B, T, KVH, D);  H = KVH * G.
    Returns (B, S, H, D). The causal mask uses absolute positions
    (q position = q_offset + index), so it also serves chunked prefill.
    The reference's two ``lax.scan``s are loops over the same chunks.
    """
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qc, kc = _chunk_size(S, q_chunk), _chunk_size(T, kv_chunk)
    nq, nk = S // qc, T // kc
    dev = q.device

    qr = _scaled(q).reshape(B, nq, qc, KVH, G, D)
    kr = k.reshape(B, nk, kc, KVH, D)
    vr = v.reshape(B, nk, kc, KVH, D)
    q_pos = torch.arange(S, device=dev).reshape(nq, qc) + q_offset
    k_pos = torch.arange(T, device=dev).reshape(nk, kc)

    outs = []
    for i in range(nq):
        qb = qr[:, i].float()                                 # (B,qc,KVH,G,D)
        m = torch.full((B, KVH, G, qc), -math.inf, device=dev)
        l = torch.zeros((B, KVH, G, qc), device=dev)
        acc = torch.zeros((B, KVH, G, qc, D), device=dev)
        for j in range(nk):
            kb, vb = kr[:, j], vr[:, j]
            s = torch.einsum("bqkgd,bckd->bkgqc", qb, kb.float())
            if causal:
                mask = q_pos[i][:, None] >= k_pos[j][None, :]  # (qc, kc)
                s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (m_new == -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]      # (B,KVH,G,qc,D)
        outs.append(out.permute(0, 3, 1, 2, 4))               # (B,qc,KVH,G,D)
    out = torch.stack(outs, dim=1).reshape(B, S, H, D)
    return out.to(q.dtype)


def decode_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_index: Index,
                         ax: LocalAxis = LOCAL) -> torch.Tensor:
    """Single-token decode attention against a (B, T, KVH, D) cache.

    q: (B, 1, H, D). Positions > cache_index are masked out.
    ``cache_index`` may be a scalar (lockstep decode) or (B,) per-slot
    lengths (continuous batching in the serving engine). On a model axis
    whose ranks hold the cache split over positions (this rank T of them,
    from ``ax.index * T``) and q of every head, split-KV attention: the
    scores' max over the axis, the softmax's sum over the axis, and P
    (rounded to v's type, as one device rounds it) times the rank's
    values summed over the axis.
    """
    B, _, H, D = q.shape
    T, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    dev = q.device
    qr = _scaled(q).reshape(B, KVH, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qr.float(), k_cache.float())
    pos = torch.arange(ax.index * T, (ax.index + 1) * T, device=dev)
    ci = torch.as_tensor(cache_index, device=dev)
    valid = pos[None] <= (ci[:, None] if ci.ndim == 1 else ci)  # (B | 1, T)
    s = torch.where(valid[:, None, None], s, -math.inf)
    if ax.size == 1:
        p = torch.softmax(s, dim=-1)
    else:
        m = ax.max(s.amax(dim=-1, keepdim=True))  # position 0 is valid
        e = torch.exp(s - m)
        p = e / ax.sum(e.sum(dim=-1, keepdim=True))
    out = ax.sum(torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                              v_cache.float()))
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Tensor-parallel products
# ---------------------------------------------------------------------------


def wide_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ w (K, N) in f32 from operands in a's dtype: on the card
    one GEMM with an f32 output (no f32 copy of w), elsewhere in f32 (a
    product of two bf16 values is exact in f32 either way)."""
    w = w.to(a.dtype)
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a.reshape(-1, a.shape[-1]), w,
                        out_dtype=torch.float32).unflatten(0, a.shape[:-1])
    return a.float() @ w.float()


def row_parallel(a: torch.Tensor, w: torch.Tensor, ax: LocalAxis,
                 kernel: bool = False) -> torch.Tensor:
    """a (..., K) @ w (K, N), or a (B, S, H, D) times w (H, D, E) over H
    and D, with the contraction split over the model axis (this rank's
    rows of w, none on a rank with no part): on one device the product
    in a's dtype; on an axis each rank's partial product in f32 (zeros
    where it holds no rows), summed over the axis and rounded once to
    a's dtype. ``kernel``: the matmul kernel (its sums are f32)."""
    from repro_torch.kernels import ops as kops
    w = w.to(a.dtype)
    if ax.size == 1:
        if kernel:
            return kops.matmul(a, w)
        return a @ w if w.ndim == 2 else torch.einsum("bshd,hde->bse", a, w)
    if w.ndim == 3:
        a, w = a.flatten(2), w.flatten(0, 1)
    if not a.shape[-1]:
        part = a.new_zeros(a.shape[:-1] + w.shape[-1:], dtype=torch.float32)
    else:
        part = (kops.matmul(a, w, out_dtype=torch.float32) if kernel
                else wide_product(a, w))
    return ax.sum(part).to(a.dtype)


def out_product(a: torch.Tensor, w: torch.Tensor, E: int, ax: LocalAxis,
                kernel: bool = False) -> torch.Tensor:
    """A block's output projection: a times w (K, E) or (H, D, E). Where
    w is split on its output embed dim (the serving fallback), a holds
    every row of w; the rank's E / size columns are computed whole in
    a's dtype, as one device computes them, and gathered over the axis.
    Else a holds the rows of w that this rank holds (``row_parallel``)."""
    if w.shape[-1] == E:
        return row_parallel(a, w, ax, kernel)
    from repro_torch.kernels import ops as kops
    if w.ndim == 3:
        a, w = a.flatten(2), w.flatten(0, 1)
    w = w.to(a.dtype)
    return ax.gather(kops.matmul(a, w) if kernel else a @ w, -1)


def column_product(x: torch.Tensor, w: torch.Tensor,
                   ax: LocalAxis, kernel: bool = False) -> torch.Tensor:
    """x (..., E) times w (E, ...) whole or split on its trailing dims
    (this rank's heads or columns); w split on its embed dim instead (the
    serving fallback, where no trailing dim divides the axis): this
    rank's slice of x times its rows, summed over the axis (every
    column). ``kernel``: the matmul kernel, for a 2-d w."""
    if w.shape[0] == x.shape[-1]:
        w = w.to(x.dtype)
        if kernel:
            from repro_torch.kernels import ops as kops
            return kops.matmul(x, w)
        return (x @ w if w.ndim == 2 else
                torch.einsum("bse,ehd->bshd", x, w))
    return row_parallel(ax.mine(x, -1, w.shape[0]), w.flatten(1),
                        ax, kernel).unflatten(-1, w.shape[1:])


def column_ranges(x: torch.Tensor, ws, ax: LocalAxis):
    """x (..., E) times entries ``lo .. hi`` of the second dim (``n``
    heads or columns) of w, for each ``(w, n, lo, hi)`` of ``ws``,
    whatever w's storage: whole, sliced before the product (no
    collective); split on its embed dim, every entry (the partial
    products summed), then sliced; split on that dim, this rank's part,
    which must be ``lo .. hi``. The partial products of all the weights
    split on their embed dim are summed in one all-reduce."""
    out, summed = [], []
    for w, n, lo, hi in ws:
        if w.shape[0] != x.shape[-1]:          # split on its embed dim
            summed.append(len(out))
            out.append(wide_product(ax.mine(x, -1, w.shape[0]),
                                    w.flatten(1)))
            continue
        if w.shape[1] == n:                    # whole: slice, then multiply
            w = w.narrow(1, lo, hi - lo)
        else:
            assert w.shape[1] == hi - lo, (tuple(w.shape), lo, hi)
        out.append(column_product(x, w, ax))
    for i, y in zip(summed, ax.sum_all([out[i] for i in summed])):
        w, _, lo, hi = ws[i]
        out[i] = (y.to(x.dtype).unflatten(-1, w.shape[1:])
                  .narrow(x.ndim - 1, lo, hi - lo))
    return out


def own_rows(t: torch.Tensor, n: int, lo: int, hi: int,
             dim: int = 0) -> torch.Tensor:
    """Entries ``lo .. hi`` of ``t`` along ``dim`` (of ``n``): ``t`` holds
    all ``n`` (sliced here) or, split over the axis, exactly these."""
    if t.shape[dim] == n:
        return t.narrow(dim, lo, hi - lo)
    assert t.shape[dim] == hi - lo, (tuple(t.shape), n, lo, hi)
    return t


def head_split(cfg, ax: LocalAxis) -> Tuple[int, int, int, int, int]:
    """This rank's query heads ``qlo .. qhi`` and the kv heads ``klo ..
    khi`` they read, and the ``unit`` of heads its range is made of.
    Where the axis divides the heads, their even split (``wq`` and
    ``wo`` are stored so; unit 1). Else ``split(KVH)`` of whole kv groups
    (unit G = H / KVH query heads), as GSPMD pads an uneven dim: every
    rank's query heads read only its own kv heads, so each flash launch
    keeps G, and the last ranks may hold no head."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    G = H // KVH
    if H % ax.size == 0:
        qlo, qhi = ax.split(H)
        return qlo, qhi, qlo // G, -(-qhi // G), 1
    klo, khi = ax.split(KVH)
    return klo * G, khi * G, klo, khi, G


def gather_heads(t: torch.Tensor, n: int, unit: int,
                 ax: LocalAxis) -> torch.Tensor:
    """``t`` (..., h, D) on this rank's heads (its ``split`` of ``n``
    runs of ``unit`` heads) as every head, gathered over the axis."""
    runs = t.reshape(t.shape[:-2] + (t.shape[-2] // unit, unit, t.shape[-1]))
    return ax.gather(runs, -3, n).flatten(-3, -2)


def _all_kv_heads(t: torch.Tensor, ax: LocalAxis, KVH: int) -> torch.Tensor:
    return t if t.shape[2] == KVH else ax.gather(t, 2)


# ---------------------------------------------------------------------------
# Attention block (projection + rope + attention + out projection)
# ---------------------------------------------------------------------------


def attention_block(params, x: torch.Tensor, cfg, *, positions=None,
                    cache=None, cache_index=None, causal: bool = True,
                    encoder_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None):
    """GQA attention block.

    params: {wq, wk, wv, wo [, bq, bk, bv]} — wq: (E, H, D) etc.
    x: (B, S, E). Returns ``(out, extras)`` where extras is
      {"cache": (k_cache, v_cache)}   in decode mode (cache given), or
      {"kv": (k, v)}                  in full-sequence self-attention, or
      {}                              in cross-attention.
    If `encoder_kv` is given, runs cross-attention (no rope, no causal).
    Inside a sharded serving step, on this rank's heads (``head_split``;
    a rank with none attends to nothing and adds a zero partial), the
    cache and ``kv`` in the step's layout over the model axis (``ax.kv``),
    ``encoder_kv`` as the cross cache holds it (every kv head, or this
    rank's where the axis divides them). ``wo`` whole on every rank is
    contracted over this rank's heads' rows; split on its output embed
    dim, it takes every head's output (gathered over the axis).
    """
    S, E = x.shape[1], x.shape[2]
    dt = x.dtype
    ax = model_axis() or LOCAL
    cross = encoder_kv is not None
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    qlo, qhi, lo, hi, unit = head_split(cfg, ax)
    count = H // unit

    (q,) = column_ranges(x, [(params["wq"], H, qlo, qhi)], ax)
    if cfg.qkv_bias:
        q = q + own_rows(params["bq"], H, qlo, qhi).to(dt)

    if cross:
        k, v = encoder_kv
    else:
        k = column_product(x, params["wk"], ax)
        v = column_product(x, params["wv"], ax)
        if cfg.qkv_bias:
            k = k + params["bk"].to(dt)
            v = v + params["bv"].to(dt)

    if not cross:
        if positions is None:
            if cache_index is None:
                base = 0
            else:
                ci = torch.as_tensor(cache_index, device=x.device)
                base = ci[:, None] if ci.ndim == 1 else ci   # per-slot ok
            pos = base + torch.arange(S, device=x.device)[None, :]  # (1|B, S)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        elif cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    # a rank with no query heads attends to nothing: q (B, S, 0, D) is
    # its output, and no attention kernel is launched for it
    none = qhi == qlo
    extras: dict = {}
    if cache is not None and not cross:
        # decode: write this token's k/v at cache_index, attend to cache
        k_cache, v_cache = cache                             # (B, T, KVH, D)
        if ax.kv == "seq":
            k_cache = _write_cache(k_cache, _all_kv_heads(k, ax, KVH),
                                   cache_index, ax)
            v_cache = _write_cache(v_cache, _all_kv_heads(v, ax, KVH),
                                   cache_index, ax)
            out = decode_gqa_attention(
                gather_heads(q, count, unit, ax), k_cache, v_cache,
                cache_index, ax).narrow(2, qlo, qhi - qlo)
        else:
            heads = ax.kv == "heads"
            k, v = ((own_rows(k, KVH, lo, hi, 2), own_rows(v, KVH, lo, hi, 2))
                    if heads else
                    (_all_kv_heads(k, ax, KVH), _all_kv_heads(v, ax, KVH)))
            k_cache = _write_cache(k_cache, k, cache_index)
            v_cache = _write_cache(v_cache, v, cache_index)
            out = q if none else decode_gqa_attention(
                q, k_cache if heads else k_cache[:, :, lo:hi],
                v_cache if heads else v_cache[:, :, lo:hi], cache_index)
        extras["cache"] = (k_cache, v_cache)
    elif cross:
        km, vm = own_rows(k, KVH, lo, hi, 2), own_rows(v, KVH, lo, hi, 2)
        out = (q if none else
               full_gqa_attention(q, km, vm, causal=False)
               if cfg.exact_costs else
               chunked_gqa_attention(q, km, vm, causal=False))
    else:
        km, vm = own_rows(k, KVH, lo, hi, 2), own_rows(v, KVH, lo, hi, 2)
        if none:
            out = q
        elif cfg.exact_costs:
            # the reference's cost probe: scan-free, flop-equivalent
            out = full_gqa_attention(q, km, vm, causal=causal)
        elif cfg.use_pallas:
            from repro_torch.kernels import ops as kops
            out = kops.flash_attention(q, km, vm, causal=causal)
        else:
            out = chunked_gqa_attention(q, km, vm, causal=causal)
        if ax.kv == "heads":
            k, v = km, vm
        else:
            k, v = _all_kv_heads(k, ax, KVH), _all_kv_heads(v, ax, KVH)
            if ax.kv == "seq":
                n = k.shape[1] // ax.size
                k, v = ax.mine(k, 1, n), ax.mine(v, 1, n)
        extras["kv"] = (k, v)

    wo = params["wo"]
    if wo.shape[-1] != E:
        out = gather_heads(out, count, unit, ax)
    elif ax.size > 1 and wo.shape[0] == H:
        wo = wo[qlo:qhi]              # whole: this rank's heads' rows
    return out_product(out, wo, E, ax), extras


def _write_cache(cache: torch.Tensor, kv: torch.Tensor, index: Index,
                 ax: LocalAxis = LOCAL) -> torch.Tensor:
    """Write (B, 1, KVH, D) kv into (B, T, KVH, D) cache at position index
    (a new tensor; the cache given is left as it was).

    Scalar index: one slice write, its start clamped so that the slice
    fits (as ``lax.dynamic_update_slice`` clamps). (B,) per-slot indices
    (continuous batching): one-hot masked write. A meta index (the dry
    run's abstract inputs) has no value: the slice is written at 0, the
    same ops on the same shapes as at any start. On a model axis whose
    ranks hold the cache split over positions (this rank T of them, from
    ``ax.index * T``), only the rank whose positions hold the index
    writes; the others return their cache as it is.
    """
    T = cache.shape[1]
    at = ax.index * T
    idx = torch.as_tensor(index, device=cache.device)
    if idx.ndim == 1:
        onehot = (torch.arange(at, at + T, device=cache.device)[None, :]
                  == idx[:, None])                             # (B, T)
        return torch.where(onehot[:, :, None, None], kv.to(cache.dtype),
                           cache)
    n = kv.shape[1]
    start = (0 if idx.is_meta else
             min(max(int(idx), 0), T * ax.size - n)) - at
    lo, hi = max(start, 0), min(start + n, T)
    if lo >= hi:
        return cache
    out = cache.clone()
    out[:, lo:hi] = kv[:, lo - start:hi - start].to(cache.dtype)
    return out


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_columns(F: int, size: int, index: int) -> Tuple[int, int]:
    """Rank ``index``'s range of the ``F`` hidden columns of an MLP whose
    weights are whole on each of ``size`` ranks: the ``ceil_split`` of F
    in units of 8 columns (the matmul kernel's tensor cores take K and N
    multiples of 8), of 1 where 8 does not divide F; the last ranks may
    hold none."""
    unit = 8 if F % 8 == 0 else 1
    lo, hi = ceil_split(F // unit, size, index)
    return lo * unit, hi * unit


def swiglu_mlp(params, x: torch.Tensor, cfg=None, *,
               d_ff: Optional[int] = None,
               kernel: Optional[bool] = None) -> torch.Tensor:
    """params: {wi (E,F), wg (E,F), wo (F,E)}, F = ``d_ff`` (by default
    ``cfg.d_ff``); the products through the matmul kernel where
    ``kernel`` (by default ``cfg.use_pallas``). Inside a sharded serving
    step ``wg`` and ``wi`` are column-parallel and ``wo`` row-parallel
    over this rank's hidden columns: its split of ``mlp`` or, where the
    axis does not divide F and the weights are whole on every rank, its
    ``mlp_columns``, sliced here (so no product is summed twice).
    Split on their embed dim instead (the serving fallback), ``wg`` and
    ``wi`` give every column (the partial products summed) and ``wo``
    the rank's output columns (``out_product``)."""
    ax = model_axis() or LOCAL
    E = x.shape[-1]
    wg, wi, wo = params["wg"], params["wi"], params["wo"]
    if ax.size > 1 and tuple(wo.shape) == (d_ff or cfg.d_ff, E):
        lo, hi = mlp_columns(wo.shape[0], ax.size, ax.index)
        wg, wi, wo = wg[:, lo:hi], wi[:, lo:hi], wo[lo:hi]
        if lo == hi:                # no columns: a zero partial
            return row_parallel(x[..., :0], wo, ax)
    if kernel is None:
        kernel = cfg is not None and cfg.use_pallas
    h = (F.silu(column_product(x, wg, ax, kernel))
         * column_product(x, wi, ax, kernel))
    return out_product(h, wo, E, ax, kernel)
