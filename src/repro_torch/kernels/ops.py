"""Public wrappers around the kernels: the entry points a model calls on
its ``use_pallas`` path (ports of ``repro.kernels.ops``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.descriptor import build_plain
from repro_torch.kernels.flash_attention import flash_attention_desc
from repro_torch.kernels.mamba2_scan import mamba2_scan_desc
from repro_torch.kernels.matmul import matmul_desc


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
           bk: int = 512, bn: int = 128,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (..., M, K) @ b (K, N) through the matmul kernel; output in
    ``out_dtype``, a.dtype by default (the kernel's sums are f32: a
    partial product summed across ranks keeps them)."""
    *lead, M, K = a.shape
    N = b.shape[-1]
    a2 = a.reshape(-1, K).contiguous()
    desc = matmul_desc(a2.shape[0], K, N, a.dtype, bm=bm, bk=bk, bn=bn)
    out = build_plain(desc)(a2, b.contiguous())[0]
    return out.reshape(*lead, M, N).to(out_dtype or a.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 256,
                    bk: int = 512) -> torch.Tensor:
    """q (B,S,H,D); k,v (B,T,KVH,D) -> (B,S,H,D)."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qf = q.transpose(1, 2).reshape(B * H, S, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * KVH, T, D).contiguous()
    vf = v.transpose(1, 2).reshape(B * KVH, T, D).contiguous()
    desc = flash_attention_desc(B * H, S, T, D, G, q.dtype, causal=causal,
                                bq=bq, bk=bk)
    out = build_plain(desc)(qf, kf, vf)[0]
    return out.reshape(B, H, S, D).transpose(1, 2)


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 256):
    """Chunked SSD scan. x (B,S,NH,HD), dt (B,S,NH), A (NH,), Bm/Cm (B,S,DS),
    D (NH,). Returns (y (B,S,NH,HD) x.dtype, h_final (B,NH,HD,DS) f32).
    The model passes x, Bm and Cm as strided views of one activation; they
    are made contiguous here."""
    B, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    desc = mamba2_scan_desc(B, S, NH, HD, DS, chunk, x.dtype)
    y, h = build_plain(desc)(*(t.contiguous() for t in (x, dt, A, Bm, Cm,
                                                         D)))
    return y, h
