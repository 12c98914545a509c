"""Plain PyTorch oracles for the kernels (independent implementations)."""
from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, group: int = 1,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive softmax attention. q (BH,S,D); k,v (BKV,T,D); BH = BKV*group."""
    BH, S, D = q.shape
    T = k.shape[1]
    k = torch.repeat_interleave(k, group, dim=0)
    v = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / math.sqrt(D)
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def ssd_ref(x, dt, A, Bm, Cm, D):
    """Sequential (per-token) SSD recurrence — independent of the chunked
    algorithm. x (B,S,NH,HD), dt (B,S,NH), A (NH,), Bm/Cm (B,S,DS), D (NH,).
    Returns (y (B,S,NH,HD) f32, h_final (B,NH,HD,DS) f32)."""
    B, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    A, D = A.float(), D.float()
    h = torch.zeros(B, NH, HD, DS, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None])                   # (B,NH)
        h = a[..., None, None] * h + torch.einsum(
            "bh,bhd,be->bhde", dt[:, t], x[:, t], Bm[:, t])
        ys.append(torch.einsum("bhde,be->bhd", h, Cm[:, t])
                  + x[:, t] * D[None, :, None])
    return torch.stack(ys, dim=1), h
