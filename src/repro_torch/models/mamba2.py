"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block in PyTorch
(the port of ``repro.models.mamba2``).

Two execution paths with identical math:
  - chunked SSD in torch ops, a Python loop over chunks, and
  - the SSD chunk-scan kernel (``kernels.ops.mamba2_scan``, CUDA on the
    card) when ``cfg.use_pallas``.

Recurrence (per head h, hidden dim d, state dim n):
    h_t = a_t * h_{t-1} + dt_t * x_t (x) B_t          h in R^{hd x ds}
    y_t = h_t @ C_t + D * x_t
with a_t = exp(dt_t * A), A = -exp(A_log) < 0.

The chunked algorithm splits the sequence into chunks of length L:
  intra-chunk  : (C_t . B_s) exp(cum_t - cum_s) dt_s  for s <= t  (L x L)
  chunk state  : sum_s exp(cum_L - cum_s) dt_s x_s (x) B_s
  inter-chunk  : scan over chunk states; y_inter = exp(cum_t) C_t @ H_c
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_scan import chunk_len
from repro_torch.models.common import P


def mamba2_specs(cfg) -> Dict[str, P]:
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    nh = s.num_heads(d)
    k = s.conv_kernel
    return {
        "wz": P((d, d_in), ("embed", "mlp")),
        "wx": P((d, d_in), ("embed", "mlp")),
        "wB": P((d, s.d_state), ("embed", None)),
        "wC": P((d, s.d_state), ("embed", None)),
        "wdt": P((d, nh), ("embed", "ssm_heads")),
        "conv_x": P((k, d_in), (None, "mlp")),
        "conv_B": P((k, s.d_state), (None, None)),
        "conv_C": P((k, s.d_state), (None, None)),
        "A_log": P((nh,), ("ssm_heads",), init="small_log"),
        "D": P((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": P((nh,), ("ssm_heads",), init="zeros"),
        "norm": P((d_in,), ("mlp",), init="ones"),
        "out_proj": P((d_in, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, C), w: (K, C).

    If `state` (B, K-1, C) is given it is prepended (decode / chunked
    prefill); otherwise zero left-padding.
    """
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None]
              for i in range(k))
    return out


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int, h0: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  (B, S, NH, HD)   dt: (B, S, NH)   A: (NH,) negative
    Bm: (B, S, DS)       Cm: (B, S, DS)   D: (NH,)
    h0: optional incoming state (B, NH, HD, DS)
    Returns (y (B,S,NH,HD), h_final (B,NH,HD,DS)); fp32 internally.
    """
    Bsz, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    L = chunk_len(S, chunk)
    nc = S // L

    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    xc = x.reshape(Bsz, nc, L, NH, HD)
    dtc = dt.reshape(Bsz, nc, L, NH)
    Bc = Bm.reshape(Bsz, nc, L, DS)
    Cc = Cm.reshape(Bsz, nc, L, DS)

    la = dtc * A[None, None, None]                     # log a: (B,nc,L,NH) <0
    cum = torch.cumsum(la, dim=2)                      # inclusive cumsum
    total = cum[:, :, -1]                              # (B,nc,NH)

    h = (x.new_zeros((Bsz, NH, HD, DS)) if h0 is None else h0.float())
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()

    ys = []
    for c in range(nc):
        xk, dtk, bk, ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cumk, totk = cum[:, c], total[:, c]
        # intra-chunk: mask the exponent pre-exp (s>t would overflow exp)
        cb = torch.einsum("btd,bsd->bts", ck, bk)      # (B,L,L)
        delta = cumk[:, :, None] - cumk[:, None]       # (B,t,s,NH)
        delta = torch.where(causal[None, :, :, None], delta, -torch.inf)
        g = cb[..., None] * torch.exp(delta)
        gx = g * dtk[:, None]                          # weight by dt_s
        y = torch.einsum("btsh,bshd->bthd", gx, xk)    # (B,L,NH,HD)
        # inter-chunk (incoming state):
        y = y + torch.einsum("bth,btd,bhed->bthe",
                             torch.exp(cumk), ck, h)   # note: e indexes HD
        # chunk state update:
        w = torch.exp(totk[:, None] - cumk) * dtk      # (B,L,NH)
        hc = torch.einsum("bth,bthd,bte->bhde", w, xk, bk)   # (B,NH,HD,DS)
        h = torch.exp(totk)[:, :, None, None] * h + hc
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, NH, HD)
    y = y + x * D[None, None, :, None]
    return y, h


def ssd_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD step.

    x (B,NH,HD), dt (B,NH), Bm/Cm (B,DS), h (B,NH,HD,DS) -> (y, h')
    """
    x, dt = x.float(), dt.float()
    a = torch.exp(dt * A[None])                            # (B,NH)
    dbx = torch.einsum("bh,bhd,be->bhde", dt, x, Bm.float())
    h = a[..., None, None] * h + dbx
    y = torch.einsum("bhde,be->bhd", h, Cm.float())
    y = y + x * D[None, :, None]
    return y, h


def mamba2_block(params, x: torch.Tensor, cfg, *,
                 state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 want_state: bool = False):
    """Mamba2 mixer. x: (B, S, E).

    state = (conv_state (B,K-1,CD), ssm_state (B,NH,HD,DS)) for decode (S==1)
    or chunked prefill continuation. Returns (y, new_state | None).
    """
    s = cfg.ssm
    B, S, E = x.shape
    d_in = s.expand * cfg.d_model
    nh = s.num_heads(cfg.d_model)
    hd = s.head_dim
    ds = s.d_state
    k = s.conv_kernel
    dt_ = x.dtype

    z = x @ params["wz"].to(dt_)                           # (B,S,d_in)
    xin = x @ params["wx"].to(dt_)
    Bp = x @ params["wB"].to(dt_)                          # (B,S,DS)
    Cp = x @ params["wC"].to(dt_)
    dt = x @ params["wdt"].to(dt_)                         # (B,S,NH)

    xBC = torch.cat([xin, Bp, Cp], dim=-1)                 # (B,S,CD)
    conv_w = torch.cat(
        [params["conv_x"], params["conv_B"], params["conv_C"]],
        dim=-1).to(dt_)                                    # (K, CD)

    conv_state = state[0] if state is not None else None
    xBC_conv = F.silu(_causal_conv(xBC, conv_w, conv_state))
    new_conv_state = None
    if want_state or state is not None:
        hist = torch.cat(
            [conv_state if conv_state is not None
             else xBC.new_zeros((B, k - 1, xBC.shape[-1])), xBC], dim=1)
        new_conv_state = hist[:, -(k - 1):, :]

    xs = xBC_conv[..., :d_in]
    Bs = xBC_conv[..., d_in:d_in + ds]
    Cs = xBC_conv[..., d_in + ds:]

    A = -torch.exp(params["A_log"].float())                # (NH,)
    dt = F.softplus(dt.float() + params["dt_bias"].float())

    xh = xs.reshape(B, S, nh, hd)
    ssm_state = state[1] if state is not None else None
    Dp = params["D"].float()

    if S == 1 and ssm_state is not None:                   # decode fast path
        y, h = ssd_decode(xh[:, 0], dt[:, 0], A, Bs[:, 0], Cs[:, 0], Dp,
                          ssm_state)
        y = y[:, None]                                     # (B,1,NH,HD)
    elif cfg.use_pallas and ssm_state is None:
        from repro_torch.kernels import ops as kops
        y, h = kops.mamba2_scan(xh, dt, A, Bs, Cs, Dp, chunk=s.chunk_size)
    else:
        y, h = ssd_chunked(xh, dt, A, Bs, Cs, Dp, chunk=s.chunk_size,
                           h0=ssm_state)

    y = y.reshape(B, S, d_in).to(dt_)
    # gated RMSNorm (mamba2: norm(y * silu(z)))
    y = y * F.silu(z)
    yf = y.float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.rms_eps)
         * params["norm"].float()).to(dt_)
    out = y @ params["out_proj"].to(dt_)

    new_state = None
    if want_state or state is not None:
        new_state = (new_conv_state, h.float())
    return out, new_state
