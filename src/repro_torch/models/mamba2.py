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

Inside a sharded serving step (``sharding.model_axis()``) the SSD runs on
this rank's heads, ``split(NH)`` (an even split where the axis divides
NH, else ceil(NH / size) a rank and none on the last ranks), each
product on the rank's part of a weight's storage, whatever it is: its
split of channels, its embed dim (the serving fallback, every column:
partial products summed), or whole (sliced, no collective). B and C are
whole on every rank. The causal conv runs on conv_x's channels (the
rank's even split of them, or its heads' where conv_x is whole) and the
gate, gated RMSNorm and ``out_proj`` on out_proj's rows; where those
channels are not the heads', the activations are gathered over the axis
and sliced (every rank then gates and normalizes all the channels); else
the RMSNorm's sum of squares is summed over the axis. Each step's
collectives are fused: one all-reduce of the products split on their
embed dim, one gather after the conv and one after the scan.
``conv_state`` is stored with its channels (x, B, C) split evenly over
the axis or whole, and ``ssm_state`` split by heads or whole; each is
re-laid between its stored layout and the compute's on the way in and
out.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import LOCAL, LocalAxis, model_axis
from repro_torch.kernels.mamba2_scan import chunk_len
from repro_torch.models.common import P
from repro_torch.models.layers import (column_ranges, out_product,
                                       own_rows)


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


def _conv_in(state: torch.Tensor, d_in: int, lo: int, hi: int,
             ax: LocalAxis) -> torch.Tensor:
    """The stored conv state (B, K-1, CD, or CD / size when split) in the
    compute's layout: the conv's x channels ``lo .. hi``, then all of B
    and C."""
    full = ax.gather(state, -1) if ax.conv else state
    return torch.cat([full[..., lo:hi], full[..., d_in:]], dim=-1)


def _all_channels(ts, even: bool, hd: int, nh: int, ax: LocalAxis):
    """Every rank's x channels of each of ``ts`` (its last dim this
    rank's: an equal share, or its heads', ``hd`` channels each of
    ``split(nh)``), in one gather over the axis."""
    if even:
        return ax.gather_all(ts, [-1] * len(ts))
    heads = [t.unflatten(-1, (t.shape[-1] // hd, hd)) for t in ts]
    return [t.flatten(-2) for t in ax.gather_all(heads, [-2] * len(ts), nh)]


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
    hd = s.head_dim
    k = s.conv_kernel
    NH = s.num_heads(cfg.d_model)
    dt_ = x.dtype
    ax = model_axis() or LOCAL
    hlo, hhi = ax.split(NH)                    # this rank's SSD heads
    nh, c = hhi - hlo, (hlo * hd, hhi * hd)    # ... and their channels
    # the conv's x channels: conv_x's even split, or the heads' if whole
    m = params["conv_x"].shape[1]
    a0, a1 = c if m == d_in else (ax.index * m, (ax.index + 1) * m)
    # the gate's, the norm's and out_proj's channels: out_proj's rows
    wout = params["out_proj"]
    if wout.shape[1] != E:                     # split on its output
        o0, o1 = 0, d_in
    elif wout.shape[0] == d_in:                # whole: the heads' rows
        (o0, o1), wout = c, wout[c[0]:c[1]]
    else:
        o0, o1 = ax.index * wout.shape[0], (ax.index + 1) * wout.shape[0]

    # the products; those of weights split on their embed dim summed in
    # one all-reduce
    z, xin, Bp, Cp, dt = column_ranges(x, [
        (params["wz"], d_in, o0, o1), (params["wx"], d_in, a0, a1),
        (params["wB"], s.d_state, 0, s.d_state),
        (params["wC"], s.d_state, 0, s.d_state),
        (params["wdt"], NH, hlo, hhi)], ax)

    xBC = torch.cat([xin, Bp, Cp], dim=-1)                 # (B,S,CD')
    conv_w = torch.cat(
        [own_rows(params["conv_x"], d_in, a0, a1, 1), params["conv_B"],
         params["conv_C"]], dim=-1).to(dt_)                # (K, CD')

    conv_state = state[0] if state is not None else None
    if conv_state is not None and ax.size > 1:
        conv_state = _conv_in(conv_state, d_in, a0, a1, ax)
    xBC_conv = F.silu(_causal_conv(xBC, conv_w, conv_state))
    n_x = a1 - a0
    xs = xBC_conv[..., :n_x]
    Bs = xBC_conv[..., n_x:n_x + s.d_state]
    Cs = xBC_conv[..., n_x + s.d_state:]
    new_conv_state = None
    if want_state or state is not None:
        hist = torch.cat(
            [conv_state if conv_state is not None
             else xBC.new_zeros((B, k - 1, xBC.shape[-1])), xBC], dim=1)
        new_conv_state = hist[:, -(k - 1):, :]
    # every rank's x channels, in one gather: the new conv state's (its
    # stored layout); where the conv's channels are not the heads', the
    # conv's output (to the heads' channels); and where y will be
    # gathered whole (the gate's channels are not the heads') and z is
    # split evenly, z, so that every rank gates and normalizes all the
    # channels, as one process does, with no sum for the norm
    even, relay_x, relay_y = m != d_in, (a0, a1) != c, (o0, o1) != c
    gate_all = even and relay_y
    if ax.size > 1 and (relay_x or gate_all or new_conv_state is not None):
        parts = ([new_conv_state[..., :n_x]] if new_conv_state is not None
                 else []) + ([xs] if relay_x else []) + ([z] if gate_all
                                                        else [])
        full = _all_channels(parts, even, hd, NH, ax)
        if gate_all:
            z = full.pop()
        if relay_x:
            xs = full.pop()[..., c[0]:c[1]]
        if new_conv_state is not None:
            cs = torch.cat([full[0], new_conv_state[..., n_x:]], dim=-1)
            new_conv_state = (ax.mine(cs, -1, cs.shape[-1] // ax.size)
                              if ax.conv else cs)

    A = -torch.exp(own_rows(params["A_log"], NH, hlo, hhi).float())
    dt = F.softplus(dt.float() + own_rows(params["dt_bias"], NH, hlo,
                                          hhi).float())

    xh = xs.reshape(B, S, nh, hd)
    ssm_state = state[1] if state is not None else None
    if ssm_state is not None:
        ssm_state = own_rows(ssm_state, NH, hlo, hhi, 1)
    Dp = own_rows(params["D"], NH, hlo, hhi).float()

    if not nh:                 # no heads here: nothing to scan
        y = xh.float()
        h = xh.new_zeros((B, 0, hd, s.d_state), dtype=torch.float32)
    elif S == 1 and ssm_state is not None:                 # decode fast path
        y, h = ssd_decode(xh[:, 0], dt[:, 0], A, Bs[:, 0], Cs[:, 0], Dp,
                          ssm_state)
        y = y[:, None]                                     # (B,1,NH,HD)
    elif cfg.use_pallas and ssm_state is None:
        from repro_torch.kernels import ops as kops
        y, h = kops.mamba2_scan(xh, dt, A, Bs, Cs, Dp, chunk=s.chunk_size)
    else:
        y, h = ssd_chunked(xh, dt, A, Bs, Cs, Dp, chunk=s.chunk_size,
                           h0=ssm_state)

    y = y.to(dt_)
    # every rank's heads, in one gather: the new ssm state's where it is
    # stored whole, and y's where the gate's channels are not the heads'
    whole_h = (ax.size > 1 and NH % ax.size != 0
               and (want_state or state is not None))
    parts = [(t, d) for t, d, on in ((y, 2, relay_y), (h, 1, whole_h))
             if on]
    full = ax.gather_all([t for t, _ in parts], [d for _, d in parts], NH)
    if whole_h:
        h = full.pop()
    if relay_y:
        y = full.pop().flatten(-2)
        y = y if gate_all else y[..., o0:o1]
    else:
        y = y.flatten(-2)
    # gated RMSNorm (mamba2: norm(y * silu(z))), its mean over all d_in
    y = y * F.silu(z)
    yf = y.float()
    if y.shape[-1] == d_in:    # every channel here
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
        yf = yf[..., o0:o1]
    elif even:                 # equal shares: the mean of means
        var = ax.sum(torch.mean(torch.square(yf), dim=-1,
                                keepdim=True)) / ax.size
    else:
        var = ax.sum(torch.square(yf).sum(dim=-1, keepdim=True)) / d_in
    y = (yf * torch.rsqrt(var + cfg.rms_eps)
         * own_rows(params["norm"], d_in, o0, o1).float()).to(dt_)
    out = out_product(y, wout, E, ax)

    new_state = None
    if want_state or state is not None:
        new_state = (new_conv_state, h.float())
    return out, new_state
