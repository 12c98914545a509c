"""Common layers (the port's ``repro.models.layers``). So far only the
RMSNorm that the ssm family needs; attention, RoPE and SwiGLU come with
the dense family."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)
