"""Param-spec DSL: declarative parameter trees (the port's copy of
``repro.models.common``).

Models declare a nested dict of ``P`` specs; ``init_from_specs`` draws the
tensors from an explicit ``torch.Generator``. The draws cannot match
``jax.random``'s, so the parity tests carry JAX-initialised parameters
across through numpy (``weights.params_from_jax``) instead. The logical
sharding axes are kept for parity with the reference's specs; the port
runs on one card and reads none of them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

Axes = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class P:
    """One parameter: shape + logical axes (len == ndim) + initializer."""

    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"       # normal | zeros | ones | small_log | fan_last
    scale: float = 1.0
    dtype: Any = None          # None -> model param_dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_specs(fn: Callable[[P], Any], specs):
    """``fn`` on every ``P`` of a nested dict, keeping the structure."""
    if isinstance(specs, P):
        return fn(specs)
    return {k: tree_map_specs(fn, v) for k, v in specs.items()}


def stacked(n: int, specs):
    """Prepend a 'layer' dimension to every spec in the subtree."""
    return tree_map_specs(
        lambda p: dataclasses.replace(p, shape=(n,) + p.shape,
                                      axes=("layer",) + p.axes),
        specs)


def _init_one(p: P, gen: torch.Generator, param_dtype,
              device: torch.device) -> torch.Tensor:
    dtype = p.dtype or param_dtype
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "small_log":   # mamba A_log-style init in (log 1 .. log 16)
        u = torch.empty(p.shape, device=device).uniform_(1.0, 16.0,
                                                         generator=gen)
        return torch.log(u).to(dtype)
    if p.init == "fan_last":    # std = scale / sqrt(last dim)  (embeddings)
        std = p.scale / math.sqrt(p.shape[-1])
    else:
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(fan_in, 1))
    # scaled in place: at full width one leaf is tens of GB
    x = torch.empty(p.shape, device=device).normal_(generator=gen)
    return x.mul_(std).to(dtype)


def init_from_specs(specs, gen: torch.Generator,
                    param_dtype=torch.float32):
    """Materialise a spec tree on ``gen``'s device, drawing the leaves in
    sorted key order (as ``jax.tree.flatten`` orders a dict)."""
    if isinstance(specs, P):
        return _init_one(specs, gen, param_dtype, gen.device)
    return {k: init_from_specs(specs[k], gen, param_dtype)
            for k in sorted(specs)}


def param_count_tree(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count_tree(v) for v in params.values())
