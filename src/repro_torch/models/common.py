"""Param-spec DSL: declarative parameter trees (the port's copy of
``repro.models.common``).

Models declare a nested dict of ``P`` specs; ``init_from_specs`` draws the
tensors from an explicit ``torch.Generator``. The draws cannot match
``jax.random``'s, so the parity tests carry JAX-initialised parameters
across through numpy (``weights.params_from_jax``) instead. The logical
axes feed ``distributed.sharding`` (``axes_from_specs``); the shapes, as
meta tensors, a step's abstract inputs (``shapes_from_specs``).
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


def shapes_from_specs(specs, param_dtype=torch.float32):
    """The spec tree as meta tensors (shape and dtype, no storage)."""
    return tree_map_specs(
        lambda p: torch.empty(p.shape, dtype=p.dtype or param_dtype,
                              device="meta"), specs)


def axes_from_specs(specs):
    return tree_map_specs(lambda p: p.axes, specs)


# f32 elements drawn at a time for a leaf narrower than f32 (1 GiB)
DRAW_ELEMENTS = 1 << 28


def _draw(p: P, gen: torch.Generator, shape, device) -> torch.Tensor:
    """``shape`` (the leaf's, or a slice of it) drawn in f32 by ``p.init``
    at the leaf's scale."""
    if p.init == "small_log":   # mamba A_log-style init in (log 1 .. log 16)
        u = torch.empty(shape, device=device).uniform_(1.0, 16.0,
                                                       generator=gen)
        return torch.log_(u)
    if p.init == "fan_last":    # std = scale / sqrt(last dim)  (embeddings)
        std = p.scale / math.sqrt(p.shape[-1])
    else:
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(fan_in, 1))
    # scaled in place: at full width one leaf is tens of GB
    return torch.empty(shape, device=device).normal_(generator=gen).mul_(std)


def _init_one(p: P, gen: torch.Generator, param_dtype,
              device: torch.device, part=None) -> torch.Tensor:
    """The leaf of ``p`` drawn from ``gen``; with ``part`` (a tuple of
    slices, one per dim) only that part of it is kept: the generator
    makes the same draws as for the whole leaf, and the rest of each draw
    is freed as it is made."""
    dtype = p.dtype or param_dtype
    shape = (p.shape if part is None
             else tuple(sl.stop - sl.start for sl in part))
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if torch.finfo(dtype).bits >= 32 or not p.shape:
        out = _draw(p, gen, p.shape, device).to(dtype)
        return out if part is None else out[part].clone()
    # narrower than f32: drawn in slices of the leading (layer) axis into
    # the leaf, allocated once in its dtype, so that the f32 draw never
    # holds more than DRAW_ELEMENTS (a whole stacked leaf in f32 would be
    # twice the bf16 leaf: 34 GB for deepseek-coder-33b's MLP)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_ELEMENTS // max(1, math.prod(p.shape[1:])))
    first = part[0] if part is not None else slice(0, p.shape[0])
    for i in range(0, p.shape[0], rows):
        n = min(rows, p.shape[0] - i)
        drawn = _draw(p, gen, (n,) + tuple(p.shape[1:]), device)
        lo, hi = max(i, first.start), min(i + n, first.stop)
        if lo < hi:
            rest = () if part is None else tuple(part[1:])
            out[lo - first.start:hi - first.start].copy_(
                drawn[(slice(lo - i, hi - i),) + rest])
        del drawn
    return out


def init_from_specs(specs, gen: torch.Generator,
                    param_dtype=torch.float32, parts=None):
    """Materialise a spec tree on ``gen``'s device, drawing the leaves in
    sorted key order (as ``jax.tree.flatten`` orders a dict). A leaf in f32
    (or wider) is drawn whole; a narrower one slice by slice
    (``_init_one``), so its values differ from the f32 draw's. ``parts``,
    a tree of slice tuples beside ``specs``, keeps only those parts of
    the leaves (a rank's shards), equal to the same parts of the whole
    draw."""
    if isinstance(specs, P):
        return _init_one(specs, gen, param_dtype, gen.device, parts)
    return {k: init_from_specs(specs[k], gen, param_dtype,
                               None if parts is None else parts[k])
            for k in sorted(specs)}


def param_count_tree(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count_tree(v) for v in params.values())
