"""Gradient compression with error feedback, int8 block-quantized (the
port of ``repro.distributed.compression``).

At 1000+-node scale the data-parallel all-reduce of the gradients
dominates a step at small per-device batch. Block-wise int8 quantization
with error feedback (the residual carried to the next step) cuts the
collective payload 4x against f32 while keeping convergence: the residual
makes the quantizer unbiased over time.

In a train step:
    c, new_resid = ef_compress_tree(grads, resid)
    (all-reduce c.q summed in int32 and c.scale, then decompress)

Quantization is per block (the flattened tensor tiled by ``block``), so
scales stay local and an outlier does not poison a whole tensor. Plain
torch ops: ``torch.round`` rounds half to even, as ``jnp.round`` does, so
``q`` and ``scale`` equal the reference's bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from repro_torch.tree import (flatten_up_to, tree_flatten, tree_leaves,
                              tree_map, tree_unflatten)


@dataclass(frozen=True)
class CompressionConfig:
    block: int = 256
    enabled: bool = True


class Compressed(NamedTuple):
    q: torch.Tensor          # int8, (blocks, block), padded to a block multiple
    scale: torch.Tensor      # f32, one per block
    shape: Tuple[int, ...]


def _pad_to_block(flat: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def compress(x: torch.Tensor, block: int = 256) -> Compressed:
    """Symmetric per-block int8 quantization."""
    flat = _pad_to_block(x.float().reshape(-1), block)
    blocks = flat.reshape(-1, block)
    # 127 as a tensor on x's device, filled there (no host copy, so no
    # wait for the card): CUDA divides by a host scalar as a product with
    # its reciprocal, an ulp off the quotient that the CPU and the
    # reference give
    scale = (blocks.abs().amax(dim=1, keepdim=True)
             / blocks.new_full((), 127.0))
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale[:, 0], shape=tuple(x.shape))


def decompress(c: Compressed) -> torch.Tensor:
    flat = (c.q.float() * c.scale[:, None]).reshape(-1)
    return flat[:math.prod(c.shape)].reshape(c.shape)


def quantization_error(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    return x.float() - decompress(compress(x, block))


def _is_compressed(t) -> bool:
    return isinstance(t, Compressed)


def ef_compress_tree(grads, residuals, block: int = 256):
    """Error-feedback step: returns (compressed tree, new residual tree).

    ``decompress_tree`` of the result plus the new residuals equals grads +
    residuals (to f32 rounding); the residual is what the quantizer dropped.
    """
    def one(g, r):
        corrected = g.float() + r
        c = compress(corrected, block)
        return c, corrected - decompress(c)

    leaves_g, treedef = tree_flatten(grads)
    leaves_r = flatten_up_to(treedef, residuals)
    outs = [one(g, r) for g, r in zip(leaves_g, leaves_r)]
    return (tree_unflatten(treedef, [o[0] for o in outs]),
            tree_unflatten(treedef, [o[1] for o in outs]))


def decompress_tree(ctree):
    return tree_map(decompress, ctree, is_leaf=_is_compressed)


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def payload_bytes(tree) -> int:
    """Collective payload of a (possibly compressed) gradient tree: the
    bytes of its tensors (a ``Compressed`` leaf's ``q`` and ``scale``; its
    ``shape`` is metadata and moves nothing)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))
