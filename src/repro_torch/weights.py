"""Carry a model's weights and optimizer state across from the JAX package.

``params_from_jax`` takes the JAX model's parameter tree after
``jax.tree.map(np.asarray, params)`` — nested dicts of numpy arrays — and
returns the same tree of tensors: same keys, same layout (for example
``layers/p0/ffn/wg`` keeps its stacked ``(n_periods, E, F)`` shape), for
every family: the MoE experts (``ffn/wi`` as ``(n_periods, experts, E,
F)``), the hybrid periods (``layers/p0`` .. ``p7``, mamba2 and attention
positions) and the audio encoder (``encoder/layers``, ``layers/p0/xattn``),
leaf for leaf in ``jax.tree.flatten``'s order (``tree.py``).
``opt_state_from_jax`` does the same for a JAX ``OptState`` or ``AfState``,
whose NamedTuples become the port's of the same name.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.optim.adafactor import AfState, _Factored, _Full
from repro_torch.optim.adamw import OptState
from repro_torch.tree import TreeDef, tree_flatten, tree_unflatten

# the port's optimizer-state NamedTuples, by the reference's class names
STATE_TYPES = {t.__name__: t for t in (OptState, AfState, _Factored, _Full)}


def _leaf(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(x)
    own = None
    if str(arr.dtype) == "bfloat16":
        # numpy has no native bfloat16: go through f32, which holds every
        # bfloat16 value exactly
        arr, own = arr.astype(np.float32), torch.bfloat16
    t = torch.from_numpy(np.array(arr))    # a writable copy
    return t.to(device=device, dtype=dtype or own or t.dtype)


def params_from_jax(tree: Any, device: Union[str, torch.device],
                    dtype: Optional[torch.dtype] = None) -> Any:
    """numpy tree -> tensor tree on ``device`` (cast to ``dtype`` if given,
    else in the leaf's own type: a bfloat16 leaf stays bfloat16)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [_leaf(x, device, dtype) for x in leaves])


def _port_types(td: TreeDef) -> TreeDef:
    meta = td.meta
    if td.kind == "tuple" and meta is not tuple:
        meta = STATE_TYPES[meta.__name__]
    return TreeDef(td.kind, meta, [_port_types(c) for c in td.children])


def opt_state_from_jax(state: Any, device: Union[str, torch.device]) -> Any:
    """A JAX ``OptState`` / ``AfState`` (after ``jax.tree.map(np.asarray,
    state)``) as the port's: the same leaves in the same order, the step
    int32, the moments f32, on ``device``."""
    leaves, treedef = tree_flatten(state)
    return tree_unflatten(_port_types(treedef),
                          [_leaf(x, device, None) for x in leaves])


def mlp_weights(params: Dict[str, Any], layer: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer ``layer``'s SwiGLU weights ``(wg, wi, wo)``. Layers are stacked
    per position in the period: ``layers/p{layer % period}`` holds layers
    ``p, p + period, ...`` along its leading axis."""
    period = len(params["layers"])
    ffn = params["layers"][f"p{layer % period}"]["ffn"]
    i = layer // period
    return ffn["wg"][i], ffn["wi"][i], ffn["wo"][i]
