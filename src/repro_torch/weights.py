"""Carry a model's weights across from the JAX package.

``params_from_jax`` takes the JAX model's parameter tree after
``jax.tree.map(np.asarray, params)`` — nested dicts of numpy arrays — and
returns the same tree of tensors: same keys, same layout (for example
``layers/p0/ffn/wg`` keeps its stacked ``(n_periods, E, F)`` shape).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch


def params_from_jax(tree: Any, device: Union[str, torch.device],
                    dtype: Optional[torch.dtype] = None) -> Any:
    """numpy tree -> tensor tree on ``device`` (cast to ``dtype`` if given,
    else in the leaf's own type: a bfloat16 leaf stays bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    own = None
    if str(arr.dtype) == "bfloat16":
        # numpy has no native bfloat16: go through f32, which holds every
        # bfloat16 value exactly
        arr, own = arr.astype(np.float32), torch.bfloat16
    t = torch.from_numpy(np.array(arr))    # a writable copy
    return t.to(device=device, dtype=dtype or own or t.dtype)


def mlp_weights(params: Dict[str, Any], layer: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer ``layer``'s SwiGLU weights ``(wg, wi, wo)``. Layers are stacked
    per position in the period: ``layers/p{layer % period}`` holds layers
    ``p, p + period, ...`` along its leading axis."""
    period = len(params["layers"])
    ffn = params["layers"][f"p{layer % period}"]["ffn"]
    i = layer // period
    return ffn["wg"][i], ffn["wi"][i], ffn["wo"][i]
