"""Logical-axis sharding: MaxText-style rules mapping model axes to mesh
axes (the port of ``repro.distributed.sharding``).

Physical meshes (see launch/mesh.py):
    single-pod : (16, 16)     -> ("data", "model")
    multi-pod  : (2, 16, 16)  -> ("pod", "data", "model")

The rules and ``logical_to_spec`` are the reference's, so a step's specs
and shard shapes equal the reference's leaf for leaf. A ``PartitionSpec``
is a tuple with one entry per tensor dim: ``None`` (replicated), a mesh
axis name, or a tuple of names (sharded over all of them, major first). A
``NamedSharding`` turns one into a shard shape and into ``DTensor``
placements. ``constrain`` is the identity without a mesh or on one
device, and raises on a larger one: no intermediate is sharded yet.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_map

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),        # DP across pods and the data axis
    "embed": None,                   # activations/embeddings replicated dims
    "heads": "model",                # TP over attention heads
    "kv_heads": "model",
    "mlp": "model",                  # TP over FFN hidden
    "vocab": "model",                # TP over vocab (output proj / embedding)
    "expert": "model",               # EP: experts over the model axis
    "expert_mlp": None,              # per-expert hidden (model used by expert)
    "kv_seq": "model",               # SP: long-context KV cache sequence dim
    # Sequence parallelism (Megatron-SP / MaxText style): activations at
    # layer boundaries are sharded over the model axis on the seq dim.
    # REPRO_OPT_SP=0 gives the reference's pre-optimization baseline.
    "seq": ("model" if os.environ.get("REPRO_OPT_SP", "1") == "1"
            else None),
    "layer": None,                   # stacked layer dim never sharded
    "opt_state": ("pod", "data"),    # ZeRO-1: optimizer moments over DP
    "ssm_heads": "model",
    "conv_dim": "model",
    "frames": None,
}

# Parameter/optimizer-state rules: FSDP on top of TP — the `embed` dim of
# every weight is sharded over the data axes (ZeRO-3-style). Activations
# keep DEFAULT_RULES (embed unsharded).
PARAM_RULES: Dict[str, Any] = {
    **DEFAULT_RULES,
    "embed": ("pod", "data"),
}

# Serving parameter rules: no FSDP at decode (it would gather every weight
# for every token); weights TP-sharded and, for MoE, expert-sharded across
# the data axes too.
INFER_PARAM_RULES: Dict[str, Any] = {
    **DEFAULT_RULES,
    "expert": ("pod", "data"),
    "expert_mlp": "model",
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _group(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's shard, as JAX's ``shard_shape``: each
        sharded dim divided by the product of its mesh axes' sizes."""
        sizes = self.mesh.sizes
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _group(entry))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does not "
                                 f"divide over {entry} ({n} devices)")
            out[i] //= n
        return tuple(out)

    def placements(self):
        """DTensor placements, one per mesh dim: ``Shard(i)`` where the
        spec puts tensor dim ``i`` on that mesh axis, else ``Replicate()``.
        A dim over several mesh axes is split over them major first, as
        DTensor splits one dim sharded on several mesh dims."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.axis_names
        out = [Replicate() for _ in names]
        for i, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _group(entry)]
            if idx != sorted(idx):
                raise ValueError(f"{entry}: mesh axes out of the mesh's "
                                 f"order {names}")
            for j in idx:
                out[j] = Shard(i)
        return out


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, Any] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[Dict[str, Any]] = None):
    """Activate a mesh + rules for ``constrain`` and ``logical_to_spec``."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = {**DEFAULT_RULES, **rules}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def logical_to_spec(axes: Sequence[Optional[str]],
                    mesh: Optional[Mesh] = None,
                    rules: Optional[Dict[str, Any]] = None,
                    shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec for `mesh`.

    Drops mesh axes absent from the mesh (e.g. "pod" on single-pod) and —
    when `shape` is provided — drops placements that do not divide the dim
    evenly, trailing axes first. A mesh axis is used at most once.
    """
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules
    names = mesh.axis_names if mesh is not None else ("pod", "data", "model")
    sizes = mesh.sizes if mesh is not None else {}
    out = []
    used: set = set()
    for i, ax in enumerate(axes):
        tgt = rules.get(ax) if ax is not None else None
        if tgt is None:
            out.append(None)
            continue
        cand = tuple(t for t in _group(tgt) if t in names and t not in used)
        if shape is not None and cand and sizes:
            while cand and shape[i] % math.prod(sizes[c] for c in cand):
                cand = cand[:-1]       # drop trailing axes until divisible
        if not cand:
            out.append(None)
        elif len(cand) == 1:
            out.append(cand[0])
            used.add(cand[0])
        else:
            out.append(cand)
            used.update(cand)
    return PartitionSpec(*out)


def constrain(x, *axes: Optional[str]):
    """Sharding-constrain an intermediate by logical axes.

    With no mesh, or a mesh of one device, ``x`` comes back as it is, as
    the reference's does. A larger mesh raises: nothing in the port shards
    an intermediate yet, and a tensor that holds the whole value on one
    device is never passed through as if it were sharded.
    """
    mesh = _CTX.mesh
    if mesh is None or mesh.size == 1:
        return x
    raise NotImplementedError(
        f"constrain{axes} on a mesh of {mesh.size} devices: sharding an "
        "intermediate across devices is not ported")


def is_axes_leaf(t) -> bool:
    """A logical-axes leaf: tuple of axis names / None. NamedTuples of
    tuples (optimizer states) are NOT leaves — recurse into them."""
    return (isinstance(t, tuple)
            and all(x is None or isinstance(x, str) for x in t))


def tree_shardings(axes_tree, mesh: Mesh,
                   rules: Optional[Dict[str, Any]] = None,
                   shapes_tree=None):
    """Map an axes tree (+ optional tree of shapes or tensors) to
    NamedShardings."""
    def one(axes, shp=None):
        shape = getattr(shp, "shape", shp)
        return NamedSharding(mesh, logical_to_spec(axes, mesh, rules, shape))
    if shapes_tree is None:
        return tree_map(one, axes_tree, is_leaf=is_axes_leaf)
    return tree_map(one, axes_tree, shapes_tree, is_leaf=is_axes_leaf)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(("batch", None), mesh))
