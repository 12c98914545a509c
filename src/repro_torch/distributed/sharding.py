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
placements.

On a mesh of more than one process (one per device), ``ShardGroup`` is a
rank's part: ``layout`` stores a tree as ``DTensor``s by its
``NamedSharding``s, each rank holding its shard; ``gather`` is its
inverse; ``mean_over`` averages over the batch's shards, and
``batch_mean`` hands that to the model; all by all-reduces on the
default group (gloo carries those for CUDA tensors too). The train
step runs so: storage sharded, compute on gathered tensors
(``launch.steps``). The serving steps compute on shards: inside one,
``model_axis()`` is this rank's ``ModelAxis`` (``use_model_axis``), and
the layers run tensor-parallel on their local weights with its sum, max
and all-gather over the model axis. ``constrain`` is the identity
without a mesh, on one device and inside a ``ModelAxis`` (whose layers
hold their shards already), and raises elsewhere on a larger mesh.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh, local_device
from repro_torch.tree import (flatten_up_to, tree_flatten, tree_map,
                              tree_unflatten)

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


def entry_axes(entry) -> Tuple[str, ...]:
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
            n = math.prod(sizes[a] for a in entry_axes(entry))
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
            idx = [names.index(a) for a in entry_axes(entry)]
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
        self.batch_mean: Optional[Callable] = None
        self.model_axis: Optional["ModelAxis"] = None


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
        cand = tuple(t for t in entry_axes(tgt)
                     if t in names and t not in used)
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
    the reference's does; inside a ``ModelAxis`` too, where ``x`` is this
    rank's part already. Elsewhere a larger mesh raises: a tensor that
    holds the whole value on one device is never passed through as if it
    were sharded.
    """
    mesh = _CTX.mesh
    if mesh is None or mesh.size == 1 or _CTX.model_axis is not None:
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


# ---------------------------------------------------------------------------
# Sharded storage on a mesh of processes
# ---------------------------------------------------------------------------


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a statistic of this rank's batch shard, averaged over the
    batch's shards inside a sharded step (``use_batch_mean``); ``x``
    itself outside one. Not differentiated: the MoE router's load (the
    share of tokens that picks each expert) is the one caller."""
    fn = _CTX.batch_mean
    return x if fn is None else fn(x)


@contextlib.contextmanager
def use_batch_mean(fn: Callable[[torch.Tensor], torch.Tensor]):
    prev = _CTX.batch_mean
    _CTX.batch_mean = fn
    try:
        yield
    finally:
        _CTX.batch_mean = prev


class ShardGroup:
    """This process's part of ``mesh``, a mesh of one process per device
    whose ranks 0 .. size - 1 lie in row-major order (``Mesh.device_mesh``):
    its coordinates, the slice of each sharding it holds, and the
    all-reduces that gather and reduce shards. ``comm_s`` adds up the
    host seconds spent in them."""

    def __init__(self, mesh: Mesh, device: Optional[torch.device] = None):
        dist = torch.distributed
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != mesh.size:
            raise ValueError(f"{mesh} needs a process group of {mesh.size} "
                             f"ranks, not {world}")
        self.mesh = mesh
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        idx = torch.arange(mesh.size).reshape(mesh.shape)
        where = (idx == self.rank).nonzero()[0].tolist()
        self.coords: Dict[str, int] = dict(zip(mesh.axis_names, where))
        self.device = device or local_device(mesh)
        self.comm_s = 0.0
        self._device_mesh = None

    @property
    def device_mesh(self):
        if self._device_mesh is None:
            self._device_mesh = self.mesh.device_mesh()
        return self._device_mesh

    def slices(self, sharding: NamedSharding,
               shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's shard of a tensor of ``shape``: a dim over several
        mesh axes split major first, as ``placements()`` splits it."""
        sizes = self.mesh.sizes
        out = []
        for i, n in enumerate(shape):
            start, length = 0, n
            for a in entry_axes(sharding.spec[i]
                                if i < len(sharding.spec) else None):
                length //= sizes[a]
                start += self.coords[a] * length
            out.append(slice(start, start + length))
        return tuple(out)

    def owns(self, sharding: NamedSharding) -> bool:
        """Whether this rank is the first holder of its shard (coordinate 0
        on every mesh axis the sharding replicates over)."""
        used = {a for e in sharding.spec for a in entry_axes(e)}
        return all(c == 0 for a, c in self.coords.items() if a not in used)

    def local(self, full: torch.Tensor,
              sharding: NamedSharding) -> torch.Tensor:
        """This rank's shard of ``full``, in storage of its own."""
        return full[self.slices(sharding, full.shape)].clone(
            memory_format=torch.contiguous_format)

    def _sum(self, shapes, dtypes, fill) -> List[torch.Tensor]:
        """Sum tensors of ``shapes`` and ``dtypes`` over all ranks, in one
        all-reduce per dtype (16-bit floats summed in f32): each starts as
        -0.0 (0 for integers), the identity of +, so a value that one rank
        alone writes comes back bit for bit, and ``fill(i, view)`` writes
        this rank's part of tensor ``i``."""
        out: List[Optional[torch.Tensor]] = [None] * len(shapes)
        by_wire: Dict[torch.dtype, List[int]] = {}
        for i, dt in enumerate(dtypes):
            wire = (torch.float32 if dt in (torch.bfloat16, torch.float16)
                    else dt)
            by_wire.setdefault(wire, []).append(i)
        for wire, idx in by_wire.items():
            n = [math.prod(shapes[i]) for i in idx]
            flat = torch.full((sum(n),), -0.0 if wire.is_floating_point
                              else 0, dtype=wire, device=self.device)
            for i, view in zip(idx, flat.split(n)):
                out[i] = view.view(shapes[i])
                fill(i, out[i])
            t0 = time.monotonic()
            torch.distributed.all_reduce(flat)
            self.comm_s += time.monotonic() - t0
            for i in idx:
                out[i] = out[i].to(dtypes[i])
        return out

    def mean_over(self, tensors: List[torch.Tensor],
                  axes: Sequence[str]) -> List[torch.Tensor]:
        """The mean over the ranks that differ only along ``axes`` (the
        batch's shards) of each tensor, equal on every rank: the ranks at
        coordinate 0 on the other axes contribute."""
        first = all(c == 0 for a, c in self.coords.items() if a not in axes)
        n = math.prod(self.mesh.sizes[a] for a in axes)

        def fill(i, view):
            if first:
                view.copy_(tensors[i])
        return [t / n for t in self._sum([tuple(t.shape) for t in tensors],
                                         [t.dtype for t in tensors], fill)]

    def wrap(self, shard: torch.Tensor, sharding: NamedSharding,
             shape: Sequence[int]):
        """This rank's ``shard`` of a tensor of ``shape`` as a ``DTensor``
        on the mesh; the shard must have ``sharding``'s shard shape."""
        from torch.distributed.tensor import DTensor
        if tuple(shard.shape) != sharding.shard_shape(shape):
            raise ValueError(f"a shard of {tuple(shard.shape)} is not "
                             f"{sharding.spec}'s of {tuple(shape)}")
        return DTensor.from_local(
            shard, self.device_mesh, sharding.placements(), run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    def layout(self, tree, shardings):
        """``tree`` (whole tensors, equal on every rank) as ``DTensor``s on
        the mesh, each rank storing its shard on its device."""
        return tree_map(lambda t, s: self.wrap(
            self.local(t.to(self.device), s), s, t.shape), tree, shardings)

    def gather(self, tree, shardings):
        """The whole value of each ``DTensor`` of ``tree``, on every rank,
        in one all-reduce: each shard lands at its slice, written by its
        first holder alone."""
        leaves, treedef = tree_flatten(tree)
        shs = flatten_up_to(treedef, shardings)
        places = [self.slices(s, t.shape) if self.owns(s) else None
                  for t, s in zip(leaves, shs)]

        def fill(i, view):
            if places[i] is not None:
                view[places[i]] = leaves[i].to_local()
        return tree_unflatten(treedef, self._sum(
            [tuple(t.shape) for t in leaves], [t.dtype for t in leaves],
            fill))


# ---------------------------------------------------------------------------
# Tensor-parallel compute inside a sharded serving step
# ---------------------------------------------------------------------------

_WIDE = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


class LocalAxis:
    """The model axis of one device: size 1, every collective the
    identity, the cache whole. The layers run one body on it and on a
    ``ModelAxis``."""
    size, index, kv, conv = 1, 0, None, False

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x

    def mine(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's ``n`` entries of ``x`` along ``dim``, of a split in
        the axis's order."""
        return x.narrow(dim, self.index * n, n)


LOCAL = LocalAxis()


class ModelAxis(LocalAxis):
    """This rank's part of the model axis inside a sharded serving step:
    its ``size`` and ``index`` on the axis, how the serving cache is laid
    out over it, and a sum, a max and an all-gather over the ranks that
    differ only along it (``group.device_mesh.get_group("model")``), whose
    host seconds add to ``group.comm_s``. 16-bit floats sum in f32 (a sum
    of partial products is rounded once); a gather carries a tensor in
    its own dtype. ``kv`` is the k/v cache's split over the axis:
    ``"seq"`` (positions), ``"heads"`` (kv heads) or None (whole on every
    rank); ``conv`` whether ``conv_state``'s channels are split."""

    def __init__(self, group: ShardGroup, kv: Optional[str] = None,
                 conv: bool = False):
        self.group = group
        self.size = group.mesh.sizes["model"]
        self.index = group.coords["model"]
        self.kv, self.conv = kv, conv
        self._pg = group.device_mesh.get_group("model")

    def _run(self, fn, x):
        t0 = time.monotonic()
        out = fn(x)
        self.group.comm_s += time.monotonic() - t0
        return out

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        def run(x):
            wire = x.to(_WIDE.get(x.dtype, x.dtype)).contiguous()
            if wire.data_ptr() == x.data_ptr():
                wire = wire.clone()
            torch.distributed.all_reduce(wire, op=op, group=self._pg)
            return wire.to(x.dtype)
        return self._run(run, x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model axis, in ``x``'s dtype."""
        return self._reduce(x, torch.distributed.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, torch.distributed.ReduceOp.MAX)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in their order on
        the axis."""
        def run(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            torch.distributed.all_gather(parts, x, group=self._pg)
            return torch.cat(parts, dim)
        return self._run(run, x)


def model_axis() -> Optional[ModelAxis]:
    """The ``ModelAxis`` of the sharded step running on this thread, or
    None: on one device the layers run on whole tensors (``LOCAL``)."""
    return _CTX.model_axis


@contextlib.contextmanager
def use_model_axis(axis: Optional[ModelAxis]):
    prev = _CTX.model_axis
    _CTX.model_axis = axis
    try:
        yield
    finally:
        _CTX.model_axis = prev
