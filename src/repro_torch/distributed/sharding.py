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
and all-gather over the model axis; for a model with experts,
``expert_axis()`` is its ``ExpertAxis`` (``use_expert_axis``), over the
data axes that split the experts, whose all-to-all carries the MoE
blocks' expert inputs and outputs. ``constrain`` is the identity
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
        self.expert_axis: Optional["ExpertAxis"] = None


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
        # the expert axis's all-to-alls: their share of comm_s, and the
        # bytes this rank sent into them
        self.a2a_s = 0.0
        self.a2a_bytes = 0
        self._device_mesh = None
        self._groups: Dict[Tuple[str, ...], Any] = {}

    @property
    def device_mesh(self):
        if self._device_mesh is None:
            self._device_mesh = self.mesh.device_mesh()
        return self._device_mesh

    def process_group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes``, in row-major order over them: the device mesh's
        group of one axis, else one ``new_group`` for every coordinate of
        the other axes, made once (every rank makes all of them, in one
        order, as ``new_group`` asks)."""
        axes = tuple(axes)
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
            else:
                names = self.mesh.axis_names
                idx = torch.arange(self.mesh.size).reshape(self.mesh.shape)
                lead = [names.index(a) for a in axes]
                rest = [i for i in range(len(names)) if i not in lead]
                runs = idx.permute(rest + lead).reshape(
                    -1, math.prod(self.mesh.sizes[a] for a in axes))
                for run in runs.tolist():
                    pg = torch.distributed.new_group(run)
                    if self.rank in run:
                        self._groups[axes] = pg
        return self._groups[axes]

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
# a reduction of at most this many bytes runs as an all-gather and a sum
# (or max) in the axis's order on every rank: gloo's ring all-reduce takes
# 2 (n - 1) hops and its all-gather n - 1, and on a host crowded with
# ranks a hop costs milliseconds. ``chip_smoke.py --reduce-probe`` (f32 on
# an H100, 2, 3 and 16 ranks sharing the host's 8 cores) found the gather
# faster at 4 KB to 256 KB on every count (1.4-1.9x on 16 ranks), the
# all_reduce faster from 1 MB on 16 ranks and from 4 MB on 2 and 3
SMALL_REDUCE_BYTES = 256 << 10


def ceil_split(n: int, size: int, index: int) -> Tuple[int, int]:
    """Rank ``index``'s range ``(lo, hi)`` of ``n`` entries split over
    ``size`` ranks as GSPMD pads a dim that they do not divide:
    ``ceil(n / size)`` a rank in order, the last ranks fewer or none (an
    even split where ``size`` divides n)."""
    per = -(-n // size)
    lo = min(index * per, n)
    return lo, min(lo + per, n)


class LocalAxis:
    """The model axis of one device: size 1, every collective the
    identity, the cache whole. The layers run one body on it and on a
    ``ModelAxis``."""
    size, index, kv, conv = 1, 0, None, False

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (all of one shape), in the axis's order."""
        return [x]

    def split(self, n: int, index: Optional[int] = None) -> Tuple[int, int]:
        """Rank ``index``'s (this rank's by default) ``ceil_split`` of
        ``n`` entries over the axis."""
        return ceil_split(n, self.size, self.index if index is None
                          else index)

    def gather(self, x: torch.Tensor, dim: int,
               n: Optional[int] = None) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in their order on the
        axis: equal parts, or, given ``n``, the parts of ``split(n)``
        (each padded with zeros to the largest for the collective and
        trimmed after, so a rank with no part sends zeros and receives
        every part)."""
        if self.size == 1:
            return x
        dim = dim % x.ndim
        if n is None:
            return torch.cat(self._all_gather(x), dim)
        per = -(-n // self.size)
        pad = list(x.shape)
        pad[dim] = per - x.shape[dim]
        parts = self._all_gather(torch.cat([x, x.new_zeros(pad)], dim))
        return torch.cat([p.narrow(dim, 0, hi - lo) for p, (lo, hi) in zip(
            parts, (self.split(n, r) for r in range(self.size)))], dim)

    def gather_all(self, xs: Sequence[torch.Tensor], dims: Sequence[int],
                   n: Optional[int] = None) -> List[torch.Tensor]:
        """Each of ``xs`` gathered along its dim of ``dims`` (equal parts,
        or the parts of ``split(n)``) in one collective: each moved to
        lead and flattened beside it, carried in the widest of their
        dtypes (exact for narrower floats), and returned in a tensor of
        its own (not a view that keeps the others alive)."""
        if self.size == 1 or not xs:
            return list(xs)
        wide = xs[0].dtype
        for x in xs[1:]:
            wide = torch.promote_types(wide, x.dtype)
        lead = [x.movedim(d, 0) for x, d in zip(xs, dims)]
        cols = [math.prod(t.shape[1:]) for t in lead]
        full = self.gather(torch.cat(
            [t.reshape(t.shape[0], c).to(wide) for t, c in zip(lead, cols)],
            1), 0, n)
        return [f.reshape((f.shape[0],) + t.shape[1:]).movedim(0, d)
                .to(x.dtype, memory_format=torch.contiguous_format,
                    copy=True)
                for f, t, x, d in zip(full.split(cols, 1), lead, xs, dims)]

    def sum_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each of ``xs`` summed over the axis, in one all-reduce (``sum``:
        16-bit floats in f32)."""
        if self.size == 1 or not xs:
            return list(xs)
        wide = _WIDE.get(xs[0].dtype, xs[0].dtype)
        for x in xs[1:]:
            wide = torch.promote_types(wide, _WIDE.get(x.dtype, x.dtype))
        flat = self.sum(torch.cat([x.to(wide).flatten() for x in xs]))
        return [f.view(x.shape).to(x.dtype) for f, x in zip(
            flat.split([x.numel() for x in xs]), xs)]

    def mine(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's ``n`` entries of ``x`` along ``dim``, of a split in
        the axis's order."""
        return x.narrow(dim, self.index * n, n)


LOCAL = LocalAxis()


class ModelAxis(LocalAxis):
    """This rank's part of the model axis inside a sharded serving step:
    its ``size`` and ``index`` on the axis, how the serving cache is laid
    out over it, and a sum, a max and an all-gather over the ranks that
    differ only along it (``group.process_group(axes)``; ``axes`` is
    ("model",) but for ``ExpertAxis``), whose host seconds add to
    ``group.comm_s``. 16-bit floats sum in f32 (a sum of partial products
    is rounded once), a small one as a gather and a local sum
    (``SMALL_REDUCE_BYTES``); a gather carries a tensor in its own dtype.
    ``kv`` is the k/v cache's split over the axis: ``"seq"`` (positions),
    ``"heads"`` (kv heads) or None (whole on every rank); ``conv`` whether
    ``conv_state``'s channels are split."""

    def __init__(self, group: ShardGroup, kv: Optional[str] = None,
                 conv: bool = False, axes: Sequence[str] = ("model",)):
        self.group, self.axes = group, tuple(axes)
        sizes = group.mesh.sizes
        self.size = math.prod(sizes[a] for a in self.axes)
        self.index = 0                  # row-major over the axes
        for a in self.axes:
            self.index = self.index * sizes[a] + group.coords[a]
        self.kv, self.conv = kv, conv
        self._pg = group.process_group(self.axes) if self.size > 1 else None

    def _run(self, fn, x):
        t0 = time.monotonic()
        out = fn(x)
        self.group.comm_s += time.monotonic() - t0
        return out

    def _reduce(self, x: torch.Tensor, op, local) -> torch.Tensor:
        if self.size == 1:
            return x
        wide = _WIDE.get(x.dtype, x.dtype)
        if x.numel() * wide.itemsize <= SMALL_REDUCE_BYTES:
            parts = self._all_gather(x.to(wide))
            out = parts[0]
            for part in parts[1:]:      # in the axis's order, every rank
                out = local(out, part)
            return out.to(x.dtype)

        def run(x):
            wire = x.to(wide).contiguous()
            if wire.data_ptr() == x.data_ptr():
                wire = wire.clone()
            torch.distributed.all_reduce(wire, op=op, group=self._pg)
            return wire.to(x.dtype)
        return self._run(run, x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model axis, in ``x``'s dtype."""
        return self._reduce(x, torch.distributed.ReduceOp.SUM, torch.add)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, torch.distributed.ReduceOp.MAX,
                            torch.maximum)

    def _all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        def run(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            torch.distributed.all_gather(parts, x, group=self._pg)
            return parts
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


class ExpertAxis(ModelAxis):
    """This rank's part of the expert axis inside a sharded serving step:
    the ranks that differ from it only along ``axes``, the data axes that
    split the experts (``INFER_PARAM_RULES`` puts ``"expert"`` on
    ``("pod", "data")`` where they divide the experts; none where they
    do not, and then every rank holds them all). ``ModelAxis``'s
    collectives over those ranks (the gather of the router's weight), the
    all-to-all that moves the MoE block's expert inputs to their experts'
    ranks and back, and ``rows`` = (start, total): where this rank's rows
    lie in the step's batch, so that the router sees them as one process
    lays them out. The all-to-alls' host seconds also add to
    ``group.a2a_s``, and the bytes sent into them to
    ``group.a2a_bytes``."""

    def __init__(self, group: ShardGroup, axes: Sequence[str],
                 rows: Tuple[int, int]):
        super().__init__(group, axes=axes)
        self.rows = rows

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` split along dim 0 into ``size`` equal parts, part ``j``
        sent to the axis's rank ``j``; returns the parts received, rank
        ``j``'s at ``j``, in ``x``'s dtype."""
        def run(x):
            out = torch.empty_like(x)
            torch.distributed.all_to_all_single(out, x, group=self._pg)
            return out
        comm = self.group.comm_s
        out = self._run(run, x.contiguous())
        self.group.a2a_s += self.group.comm_s - comm
        self.group.a2a_bytes += x.numel() * x.element_size()
        return out


def expert_axes(mesh: Mesh, num_experts: int) -> Tuple[str, ...]:
    """The mesh axes that split ``num_experts`` experts in the serving
    steps (``INFER_PARAM_RULES``' ``"expert"``, trailing axes dropped
    until they divide)."""
    return entry_axes(logical_to_spec(("expert",), mesh, INFER_PARAM_RULES,
                                      (num_experts,))[0])


def expert_axis() -> Optional[ExpertAxis]:
    """The ``ExpertAxis`` of the sharded step running on this thread, or
    None (one device, or a model without experts)."""
    return _CTX.expert_axis


@contextlib.contextmanager
def use_expert_axis(axis: Optional[ExpertAxis]):
    prev = _CTX.expert_axis
    _CTX.expert_axis = axis
    try:
        yield
    finally:
        _CTX.expert_axis = prev
