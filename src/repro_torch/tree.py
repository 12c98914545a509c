"""Trees of tensors in ``jax.tree.flatten``'s leaf order.

A tree is nested dicts, lists, tuples and ``NamedTuple``s with leaves
(tensors, numpy arrays, numbers) at the bottom. The leaf order is the JAX
package's: dict keys sorted, list and tuple (and ``NamedTuple``) items in
order, ``None`` an empty subtree. So the parameter and optimizer-state
trees of the two packages flatten to the same list, and a checkpoint
written by one restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple


class TreeDef:
    """The structure of a tree: the node kind, its keys (a dict) or its
    type (a ``NamedTuple``) and its children; a leaf has none."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta: Any = None, children=()):
        self.kind = kind            # leaf | none | dict | list | tuple
        self.meta = meta            # dict: sorted keys; tuple: its type
        self.children = tuple(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(map(repr, self.children))
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c!r}" for k, c in zip(
                self.meta, self.children)) + "}"
        if self.kind == "list":
            return f"[{inner}]"
        if self.meta is tuple:
            return f"({inner})"
        return f"{self.meta.__name__}({inner})"


def _def(tree, leaves: List[Any], is_leaf) -> TreeDef:
    if is_leaf is not None and is_leaf(tree):
        leaves.append(tree)
        return TreeDef("leaf")
    if tree is None:
        return TreeDef("none")
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys,
                       [_def(tree[k], leaves, is_leaf) for k in keys])
    if isinstance(tree, list):
        return TreeDef("list", None, [_def(x, leaves, is_leaf) for x in tree])
    if isinstance(tree, tuple):
        return TreeDef("tuple", type(tree),
                       [_def(x, leaves, is_leaf) for x in tree])
    leaves.append(tree)
    return TreeDef("leaf")


def tree_flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], TreeDef]:
    """(leaves in ``jax.tree.flatten``'s order, structure). ``is_leaf``, as
    in JAX, stops the descent at the subtrees it accepts (a tuple of
    logical axis names, say)."""
    leaves: List[Any] = []
    return leaves, _def(tree, leaves, is_leaf)


def _build(td: TreeDef, it: Iterator[Any]):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.meta, kids))
    if td.kind == "list":
        return kids
    if td.meta is tuple:
        return tuple(kids)
    return td.meta(*kids)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError(f"more leaves than the {treedef.num_leaves} of "
                         "the structure")
    return out


_END = object()


def flatten_up_to(treedef: TreeDef, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of ``treedef`` (a tree of
    optimizer slots against the parameter tree, say)."""
    if treedef.kind == "leaf":
        return [tree]
    if treedef.kind == "none":
        return []
    if treedef.kind == "dict":
        if tuple(sorted(tree)) != treedef.meta:
            raise ValueError(f"keys {sorted(tree)} differ from "
                             f"{list(treedef.meta)}")
        subs = [tree[k] for k in treedef.meta]
    else:
        subs = list(tree)
        if len(subs) != len(treedef.children):
            raise ValueError("tree structures differ")
    return [x for c, s in zip(treedef.children, subs)
            for x in flatten_up_to(c, s)]


def tree_map(fn: Callable[..., Any], tree, *rest,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves (or
    subtrees) of ``rest``, keeping ``tree``'s structure."""
    leaves, td = tree_flatten(tree, is_leaf)
    others = [flatten_up_to(td, r) for r in rest]
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def tree_leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]
