"""Nested containers of tensors ("trees"): the port's stand-in for the
reference's ``jax.tree_util``, over what the port's trees hold.

A tree is a ``dict`` (visited in sorted key order, as ``jax.tree_util``
visits one), a ``list`` or ``tuple`` (in order), a dataclass instance
(its fields in declaration order, as ``jax.tree_util.register_dataclass``
flattens one) or a leaf: anything else (a tensor, a numpy array, a
number).  The optimizer, the checkpointer and the fault-tolerant loop
walk parameters, gradients and ``TrainState`` with these.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator


def _children(node) -> list[tuple[str, Any]] | None:
    """(name, child) pairs of a container, ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def leaves_with_paths(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Every leaf with its ``/``-joined path, in flattening order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from leaves_with_paths(child,
                                     f"{prefix}/{name}" if prefix else name)


def leaves(tree) -> list:
    """The leaves of ``tree`` in flattening order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def paths(tree) -> list[str]:
    """The leaves' paths, e.g. ``blocks/0/sub0/attn/wq``."""
    return [p for p, _ in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *same_leaves_of_rest)`` at every leaf of ``tree``; the
    other trees have its structure (a leaf of ``tree`` may stand over a
    subtree of another, which ``fn`` then gets whole)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        # visited in flattening (sorted) order, kept in the tree's own
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(tree)})


def unflatten(like, new_leaves: list):
    """A tree of ``like``'s structure holding ``new_leaves`` in
    flattening order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out
