"""Nested parameter trees: the port's counterpart of the ``jax.tree``
calls the reference makes on its pytrees.

A tree is a nested ``dict`` (visited in sorted-key order, as JAX orders a
dict's children), ``list`` or ``tuple``; anything else is a leaf.  The
leaf order is the reference's, so a gradient bucket plan, an optimizer
state or a checkpoint walks the leaves in the same order in both
packages, and a leaf's path (``"layers/attn/wq"``) is the key the
reference's checkpointer writes.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

PyTree = Any
_END = object()


def _children(tree: PyTree) -> Iterator[Tuple[str, PyTree]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield str(k), tree[k]
    else:
        for i, v in enumerate(tree):
            yield str(i), v


def _is_node(tree: PyTree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves(tree: PyTree) -> List[Any]:
    """Every leaf, in the reference's order."""
    return [leaf for _, leaf in paths(tree)]


def paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, ``"/"``-joined keys, in order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def unflatten(like: PyTree, new_leaves: Sequence[Any]) -> PyTree:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:  # noqa: A001
    """``fn(leaf, *same_position_leaves)`` over trees of one structure."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    for o in others:
        if len(o) != len(mine):
            raise ValueError("trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(mine, *others)])
