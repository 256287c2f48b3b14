"""Nested-dict trees of tensors (the parameter, gradient, optimiser and
train-state trees), walked in the order ``jax.tree`` walks a dict: keys
sorted, depth first.  A leaf's path is its keys joined by ``/``, the
reference checkpoint's key."""
from __future__ import annotations

from typing import Callable, Iterator

__all__ = ["tree_items", "tree_leaves", "tree_map", "tree_map_with_path",
           "tree_unflatten"]


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(path, leaf) for every leaf, in ``jax.tree`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}" if prefix
                                  else str(k))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the like leaves of ``rest``
    (trees of the same keys), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *like_leaves)`` over the leaves, keeping the
    structure; ``path`` is the leaf's keys joined by ``/``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      prefix=f"{prefix}/{k}" if prefix
                                      else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)
