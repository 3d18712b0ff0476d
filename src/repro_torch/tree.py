"""Nested dicts of tensors: the port's counterpart of the ``jax.tree``
calls of the JAX package's training path.  A tree is a dict whose values
are trees or leaves; the leaves come in sorted-key order, the order in
which ``jax.tree.leaves`` flattens a dict."""

from __future__ import annotations

from typing import Any, Callable

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf to `tree` and the trees of the same
    structure in `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """The tree of `like`'s structure holding `leaves`, in
    :func:`tree_leaves`'s order."""
    it = iter(leaves)

    def walk(t: Tree) -> Tree:
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(like)
