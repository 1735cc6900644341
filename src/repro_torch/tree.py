"""Parameter trees in ``jax.tree_util`` flatten order.

The reference package keeps its parameters in a pytree of nested dicts;
``jax.tree_util.tree_flatten`` visits dict keys in sorted order, and the
packed wire layout numbers leaves in exactly that order.  These helpers
give the same order for the port's dicts of tensors, so a plan built on
either side lays out the same bytes.  Lists and tuples are nodes too,
visited in order (a shard's piece list is one).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def flatten(tree: Tree) -> Tuple[List[Any], Any]:
    """(leaves in sorted-key order, treedef).  The treedef is the tree's
    structure with ``None`` at every leaf position."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        leaves.append(node)
        return None

    return leaves, walk(tree)


def leaves(tree: Tree) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: Any, leaf_list: List[Any]) -> Tree:
    it = iter(leaf_list)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])
