"""Parameter trees in ``jax.tree_util`` flatten order.

The reference package keeps its parameters in a pytree of nested dicts;
``jax.tree_util.tree_flatten`` visits dict keys in sorted order, and the
packed wire layout numbers leaves in exactly that order.  These helpers
give the same order for the port's dicts of tensors, so a plan built on
either side lays out the same bytes.  Lists and tuples are nodes too,
visited in order (a shard's piece list is one), and so are
``NamedTuple``s, field by field (an optimizer's or the DSSP ring's
state), as ``jax.tree_util`` visits them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Tree = Any


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, leaves: List[Any], is_leaf=None):
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return None
    if isinstance(node, dict):
        return {k: _walk(node[k], leaves, is_leaf) for k in sorted(node)}
    if is_namedtuple(node):
        return type(node)(*[_walk(x, leaves, is_leaf) for x in node])
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(x, leaves, is_leaf) for x in node)
    leaves.append(node)
    return None


def flatten(tree: Tree, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], Any]:
    """(leaves in sorted-key order, treedef).  The treedef is the tree's
    structure with ``None`` at every leaf position.  ``is_leaf`` stops
    the walk at the nodes it accepts (a ``PartitionSpec`` is a tuple),
    as ``jax.tree_util``'s argument does.

    The walks are module functions, not closures: a nested function that
    calls itself through its closure is a reference cycle, and its cells
    (the leaf list, the leaf iterator) would keep every leaf tensor
    alive until the cycle collector runs."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves, is_leaf)


def leaves(tree: Tree, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if is_namedtuple(node):
        return type(node)(*[_build(x, it) for x in node])
    if isinstance(node, (list, tuple)):
        return type(node)(_build(x, it) for x in node)
    return next(it)


def unflatten(treedef: Any, leaf_list: List[Any]) -> Tree:
    it = iter(leaf_list)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Tree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Tree:
    flat, treedef = flatten(tree, is_leaf)
    return unflatten(treedef, [fn(x) for x in flat])
