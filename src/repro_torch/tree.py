"""Nested containers of tensors (the port's stand-in for JAX pytrees).

A tree is a dict (visited in sorted key order, as ``jax.tree_util`` visits
one), a list, a tuple or a ``NamedTuple`` (``training.optimizer.
AdamWState``), nesting any of these; every other object is a leaf.  Paths
name each step as the JAX checkpoint manager names it: ``k:<key>`` for a
dict key, ``i:<index>`` for a list or tuple position, ``n:<field>`` for a
named-tuple field.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path step, child) pairs of a container; [] for a leaf."""
    if isinstance(tree, dict):
        return [(f"k:{k}", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f"n:{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"i:{i}", c) for i, c in enumerate(tree)]
    return []


def _is_container(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_path(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """Every leaf with its path (a tuple of steps), depth first."""
    if not _is_container(tree):
        return [(prefix, tree)]
    out = []
    for step, child in _children(tree):
        out.extend(leaves_with_path(child, prefix + (step,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in ``leaves``' order; a tree of
    the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, c) for c in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c) for c in tree)
    return fn(tree)


def unflatten_like(tree, new_leaves: list):
    """A tree of ``tree``'s structure holding ``new_leaves`` in the order
    ``leaves(tree)`` gives."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
