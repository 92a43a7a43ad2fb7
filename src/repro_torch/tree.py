"""Nested containers of tensors ("trees"), walked as ``jax.tree`` walks a
pytree: a dict's values in sorted key order, a tuple's or list's (a
NamedTuple's fields included) in order, ``None`` a node with no leaves,
anything else a leaf.  The training code (``train/``,
``distributed/compression.py``) keeps params, gradients and optimizer
state in such trees, and ``train/checkpoint.py`` writes their leaves in
this order, which is the reference's ``jax.tree.flatten`` order.
"""
from __future__ import annotations

from typing import Callable


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, tuple, list))


def _children(node) -> list:
    if node is None:
        return []
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def _rebuild(node, children: list):
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if not _is_node(tree):
        return [tree]
    return [leaf for child in _children(tree) for leaf in leaves(child)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), into ``tree``'s structure."""
    if not _is_node(tree):
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, c, *(o[i] for o in others))
                           for i, c in enumerate(_children(tree))])


def unflatten(like, flat: list):
    """``like``'s structure with its leaves replaced, in order, by
    ``flat``'s."""
    n = len(leaves(like))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a structure of {n}")
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree.flatten(tree)[1])`` spells it."""
    def s(node) -> str:
        if node is None:
            return "None"
        if not _is_node(node):
            return "*"
        kids = [s(c) for c in _children(node)]
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {v}" for k, v in
                                   zip(sorted(node), kids)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return (f"CustomNode(namedtuple[{type(node).__name__}], "
                    f"[{', '.join(kids)}])")
        if isinstance(node, tuple):
            one = "," if len(kids) == 1 else ""
            return "(" + ", ".join(kids) + one + ")"
        return "[" + ", ".join(kids) + "]"
    return f"PyTreeDef({s(tree)})"

