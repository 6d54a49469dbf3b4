"""Nested containers of tensors in JAX's pytree order.

The port keeps weights as layer dicts (``({"w", "b"}, …)``) and the
training state as NamedTuples of lists, and writes checkpoints that the
JAX package reads. These functions walk such a tree in JAX's flatten
order — dict keys sorted, tuple and list items in order, a dataclass
instance's fields in declaration order (the JAX package registers its
``Normalizer`` as a pytree node of its fields) — and spell its structure
the way ``str(jax.tree_util.tree_structure(tree))`` does, so leaves bind
by position across the two packages. Anything else is a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _is_node_dataclass(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _fields(tree) -> list:
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def tree_leaves(tree) -> List:
    """The leaves in JAX's flatten order."""
    if _is_node_dataclass(tree):
        return [leaf for item in _fields(tree) for leaf in tree_leaves(item)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if _is_node_dataclass(tree):
        return type(tree)(*(tree_map(fn, item) for item in _fields(tree)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, item) for item in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, item) for item in tree)
    return fn(tree)


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` in its leaf slots, in
    flatten order."""
    leaves = list(leaves)
    n = len(tree_leaves(template))
    if n != len(leaves):
        raise ValueError(f"{len(leaves)} leaves given; the template has {n}")
    return _fill(template, iter(leaves))


def _fill(tree, it):
    if _is_node_dataclass(tree):
        return type(tree)(*(_fill(item, it) for item in _fields(tree)))
    if isinstance(tree, dict):
        filled = {k: _fill(tree[k], it) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_fill(item, it) for item in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(item, it) for item in tree)
    return next(it)


def _spell(tree) -> str:
    if _is_node_dataclass(tree):
        items = ", ".join(_spell(item) for item in _fields(tree))
        return f"CustomNode({type(tree).__name__}[()], [{items}])"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_spell(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        items = ", ".join(_spell(item) for item in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{items}])"
    if isinstance(tree, list):
        return "[" + ", ".join(_spell(item) for item in tree) + "]"
    if isinstance(tree, tuple):
        items = ", ".join(_spell(item) for item in tree)
        return f"({items},)" if len(tree) == 1 else f"({items})"
    return "*"


def treedef(tree) -> str:
    """The structure string JAX's checkpoint header stores for ``tree``."""
    return f"PyTreeDef({_spell(tree)})"
