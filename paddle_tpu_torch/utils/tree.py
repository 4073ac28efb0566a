"""Tree maps over the port's state trees (dicts, lists and tuples of
tensors, arrays and Python values): the part of ``jax.tree_util`` the
runtime needs.  A leaf's path is its checkpoint name: dict keys and
sequence indices joined by "/" (``distributed/checkpoint.py``).  Container
types are kept, an ``OrderedDict`` included."""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_map_with_path"]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` applied to every leaf, in a tree of the same
    structure."""
    if isinstance(tree, dict):
        return type(tree)(
            (k, tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix
                                   else str(k)))
            for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn(leaf)`` applied to every leaf."""
    return tree_map_with_path(lambda _path, leaf: fn(leaf), tree)
