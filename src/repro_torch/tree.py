"""Nested-dict trees: the port's params, gradients, optimizer states and
spec trees.  A leaf is anything that is not a mapping (a tensor, a spec
tuple, a sharding); paths are "a/b/c"."""

from __future__ import annotations

from typing import Mapping

__all__ = ["tree_map", "tree_part", "tree_paths", "tree_from_paths"]


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (nested dicts), each with the subtrees
    of ``rest`` at the same path (a leaf's optimizer state may be a dict)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_part(tree, i: int):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: tree_part(v, i) for k, v in tree.items()}
    return tree[i]


def tree_paths(tree, prefix=""):
    """(path, leaf) of every leaf of a nested dict, paths "a/b/c"."""
    if isinstance(tree, Mapping):
        for k in tree:
            yield from tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def tree_from_paths(paths_values) -> dict:
    """The nested dict of (path, leaf) pairs (:func:`tree_paths`' inverse)."""
    tree: dict = {}
    for path, v in paths_values:
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree
