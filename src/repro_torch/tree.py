"""Param trees of the port: nested dicts of tensors whose per-layer
blocks are lists of dicts (``blocks``, ``enc_blocks``, ``dec_blocks``),
where the JAX package stacks the layers on a leading axis.

The JAX package walks its trees with ``jax.tree``; these are the few
walks the port's training needs.  A leaf's path names its dict keys and
list indices; dropping the indices gives the path of the JAX leaf it is
one layer of (``jax_path``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

Path = Tuple[Any, ...]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; dicts and lists are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, dict keys in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``tree_paths`` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def jax_path(path: Path) -> Path:
    """The path of the JAX package's leaf: the layer indices dropped."""
    return tuple(p for p in path if not isinstance(p, int))


def jax_leaf_groups(tree) -> Dict[Path, List[Tuple[Path, Any]]]:
    """The port's leaves grouped by the JAX leaf they make up: one
    (path, leaf) for a leaf outside the layer lists, one per layer, in
    layer order, for a leaf of a layer list (the JAX leaf stacks them)."""
    groups: Dict[Path, List[Tuple[Path, Any]]] = {}
    for path, leaf in tree_paths(tree):
        groups.setdefault(jax_path(path), []).append((path, leaf))
    return groups


def is_layered(path: Path) -> bool:
    """Whether the leaf at ``path`` is one layer of a layer list."""
    return any(isinstance(p, int) for p in path)


def tree_set(tree, path: Path, value) -> None:
    """Set the leaf at ``path`` in place."""
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def nested_set(tree: dict, path: Path, value) -> None:
    """Set ``value`` at ``path`` in a tree of dicts, making the dicts."""
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def nested_get(tree: dict, path: Path):
    """The value at ``path`` in a tree of dicts."""
    for p in path:
        tree = tree[p]
    return tree
