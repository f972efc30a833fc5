"""Nested dict/list trees of tensors — the port's stand-in for JAX pytrees.

Dict keys are visited in sorted order, as `jax.tree_util` flattens dicts,
so leaf order (and with it every sum over leaves) follows the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in flatten order; a path is the tuple of dict keys
    and list indices from the root."""
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from leaves_with_path(v, path + (k,))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: Path = ()):
    """`tree_map` whose ``fn`` also receives the leaf's path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_key(path: Path):
    """The innermost dict key of a path (None for a list index)."""
    return path[-1] if path and isinstance(path[-1], str) else None


def path_key(path: Path) -> str:
    """The reference's checkpoint key of a leaf: each dict key's ``str`` and
    each list index's ``str``, joined by ``/`` (as `jax.tree_util`'s
    ``DictKey.key`` / ``SequenceKey.idx`` render in
    `repro/checkpoint/checkpoint.py`), e.g. ``"layers/0/wq"``."""
    return "/".join(str(p) for p in path)


def set_path(tree, path: Path, value) -> None:
    """Replace the leaf at ``path`` in place (its parent container is
    mutated)."""
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
