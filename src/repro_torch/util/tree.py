"""Trees of tensors as ``jax.tree`` sees them: nested dicts, tuples, lists
and named tuples, with ``None`` holding no leaf.

Dict keys are visited in sorted order, so ``leaves`` come in the order of
the reference's ``jax.tree.leaves`` and ``path_str`` gives the key paths
its checkpoints record (``checkpoint._path_str``).
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> list[tuple[Any, Any]] | None:
    """[(key, child)] of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def _rebuild(tree, children: list):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if _is_namedtuple(tree):
        return type(tree)(*children)
    return type(tree)(children)


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(key path, leaf)] in ``jax.tree`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(leaves_with_paths(child, prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), in ``tree``'s structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, child, *(o[i][1] for o in others))
        for i, (_, child) in enumerate(kids)])


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
