"""Trees of tensors in JAX's leaf order.

The training state is nested dicts and lists of tensors, as the
reference's pytrees are.  JAX flattens a dict in the order of its sorted
keys and a list or tuple in order (``None`` holds no leaf); the optimizer,
the compressed exchange and the checkpoint's ``leaf_<i>.bin`` numbering
all follow that order here, so leaf i is the same tensor in both
packages.  (``torch.utils._pytree`` keeps a dict's insertion order.)
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "tree_map", "unflatten"]


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    if tree is None:
        return []
    return [tree]


def _rebuild(tree, it: Iterator):
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}  # the leaves in JAX's order, the keys in tree's
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    if tree is None:
        return None
    return next(it)


def unflatten(like, flat: list) -> Any:
    """A tree of ``like``'s structure holding ``flat``'s leaves in order."""
    it = iter(flat)
    out = _rebuild(like, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
