"""Parameter trees: nested dicts, lists and tuples of tensors, and
dataclasses of them (``TrainState``), walked in JAX's pytree order: a
dict's keys sorted, a sequence in order, a dataclass's fields in
declaration order.  Paths are tuples of ``(kind, key)`` entries, kind
``"attr"`` (a dataclass field), ``"key"`` (a dict key) or ``"idx"`` (a
sequence index); :func:`keystr` spells one as ``jax.tree_util.keystr``
does, which is what checkpoint leaf names are made from.
"""
from __future__ import annotations

import dataclasses


def _children(tree):
    """[(path entry, child)] of an inner node, None for a leaf."""
    if isinstance(tree, dict):
        return [(("key", k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(("idx", i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(("attr", f.name), getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def leaves_with_path(tree, path=(), *, is_leaf=None):
    """Yield ``(path, leaf)`` in JAX's flatten order; ``is_leaf(node)``
    true stops the walk at ``node`` (a spec tuple, say)."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        yield path, tree
        return
    for entry, sub in kids:
        yield from leaves_with_path(sub, path + (entry,), is_leaf=is_leaf)


def leaves(tree, *, is_leaf=None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf=is_leaf)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which share its structure), called in flatten
    order; the structure is kept (a dict's keys come out sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """``tree``'s structure with ``new_leaves`` (in flatten order)."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of the same path."""
    fmt = {"attr": ".{}", "key": "[{!r}]", "idx": "[{}]"}
    return "".join(fmt[kind].format(k) for kind, k in path)
