"""Flatten and rebuild the FL update trees in the reference's leaf order.

The reference walks its parameter, delta, residual and update trees with
``jax.tree`` (flatten, unflatten, paths, ``keystr``). Its index-based draws
(``faults.corrupt_update`` picks a leaf, then a byte) and its per-leaf
format lists only agree with the port's when both walk the same leaves in
the same order. The port's trees are nested dicts whose leaves are tensors,
numpy arrays, :class:`~repro_torch.core.qtensor.QTensor` or ``None``, and
this module walks them as ``jax.tree`` does:

* dict keys in sorted order, list and tuple items in order;
* ``None`` is an empty node: skipped, unless ``keep_none`` (the
  reference's ``is_leaf=lambda x: x is None``);
* a ``QTensor`` is one leaf, or with ``expand_q`` its ``codes`` then its
  ``scales`` (the reference's pytree children, in that order).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor

_END = object()


def leaves_with_path(tree, *, expand_q: bool = False,
                     keep_none: bool = False, path: tuple = ()):
    """(key path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], expand_q=expand_q,
                                        keep_none=keep_none, path=path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, expand_q=expand_q,
                                        keep_none=keep_none, path=path + (i,))
    elif tree is None:
        if keep_none:
            yield path, None
    elif expand_q and isinstance(tree, QTensor):
        yield path + (0,), tree.codes
        yield path + (1,), tree.scales
    else:
        yield path, tree


def leaves(tree, **kw) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, **kw)]


def unflatten(template, new_leaves, *, expand_q: bool = False,
              keep_none: bool = False):
    """``template``'s structure with its leaves replaced, in flatten order,
    by ``new_leaves`` (the inverse of :func:`leaves` with the same flags;
    an expanded QTensor is rebuilt around its new codes and scales)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return next(it) if keep_none else None
        if expand_q and isinstance(t, QTensor):
            codes = next(it)
            return QTensor(codes, next(it), t.fmt, t.block, t.shape,
                           t.packed)
        return next(it)

    out = build(template)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, *rest, keep_none: bool = False):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (QTensor leaves whole)."""
    flat = [leaves(t, keep_none=keep_none) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)],
                     keep_none=keep_none)


def structure(tree) -> tuple:
    """A hashable stand-in for the reference's treedef with QTensor leaves
    (``is_leaf=_is_q``): every leaf's path, ``None`` nodes included."""
    return tuple(p for p, _ in leaves_with_path(tree, keep_none=True))


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a key path: ``['blocks']['b0'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def to_numpy(x) -> np.ndarray:
    """A leaf's array on the host (torch tensors from any device; their
    uint16 / uint32 codes and words keep their dtype)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
