"""Trees of tensors: nested dicts and lists, flattened in the reference's order.

The reference's optimizer state, train step and checkpoint format are
built on JAX pytrees.  The port keeps the same trees (dicts, lists and
tuples of tensors, with ``None`` for an absent branch) and flattens them
in the order ``jax.tree_util`` does: dict keys sorted, sequences in
order, ``None`` dropped.  That order names a checkpoint's arrays
(``a0``, ``a1``, ...), so a checkpoint written by either package pairs
the same arrays with the same leaves in the other.  ``is_leaf`` stops
the descent at a node; any object that is not a dict, list or tuple (a
tensor, or a compressed container: ``QTensor``, ``BlockSparseTensor``,
``QEmbed``) is a leaf already.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch


def _children(node):
    """(keys, children) of an inner node in flattening order, or None for
    a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return list(range(len(node))), list(node)
    return None


def _paths(node, path, is_leaf, out) -> None:
    if node is None:
        return
    kids = None if is_leaf is not None and is_leaf(node) else _children(node)
    if kids is None:
        out.append((path, node))
        return
    for k, c in zip(*kids):
        _paths(c, path + (k,), is_leaf, out)


def flatten_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                      ) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in flattening order; a path is the tuple of dict keys
    and sequence indices from the root."""
    out: List[Tuple[Tuple, Any]] = []
    _paths(tree, (), is_leaf, out)
    return out


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


# The walkers are module-level functions, not recursive closures: a closure
# that calls itself is a reference cycle, which would keep every tensor it
# reaches alive until the cyclic garbage collector runs.

def _build(node, it, is_leaf):
    if node is None:
        return None
    kids = None if is_leaf is not None and is_leaf(node) else _children(node)
    if kids is None:
        return next(it)
    if isinstance(node, dict):
        rebuilt = {k: _build(node[k], it, is_leaf) for k in kids[0]}
        return {k: rebuilt[k] for k in node}          # the tree's own key order
    rebuilt = [_build(c, it, is_leaf) for c in node]
    return tuple(rebuilt) if isinstance(node, tuple) else rebuilt


def unflatten_like(tree, new_leaves, is_leaf=None):
    """``tree``'s structure with its leaves replaced, in flattening order,
    by ``new_leaves``."""
    it = iter(new_leaves)
    out = _build(tree, it, is_leaf)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _map(fn, node, others, is_leaf):
    if node is None:
        return None
    kids = None if is_leaf is not None and is_leaf(node) else _children(node)
    if kids is None:
        return fn(node, *others)
    if isinstance(node, dict):
        return {k: _map(fn, node[k], [o[k] for o in others], is_leaf) for k in node}
    out = [_map(fn, c, [o[i] for o in others], is_leaf) for i, c in enumerate(node)]
    return tuple(out) if isinstance(node, tuple) else out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn(leaf, *matching)`` over the leaves of ``tree``; each of ``rest``
    is walked along ``tree``'s structure and gives the subtree at each of
    its leaves (so a state tree whose leaves are dicts maps leaf by leaf,
    as ``treedef.flatten_up_to`` does)."""
    return _map(fn, tree, list(rest), is_leaf)


def tree_unzip(tree, n: int, like):
    """Split a tree whose leaves are ``n``-tuples (mapped along ``like``'s
    structure) into ``n`` trees."""
    return [tree_map(lambda _, t, i=i: t[i], like, tree) for i in range(n)]


def _differentiable(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def _alias(leaf, diff: list):
    """``leaf`` with each float tensor (a sharded leaf's float pieces
    included) replaced by a detached alias that requires grad, appended to
    ``diff``."""
    from repro_torch.core.compressed import ShardedTensor
    if isinstance(leaf, ShardedTensor):
        return leaf.map(lambda p: _alias(p, diff))
    if _differentiable(leaf):
        diff.append(leaf.detach().requires_grad_(True))
        return diff[-1]
    return leaf


def _grad_of(leaf, got):
    """The gradient of ``leaf`` from the iterator ``got`` (in the order
    :func:`_alias` listed its tensors): zeros for an unused float tensor,
    ``None`` for anything else, and a sharded leaf's as a ``ShardedTensor``
    of the same layout, each piece's on its own device."""
    from repro_torch.core.compressed import ShardedTensor
    if isinstance(leaf, ShardedTensor):
        return leaf.map(lambda p: _grad_of(p, got))
    if not _differentiable(leaf):
        return None
    g = next(got)
    return torch.zeros_like(leaf) if g is None else g


def value_and_grad(fn, params):
    """(``fn(params)``, its gradient as a tree like ``params``): the
    counterpart of ``jax.value_and_grad``.  The params are not modified;
    their leaves are differentiated through detached aliases, so no
    ``.grad`` is left behind.  Each gradient has its param's dtype.  A
    sharded leaf (``ShardedTensor``, nested ones included) is
    differentiated piece by piece and its gradient is a ``ShardedTensor``
    cut the same way.  A leaf that is not a float tensor (a compressed
    container such as ``QTensor`` or ``QEmbed``, integer codes) is passed
    as it is and its gradient is ``None``."""
    ls = leaves(params)
    diff: list = []
    alias = [_alias(p, diff) for p in ls]
    with torch.enable_grad():
        value = fn(unflatten_like(params, alias))
        got = iter(torch.autograd.grad(value, diff, allow_unused=True))
    grads = [_grad_of(p, got) for p in ls]
    return value.detach(), unflatten_like(params, grads)


__all__ = ["flatten_with_path", "leaves", "tree_map", "tree_unzip", "unflatten_like",
           "value_and_grad"]
