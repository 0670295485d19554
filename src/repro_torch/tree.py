"""Nested dicts of tensors read as the reference reads its pytrees: the
leaves in sorted-key order (``jax.tree.flatten`` sorts a dict's keys)
and each leaf's path written as ``jax.tree_util.keystr`` writes it,
``['params']['blocks']['attn']['wq']``.  The optimizer sums its global
norm in this order and the checkpoint's manifest keys its leaves by
these paths, so both packages read each other's checkpoints."""
from __future__ import annotations


def flatten_with_path(tree, is_leaf=None, path=()) -> list:
    """[(path, leaf)] in sorted-key order; a dict for which ``is_leaf``
    holds is one leaf."""
    if isinstance(tree, dict) and not (is_leaf is not None and is_leaf(tree)):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], is_leaf, path + (k,))
        return out
    return [(path, tree)]


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def unflatten(paths, values) -> dict:
    """The nest of dicts with ``values`` at ``paths``."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def map_tree(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    of ``rest`` (trees of the same structure)."""
    flat = flatten_with_path(tree, is_leaf)
    others = [leaves(r, is_leaf) for r in rest]
    return unflatten([p for p, _ in flat],
                     [fn(leaf, *(o[i] for o in others)) for i, (_, leaf) in enumerate(flat)])
