"""Parameter trees: nested dicts and lists with tensors for leaves.

``repro`` keeps its trees as JAX pytrees; the port's are plain dicts, and
a list where ``repro`` stacks layers along a leading axis (``"blocks"``).
The training code walks them with these three functions, in one fixed
order (dict insertion order, list order).
"""
from __future__ import annotations


def flatten(tree, prefix=()) -> list:
    """``[(path, leaf), ...]``: a path is the tuple of dict keys and list
    indices from the root."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pl for k, v in items for pl in flatten(v, prefix + (k,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(tree, new_leaves):
    """A tree shaped like ``tree`` with ``new_leaves`` in flatten order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    return unflatten(tree, [fn(*ls) for ls in
                            zip(leaves(tree), *map(leaves, rest))])
