"""Parameter trees: nested dicts, lists and tuples with tensors (or
numpy arrays, or ints) for leaves.

``repro`` keeps its trees as JAX pytrees; the port's are plain dicts, and
a list where ``repro`` stacks layers along a leading axis (``"blocks"``).
``flatten`` / ``leaves`` / ``unflatten`` / ``tree_map`` walk them in one
order, ``repro``'s flat order, that of ``jax.tree.leaves`` on its stacked
tree: dict keys sorted, and each layer stack walked leaf-major: for every
per-layer key path (sorted), the L layers one after another, exactly the
elements of ``repro``'s stacked ``(L, ...)`` leaf.  Every flat vector the
port shares a layout with ``repro`` through (the gradient-sync buckets,
the int8 chunks, the ZeRO shards and their decay masks) is in this order.

A list under the key ``STACK_KEY`` (``"blocks"``, at the top and under
the audio ``"encoder"``) is a layer stack: that is the one rule for which
paths are stacks, and ``bridge`` maps paths with it (``repro_path``).
Any other list, and every tuple, is walked in its own order, as JAX
walks them; the checkpoint store writes its ``(params, opt_state)``
tuples in this order too.
"""
from __future__ import annotations

STACK_KEY = "blocks"


def flatten(tree, prefix=()) -> list:
    """``[(path, leaf), ...]`` in ``repro``'s flat order (module
    docstring).  A path is the tuple of dict keys and list and tuple
    indices from the root, a layer's index included."""
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten(v, prefix + (i,))]
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k == STACK_KEY and isinstance(v, list):
            layers = [flatten(lp, prefix + (k, i)) for i, lp in enumerate(v)]
            if any(len(lp) != len(layers[0]) for lp in layers):
                raise ValueError(f"the layers of "
                                 f"{'/'.join(map(str, prefix + (k,)))} "
                                 f"differ in their leaves")
            for j in range(len(layers[0]) if layers else 0):
                out.extend(lp[j] for lp in layers)
        else:
            out.extend(flatten(v, prefix + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def _build(tree, by_path: dict, prefix=()):
    """``tree``'s dicts (in their own key order), lists and tuples, with
    ``by_path[path]`` for the leaf at each path."""
    if isinstance(tree, dict):
        return {k: _build(v, by_path, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_build(v, by_path, prefix + (i,))
                          for i, v in enumerate(tree))
    return by_path[prefix]


def unflatten(tree, new_leaves):
    """A tree shaped like ``tree`` with ``new_leaves`` in flatten order."""
    paths = [p for p, _ in flatten(tree)]
    new_leaves = list(new_leaves)
    if len(new_leaves) != len(paths):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(paths)}")
    return _build(tree, dict(zip(paths, new_leaves)))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    return unflatten(tree, [fn(*ls) for ls in
                            zip(leaves(tree), *map(leaves, rest))])


def repro_path(path: tuple) -> tuple:
    """Port path -> (repro path, the stack's path, layer index), the last
    two None outside a layer stack."""
    for i, key in enumerate(path[:-1]):
        if key == STACK_KEY and isinstance(path[i + 1], int):
            return path[:i + 1] + path[i + 2:], path[:i + 1], path[i + 1]
    return path, None, None


def is_stacked(path: tuple) -> bool:
    """The leaf at ``path`` sits in a layer stack (``repro`` gives it a
    leading L axis, one rank more than the port's leaf)."""
    return any(isinstance(k, int) for k in path)


def set_path(tree, path: tuple, value) -> None:
    """Put ``value`` at ``path`` of ``tree``, whose dicts and lists are
    all there already (a skeleton from ``tree_map``)."""
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
