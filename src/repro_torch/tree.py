"""Parameter trees: nested dicts, lists and tuples of arrays.

The port keeps an LM's per-layer parameters as lists (``blocks[i]``,
``m_blocks[g][j]``); ``repro`` stacks them on leading axes.  These helpers
walk a tree in ``jax.tree.leaves``' order and convert between the two
layouts; the checkpoint format and ``interop`` both use them.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np

#: ``repro``'s stacked parameter keys and how many leading axes each
#: stacks: ``[n_layers, ...]``, or ``[n_groups, group - 1, ...]``
STACKED = {"blocks": 1, "enc_blocks": 1, "s_blocks": 1, "m_blocks": 2}


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unstack(tree, axes: int):
    """A dict of arrays stacked on ``axes`` leading axes as nested lists
    of dicts (``[a[i] for i]``, or ``[[a[i, j] for j] for i]``)."""
    if axes == 0:
        return tree
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [unstack(map_tree(lambda a, i=i: a[i], tree), axes - 1)
            for i in range(first.shape[0])]


def stack(items: list, axes: int, to_numpy: Callable = np.asarray):
    """The inverse of :func:`unstack`: nested lists of dicts (``axes``
    deep) as one dict of NumPy arrays stacked on ``axes`` leading axes,
    each leaf converted by ``to_numpy`` first."""
    if axes == 0:
        return map_tree(to_numpy, items)
    parts = [stack(x, axes - 1, to_numpy) for x in items]
    return map_tree(lambda *xs: np.stack(xs), parts[0], *parts[1:])
