"""Pytrees of tensors without JAX: nested dicts, tuples, NamedTuples and
lists, flattened in ``jax.tree`` order (dict keys sorted, sequences and
NamedTuple fields in order; None holds no leaf).

Keys are the JAX package's snapshot keys
(``ray_tpu/train/_internal/snapshot.py`` ``_key_str``): dict keys,
sequence indices and NamedTuple field names joined by "/", "." for a bare
leaf.  So the port's ``TrainState`` flattens to the same keys as the JAX
package's (``params/layers/wq``, ``opt_state/0/mu/embed``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key part, child) pairs of an inner node, in flatten order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    return [(str(i), c) for i, c in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, tuple, list))


def tree_leaves_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` in flatten order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix or ".", tree)]
    return [kv for k, c in _children(tree)
            for kv in tree_leaves_with_keys(c, f"{prefix}/{k}" if prefix else k)]


def tree_leaves(tree) -> list:
    """The leaves in flatten order."""
    return [leaf for _, leaf in tree_leaves_with_keys(tree)]


def tree_map_with_keys(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The same structure with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix or ".", tree)
    out = {k: tree_map_with_keys(fn, c, f"{prefix}/{k}" if prefix else k)
           for k, c in _children(tree)}
    if isinstance(tree, dict):
        return {k: out[str(k)] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(out[f] for f in tree._fields))
    return type(tree)(out[str(i)] for i in range(len(tree)))


def tree_map(fn: Callable, tree):
    """The same structure with each leaf replaced by ``fn(leaf)``."""
    return tree_map_with_keys(lambda _, leaf: fn(leaf), tree)
