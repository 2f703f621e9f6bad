"""Dotted-path access into nested parameter trees (dicts + lists), and a
map over the tensors of such trees (counterpart of
``autoround_tpu/utils/pytree.py``; ``tree_map`` stands in for
``jax.tree.map`` on the trees the port uses).

Layer names may address nested structures, e.g. ``experts.3.w1`` inside a
MoE block; a Llama block uses flat names.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["get_by_path", "set_by_path", "tree_map"]


def get_by_path(tree: Any, path: str) -> Any:
    node = tree
    for p in path.split("."):
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    return node


def _set(node: Any, parts, i: int, value: Any) -> Any:
    if i == len(parts):
        return value
    p = parts[i]
    if isinstance(node, (list, tuple)):
        new = list(node)
        new[int(p)] = _set(node[int(p)], parts, i + 1, value)
        return new if isinstance(node, list) else tuple(new)
    new = dict(node)
    # a missing FINAL key is created; missing intermediates stay errors
    new[p] = _set(node.get(p) if i == len(parts) - 1 else node[p], parts,
                  i + 1, value)
    return new


def set_by_path(tree: Any, path: str, value: Any) -> Any:
    """Functional set: returns a copy of ``tree`` with ``path`` replaced
    (shares unmodified branches).  The recursion is a module-level function,
    not a closure over ``value``: a closure that calls itself is a
    reference cycle, which would keep ``value`` (a weight-sized tensor and,
    under autograd, its graph) alive until the cyclic collector runs."""
    return _set(tree, path.split("."), 0, value)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``); dicts, lists and tuples are the containers, None stays."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(tree, *rest)
