"""Leaves of nested containers, the port's stand-in for JAX's pytrees.

A tree is a tensor, a numpy array or a number (a leaf), None (no leaf),
or a dict (keys in sorted order, as JAX orders them), tuple, list or
dataclass of trees. A dataclass's children are its fields in declaration
order that hold a tensor, an array or a container; a field holding a
plain number, a string or None is static metadata, as flax's
``pytree_node=False`` fields are (``PoseGraphData.total_dof``, say).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_ARRAY = (torch.Tensor, np.ndarray)


def _is_container(x) -> bool:
    return isinstance(x, (dict, tuple, list)) or (
        dataclasses.is_dataclass(x) and not isinstance(x, type))


def _children(node):
    """(path step, child) pairs of a container."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return [(f".{f.name}", getattr(node, f.name))
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), _ARRAY)
            or _is_container(getattr(node, f.name))]


def leaves_with_path(tree, path: str = ""):
    """[(path, leaf)] in flattening order."""
    if tree is None:
        return []
    if not _is_container(tree):
        return [(path, tree)]
    out = []
    for step, child in _children(tree):
        out.extend(leaves_with_path(child, path + step))
    return out


def leaves(tree):
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(template, new_leaves):
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (which must hold exactly as many)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if not _is_container(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return type(node)((k, built[k]) for k in node)
        if isinstance(node, (tuple, list)):
            items = [build(v) for v in node]
            if hasattr(node, "_fields"):  # a namedtuple
                return type(node)(*items)
            return type(node)(items)
        updates = {name[1:]: build(child) for name, child in _children(node)}
        return dataclasses.replace(node, **updates)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
