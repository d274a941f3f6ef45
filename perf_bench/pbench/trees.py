"""Operations on the port's state trees (NamedTuples of tensors, the
route batch leading every tensor)."""

from __future__ import annotations

import torch


def cat_rows(trees):
    """Concatenate states along their leading (route) dimension."""
    if isinstance(trees[0], torch.Tensor):
        return torch.cat(trees, 0)
    return type(trees[0])(*(cat_rows(xs) for xs in zip(*trees)))


def take_rows(tree, rows: torch.Tensor):
    """The rows ``rows`` of every tensor of ``tree``, copied."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, rows.to(tree.device)).clone()
    return type(tree)(*(take_rows(x, rows) for x in tree))


def to_cpu(tree):
    """``tree`` with every tensor copied to the host (numpy arrays are
    kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if not isinstance(tree, tuple):
        return tree
    items = [to_cpu(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def leaves(tree, prefix: str = ""):
    """(dotted name, tensor) of every tensor of ``tree``."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, x in zip(tree._fields, tree):
        yield from leaves(x, f"{prefix}.{name}" if prefix else name)


def map_floats(tree, fn):
    """``tree`` with ``fn`` applied to every floating-point tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if not isinstance(tree, tuple):
        return tree
    items = [map_floats(x, fn) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
