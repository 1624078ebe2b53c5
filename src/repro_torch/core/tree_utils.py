"""Dict-of-tensors <-> flat-matrix helpers (the slice's part of
``repro.core.tree_utils``).  A parameter tree is a dict of tensors,
flattened in sorted key order, as JAX flattens a dict."""
from __future__ import annotations

import torch

__all__ = ["tree_batch_ravel", "tree_norm"]


def tree_batch_ravel(tree: dict):
    """Flatten a dict of per-worker tensors into ONE contiguous (n, d)
    matrix (so a multi-tensor gradient reaches the kernels in one launch).

    Every leaf carries the same leading worker axis n; leaf (n, *s)
    contributes prod(s) columns.  Returns (matrix, unravel_row) where
    ``unravel_row`` maps an aggregated (d,) row back to a dict of per-leaf
    shapes without the worker axis."""
    if not tree:
        raise ValueError("tree_batch_ravel: empty tree")
    keys = sorted(tree)
    leaves = [tree[k] for k in keys]
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(
                f"leading worker axes disagree: {leaf.shape[0]} != {n}")
    shapes = [leaf.shape[1:] for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    dtype = leaves[0].dtype
    for dt in dtypes[1:]:
        dtype = torch.promote_types(dtype, dt)
    mat = torch.cat([leaf.reshape(n, -1).to(dtype) for leaf in leaves], dim=1)

    def unravel_row(v):
        out, offset = {}, 0
        for key, shape, dt in zip(keys, shapes, dtypes):
            size = shape.numel()
            out[key] = v[offset:offset + size].reshape(shape).to(dt)
            offset += size
        return out

    return mat, unravel_row


def tree_norm(tree) -> torch.Tensor:
    """Global l2 norm (f32) of a tensor or a dict of tensors."""
    leaves = tree.values() if isinstance(tree, dict) else (tree,)
    total = sum((leaf.float() * leaf.float()).sum() for leaf in leaves)
    return torch.sqrt(total)
