"""The clipping operator, the paper's central ingredient.

``clip_lambda(x) := min{1, lambda/||x||} * x`` (clip(0) := 0), applied to
gradient differences with the data-dependent radius

    lambda_{k+1} = alpha * ||x^{k+1} - x^k||

(Theorem 4.1: alpha = 2*L; Theorem 4.2 with bounded compressors:
alpha = D_Q * L).
"""
from __future__ import annotations

import torch

# the one definition of the factor, shared with the fused kernel wrapper
from ..kernels.clip_aggregate import clip_factor
from .tree_utils import tree_norm

__all__ = ["clip", "clip_rows", "clip_tree", "clip_factor", "marina_radius",
           "theorem41_alpha", "theorem42_alpha"]


def clip(x: torch.Tensor, radius) -> torch.Tensor:
    """Clip one tensor by its global l2 norm."""
    norm = torch.linalg.vector_norm(x.float())
    return x * clip_factor(norm, radius).to(x.dtype)


def clip_rows(xs: torch.Tensor, radius) -> torch.Tensor:
    """Clip every row of an (n, d) matrix by its own l2 norm (the server's
    re-clip of each received message).  A row's result depends on that
    row alone."""
    factors = clip_factor(torch.linalg.vector_norm(xs.float(), dim=1),
                          radius)
    return xs * factors[:, None].to(xs.dtype)


def clip_tree(tree: dict, radius) -> dict:
    """Clip a dict of tensors by its joint l2 norm."""
    factor = clip_factor(tree_norm(tree), radius)
    return {k: (v * factor).to(v.dtype) for k, v in tree.items()}


def marina_radius(x_new, x_old, alpha) -> torch.Tensor:
    """lambda_{k+1} = alpha * ||x^{k+1} - x^k|| for tensors or dicts."""
    if isinstance(x_new, dict):
        diff_norm = tree_norm({k: x_new[k] - x_old[k] for k in x_new})
    else:
        diff_norm = torch.linalg.vector_norm(x_new.float() - x_old.float())
    return alpha * diff_norm


def theorem41_alpha(smoothness_L):
    """Clipping coefficient of Theorem 4.1: lambda = 2*L*||x+ - x||."""
    return 2.0 * smoothness_L


def theorem42_alpha(smoothness_L, compressor_bound_DQ):
    """Clipping coefficient of Theorem 4.2: lambda = D_Q*L*||x+ - x||."""
    return compressor_bound_DQ * smoothness_L
