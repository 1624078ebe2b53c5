"""Recursive variance-reduction estimators (GeomSARAH / PAGE family): the
worker side of Algorithm 1 as a standalone component, the counterpart of
``repro.core.estimators``.

  page_update(c_k, g_prev, full_grad, diff)  ->  g_i^{k+1}
     = full_grad                 if c_k
     = g_prev + diff             otherwise

with ``diff`` already compressed and clipped by the caller.  ``p_choice``
is the paper's recommended p = min{C/n, b/m, zeta_Q/d}.
"""
from __future__ import annotations

import torch

__all__ = ["page_update", "page_update_tree", "p_choice"]


def page_update(c_k, g_prev, full_grad, diff):
    """Flat-vector PAGE estimator switch (``c_k`` a bool or a 0-d bool
    tensor)."""
    return torch.where(torch.as_tensor(c_k, device=g_prev.device), full_grad,
                       g_prev + diff)


def page_update_tree(c_k, g_prev, full_grad, diff):
    """PAGE estimator switch over dicts of tensors."""
    return {k: page_update(c_k, g_prev[k], full_grad[k], diff[k])
            for k in g_prev}


def p_choice(C: int, n: int, b: int, m: int, zeta_q: float, d: int) -> float:
    """p = min{C/n, b/m, zeta_Q/d}: balances client, oracle and
    communication cost per round (Section 4)."""
    return float(min(C / n, b / m, zeta_q / d))
