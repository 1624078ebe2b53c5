"""Minimal optimizer substrate, the counterpart of
``repro.optim.optimizers``: (init, update) pairs over trees of tensors.

Byz-VR-MARINA-PP itself uses the plain step x <- x - gamma * g (no extra
state), but the examples and the heuristic base methods need standard
optimizers.  The state lives in f32; an update runs under ``no_grad``
and gives tensors that record no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree_utils import tree_flatten, tree_map, tree_unflatten

__all__ = ["Optimizer", "sgd", "momentum", "adamw", "AdamState"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, lr) -> (updates, state)

    def apply(self, params, grads, state, lr):
        """(params + updates, state).  Each update is dropped as soon as
        its leaf is stepped, so at most one tree of updates and one of
        new params exist beside ``params`` and ``grads``."""
        with torch.no_grad():
            updates, state = self.update(grads, state, params, lr)
            ups, _ = tree_flatten(updates)
            del updates
            leaves, treedef = tree_flatten(params)
            new = []
            for i, p in enumerate(leaves):
                new.append(p + ups[i].to(p.dtype))
                ups[i] = None
        return tree_unflatten(treedef, new), state


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                    params)


def sgd() -> Optimizer:
    return Optimizer(
        "sgd",
        init=lambda params: (),
        update=lambda g, s, p, lr: (tree_map(lambda gi: -lr * gi, g), s),
    )


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def update(g, m, p, lr):
        m = tree_map(lambda mi, gi: beta * mi + gi.to(F32), m, g)
        if nesterov:
            upd = tree_map(lambda mi, gi: -lr * (beta * mi + gi.to(F32)), m, g)
        else:
            upd = tree_map(lambda mi: -lr * mi, m)
        return upd, m

    return Optimizer(f"momentum{beta}", _zeros_f32, update)


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


def adamw(
    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0
) -> Optimizer:
    def init(params):
        leaves, _ = tree_flatten(params)
        device = leaves[0].device if leaves else None
        return AdamState(mu=_zeros_f32(params), nu=_zeros_f32(params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def update(g, s, p, lr):
        count = s.count + 1
        mu = tree_map(lambda m, gi: b1 * m + (1 - b1) * gi.to(F32), s.mu, g)
        nu = tree_map(
            lambda v, gi: b2 * v + (1 - b2) * torch.square(gi.to(F32)), s.nu, g
        )
        bc1 = 1 - b1 ** count.to(F32)
        bc2 = 1 - b2 ** count.to(F32)

        def upd(m, v, pi):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return -lr * (step + weight_decay * pi.to(F32))

        return tree_map(upd, mu, nu, p), AdamState(mu=mu, nu=nu, count=count)

    return Optimizer("adamw", init, update)
