"""The attack stage of the engine: ``make_context`` builds one round's
``AttackContext`` (the one place that computes the sampled-cohort
byzantine-majority bit) and ``AttackStage`` corrupts the (n, d) message
matrix.  The pytree and synthetic-cohort forms of ``repro.scenarios``
come with ROADMAP queue 1 items 9-11."""
from __future__ import annotations

import torch

from ..core.attacks import Attack, AttackContext, make_attack

__all__ = ["AttackStage", "make_context"]


def make_context(honest, *, good_mask, sampled, x_now=None, x_prev=None,
                 x0=None, g_prev=None, key=None) -> AttackContext:
    """One round's context; iterate fields default to zeros of the
    message width.  ``byz_majority`` stays a device tensor."""
    zeros = torch.zeros(honest.shape[-1], device=honest.device)
    n_good_s = (good_mask & sampled).sum()
    n_byz_s = (~good_mask & sampled).sum()
    return AttackContext(
        honest=honest,
        good_mask=good_mask,
        sampled=sampled,
        x_now=zeros if x_now is None else x_now,
        x_prev=zeros if x_prev is None else x_prev,
        x0=zeros if x0 is None else x0,
        g_prev=zeros if g_prev is None else g_prev,
        byz_majority=n_byz_s > n_good_s,
        key=key,
    )


class AttackStage:
    """``corrupt(ctx)`` returns the wire message: honest rows untouched,
    byzantine rows replaced by the attack payload."""

    def __init__(self, attack):
        self.attack: Attack = make_attack(attack)

    def corrupt(self, ctx: AttackContext) -> torch.Tensor:
        payload = self.attack(ctx)
        return torch.where(ctx.good_mask[:, None], ctx.honest,
                           payload.to(ctx.honest.dtype))
