"""The adaptive (optimisation-based) adversary, the counterpart of
``repro.scenarios.adaptive``.

The strongest adversary class the paper's theory targets: instead of a
fixed payload recipe, the byzantine workers run gradient ASCENT on the
server's own aggregation rule.  Two pieces:

- :func:`differentiable_aggregate`: a differentiable view of a
  ``ServerPlan``'s clip -> bucket -> aggregate composition.  The plain
  rules (the "torch" backend) differentiate directly.  The CUDA kernels
  build no autograd graph, so a kernel-backed plan goes through a
  ``torch.autograd.Function``: its forward runs the real kernels, its
  backward differentiates the plan's plain shadow on the same inputs
  (the two backends agree to rounding).  A kernel failure in the forward
  propagates; nothing falls back to the shadow.

- :func:`make_adaptive_attack`: the min-max inner loop ("autogm" style:
  the server minimises through its robust rule, the adversary maximises
  its damage within a step BUDGET).  Each round the byzantine workers
  pick one shared payload z, model the server's response
  ``Agg(clip(messages(z)))`` including the round's clip radius
  lambda_k = alpha * ||x^k - x^{k-1}||, and take ``budget`` normalised
  ascent steps on

      deviation:  || Agg(...) - mean(sampled good) ||^2
      descent:   - < Agg(...),  mean(sampled good) >

The adversary's Bucketing order is one permutation a round, held fixed
over its ascent steps and shared by the kernel forward and the shadow
backward: the context's ``key`` as a tensor, or drawn once from it when
it is a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.attacks import Attack, AttackContext, _good_sampled_stats
from ..core.clipping import marina_radius

__all__ = ["differentiable_aggregate", "torch_shadow_plan",
           "jnp_shadow_plan", "make_adaptive_attack", "ADAPTIVE_OBJECTIVES"]

ADAPTIVE_OBJECTIVES = ("deviation", "descent")


def torch_shadow_plan(plan):
    """The plan's differentiable twin: the same clip, bucket and aggregate
    stages on the plain "torch" backend, naive placement and no
    compressor (the engine form the adversary differentiates through)."""
    sched = dataclasses.replace(plan.schedule, backend="torch",
                                placement="naive", blocks="sequential")
    return dataclasses.replace(plan, schedule=sched, compress=None)


# the reference's name ("jnp" stays an alias of the "torch" backend)
jnp_shadow_plan = torch_shadow_plan


def _fixed_order(key, n: int):
    """A Bucketing order that every call of one round shares: a generator
    gives one permutation, drawn here; a tensor or None is kept."""
    if isinstance(key, torch.Generator):
        return torch.randperm(n, generator=key, device=key.device)
    return key


class KernelForward(torch.autograd.Function):
    """``apply(msgs, primal, shadow)``: ``primal(msgs)`` in the forward
    (the kernels, which build no graph), the gradient of
    ``shadow(msgs)`` in the backward.  Only ``msgs`` gets a gradient:
    the mask, the order and the radius are constants of the closures."""

    @staticmethod
    def forward(ctx, msgs, primal, shadow):
        ctx.shadow = shadow
        ctx.save_for_backward(msgs)
        with torch.no_grad():
            return primal(msgs)

    @staticmethod
    def backward(ctx, ct):
        (msgs,) = ctx.saved_tensors
        with torch.enable_grad():
            m = msgs.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(ctx.shadow(m), m, ct)
        return g, None, None


def _step_call(step, msgs, mask, key, radius):
    if radius is None:
        return step.aggregate(msgs, mask=mask, key=key)
    return step(msgs, mask=mask, key=key, radius=radius)


def differentiable_aggregate(plan):
    """``fn(msgs, *, mask, key, radius=None) -> (d,)``, differentiable in
    ``msgs``.  Where the plan's aggregator runs plain rules on ``msgs``
    (backend "torch", or "auto" off the card) the shadow runs as it is;
    where it runs kernels, :class:`KernelForward` pairs the kernel forward
    with the shadow's backward (backend "cuda" on a CPU tensor raises)."""
    shadow_step = torch_shadow_plan(plan).build()
    # the adversary models the server in engine (naive) form
    primal_step = dataclasses.replace(
        plan, schedule=dataclasses.replace(plan.schedule, placement="naive",
                                           blocks="sequential"),
        compress=None).build()

    def call(msgs, *, mask, key, radius=None):
        key = _fixed_order(key, msgs.shape[0])

        def shadow(m):
            return _step_call(shadow_step, m, mask, key, radius)

        if not primal_step.aggregator.uses_kernels(msgs):
            return shadow(msgs)

        def primal(m):
            return _step_call(primal_step, m, mask, key, radius)

        return KernelForward.apply(msgs, primal, shadow)

    return call


def _round_radius(plan, ctx: AttackContext):
    """The clip radius the server applies this round, as the
    (protocol-aware) adversary models it."""
    if plan.clip is None:
        return None
    if plan.clip.radius is not None:
        return float(plan.clip.radius)
    return marina_radius(ctx.x_now, ctx.x_prev, plan.clip.alpha)


def make_adaptive_attack(plan, *, budget: int = 8, lr: float = 0.5,
                         objective: str = "deviation",
                         name: str = "adaptive") -> Attack:
    """Budgeted gradient-ascent adversary against ``plan``'s
    (differentiable view of the) server step; an :class:`Attack` usable
    wherever a registry attack is."""
    if objective not in ADAPTIVE_OBJECTIVES:
        raise ValueError(f"unknown adaptive objective {objective!r}; have "
                         f"{ADAPTIVE_OBJECTIVES}")
    if budget < 1:
        raise ValueError(f"adaptive budget must be >= 1, got {budget}")
    agg = differentiable_aggregate(plan)

    def fn(ctx: AttackContext) -> torch.Tensor:
        mu, sigma = _good_sampled_stats(ctx)
        radius = _round_radius(plan, ctx)
        scale = torch.linalg.vector_norm(mu) + 1e-8
        honest = ctx.honest.float()
        good = ctx.good_mask[:, None]
        key = _fixed_order(ctx.key, honest.shape[0])

        def damage(z):
            msgs = torch.where(good, honest, z[None].expand_as(honest))
            out = agg(msgs, mask=ctx.sampled, key=key, radius=radius)
            if objective == "deviation":
                return ((out - mu) ** 2).sum()
            return -(out * mu).sum()

        # warm start from ALIE's statistically plausible shift, then spend
        # the budget climbing the aggregator's own response
        z = mu - 1.5 * sigma
        for _ in range(budget):
            zz = z.detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(damage(zz), zz)
            z = z + lr * scale * g / (torch.linalg.vector_norm(g) + 1e-12)
        return z[None].expand_as(ctx.honest)

    return Attack(name, fn, omniscient=True, adaptive=True)
