"""The heuristic extension (eq. 10): clipping adapts ANY robust method to
partial participation, as an eager PyTorch engine (the counterpart of
``repro.core.heuristic``).

Scheme:   x^{k+1} = x^k - gamma g^k,
          g^k = g^{k-1} + Agg({clip_{lambda_k}(g_i^k - g^{k-1})}_{i in S_k}),
          lambda_k = alpha * ||x^k - x^{k-1}||.

The base method is the paper's choice for neural nets, Byzantine-robust
momentum SGD (Karimireddy et al., 2021): each worker keeps a momentum
m_i^k = beta m_i^{k-1} + (1-beta) grad_i(x^k) on a minibatch and sends
g_i^k = m_i^k; only the sampled workers refresh theirs.  A plan without a
clip stage gives the Fig.-2 "no clip" baselines.  With a data-dependent
``ClipSpec(alpha=)`` step 0 clips at 3.4e37: before the first move
x^0 = x^{-1}, and lambda = 0 would zero every message.

Randomness.  Each step draws the cohort permutation, the (n, batch)
minibatch indices, (an adaptive attack) the adversary's Bucketing
permutation, the attack's own draws (gauss) and the server's Bucketing
permutation from the state's CPU ``torch.Generator``, so a run makes the
same draws on every device.  A ``ClippedPPTape`` replaces every draw by
a recorded one (the reference's, in the parity tests).
``ClippedPPConfig.scenario``, a ``ScenarioSpec``, wins over ``attack``,
as in ``core.marina_pp``.  The iterates and metrics stay on the device, and
``run`` fetches the metrics once at its end.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from .attacks import make_attack
from .marina_pp import attack_key

__all__ = ["ClippedPPConfig", "ClippedPPState", "ClippedPPTape",
           "ClippedPPMomentum"]

_WARMUP_RADIUS = 3.4e37  # lambda at step 0 for ClipSpec(alpha=)


@dataclasses.dataclass(frozen=True)
class ClippedPPConfig:
    gamma: float
    beta: float = 0.9  # client momentum
    C: int = 4  # sampled cohort per round
    batch: int = 32
    # the eq.-(10) server step: a repro_torch.api.ServerPlan; None builds
    # the Fig.-2 default (CM over Bucketing(2), lambda_k = 1.0 *
    # ||x^k - x^{k-1}||)
    plan: Optional[object] = None
    attack: str = "none"
    # a repro_torch.api.ScenarioSpec wins over ``attack`` (the attack's
    # tunables, the adaptive adversary's budget against the plan)
    scenario: Optional[object] = None
    seed: int = 0

    def resolve_plan(self):
        from ..api import AggregatorSpec, BucketSpec, ClipSpec, ServerPlan

        if self.plan is not None:
            return self.plan
        return ServerPlan(aggregate=AggregatorSpec("cm"),
                          clip=ClipSpec(alpha=1.0), bucket=BucketSpec(s=2))


@dataclasses.dataclass
class ClippedPPState:
    x: torch.Tensor  # x^k (d,)
    x_prev: torch.Tensor  # x^{k-1}
    g: torch.Tensor  # server estimate g^{k-1}
    momenta: torch.Tensor  # (n, d) worker momenta
    x0: torch.Tensor
    gen: torch.Generator  # the CPU generator of the step draws
    step: int = 0


@dataclasses.dataclass(frozen=True)
class ClippedPPTape:
    """Recorded draws of ``steps`` steps over n clients: ``sampled``
    (steps, n) bool cohorts, ``batch_idx`` (steps, n, batch) minibatch
    indices, ``order`` (steps, n) Bucketing row orders, ``g0_order``
    (n,) the order of g^0's aggregation, and optionally the attack's
    draws, ``attack_noise`` (steps, n, d) and ``attack_order`` (steps, n),
    as in ``MarinaPPTape``."""

    sampled: np.ndarray
    batch_idx: np.ndarray
    order: np.ndarray
    g0_order: np.ndarray
    attack_noise: Optional[np.ndarray] = None
    attack_order: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.sampled)


class ClippedPPMomentum:
    """Clipped partial-participation wrapper around robust momentum SGD:
    ``init``, then ``step`` or ``run``.  ``device`` (None = "cuda") must be
    the problem's device."""

    def __init__(self, problem, cfg: ClippedPPConfig, device=None):
        self.device = resolve_device(device)
        if problem.device.type != self.device.type:
            raise ValueError(f"the problem is on {problem.device}, the "
                             f"engine on {self.device}")
        if not 1 <= cfg.C <= problem.n_clients:
            raise ValueError("need 1 <= C <= n")
        self.problem = problem
        self.cfg = cfg
        self.plan = cfg.resolve_plan()
        self.server = self.plan.build()
        from ..scenarios.stage import AttackStage

        # a ScenarioSpec wins over the plain ``attack`` registry name
        self.attack = (cfg.scenario.build(self.plan)
                       if cfg.scenario is not None else make_attack(cfg.attack))
        self.attack_stage = AttackStage(self.attack)
        n = problem.n_clients
        self._good = torch.arange(n, device=self.device) < problem.n_good

    def init(self, x0=None, tape: Optional[ClippedPPTape] = None
             ) -> ClippedPPState:
        """g^0: the aggregate of ALL clients' full gradients at x^0, in the
        bucket order drawn from a generator seeded ``cfg.seed`` (or the
        tape's ``g0_order``); the momenta start at those gradients."""
        x = self.problem.x0 if x0 is None else x0
        grads = self.problem.all_full_grads(x)
        key = (torch.tensor(np.asarray(tape.g0_order)) if tape is not None
               else torch.Generator().manual_seed(self.cfg.seed))
        g0 = self.server.aggregate(grads, key=key)
        return ClippedPPState(
            x=x, x_prev=x, g=g0, momenta=grads, x0=x,
            gen=torch.Generator().manual_seed(self.cfg.seed + 1))

    def _draws(self, state: ClippedPPState, tape, k: int):
        """(sampled (n,) bool, batch idx (n, b), bucket key) on the host:
        from the tape's step ``k``, or from the generator."""
        if tape is not None:
            return (torch.tensor(np.asarray(tape.sampled[k], bool)),
                    torch.tensor(np.asarray(tape.batch_idx[k])),
                    torch.tensor(np.asarray(tape.order[k])))
        n, gen = self.problem.n_clients, state.gen
        perm = torch.randperm(n, generator=gen)
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(n)
        idx = torch.randint(0, self.problem.m, (n, self.cfg.batch),
                            generator=gen)
        return rank < self.cfg.C, idx, gen

    def step(self, state: ClippedPPState,
             tape: Optional[ClippedPPTape] = None) -> ClippedPPState:
        from ..scenarios.stage import make_context

        cfg, dev = self.cfg, self.device
        sampled, idx, key = self._draws(state, tape, state.step)
        sampled = sampled.to(dev)
        # workers: minibatch gradients at x^k, momentum refreshed only
        # where sampled (the others are offline)
        grads = self.problem.all_minibatch_grads(idx.to(dev), state.x)
        momenta = cfg.beta * state.momenta + (1.0 - cfg.beta) * grads
        momenta = torch.where(sampled[:, None], momenta, state.momenta)
        # lambda_k from the plan's ClipSpec (None without a clip stage); a
        # static ClipSpec(radius=) applies from step 0
        lam = self.server.radius(state.x, state.x_prev)
        if (lam is not None and self.plan.clip.radius is None
                and state.step == 0):
            lam = _WARMUP_RADIUS
        ctx = make_context(momenta, good_mask=self._good, sampled=sampled,
                           x_now=state.x, x_prev=state.x_prev, x0=state.x0,
                           g_prev=state.g,
                           key=attack_key(self.attack, state.gen, tape,
                                          state.step, self.problem.n_clients))
        diffs = self.attack_stage.corrupt(ctx) - state.g[None]
        # eq. (10): aggregate the clipped differences to the last estimate
        if lam is not None:
            g_new = state.g + self.server(diffs, mask=sampled, key=key,
                                          radius=lam)
        else:
            g_new = state.g + self.server.aggregate(diffs, mask=sampled,
                                                    key=key)
        return ClippedPPState(x=state.x - cfg.gamma * g_new, x_prev=state.x,
                              g=g_new, momenta=momenta, x0=state.x0,
                              gen=state.gen, step=state.step + 1)

    def run(self, steps: int, state: Optional[ClippedPPState] = None,
            tape: Optional[ClippedPPTape] = None):
        """Run ``steps`` iterations; returns (state, metrics) with metrics
        ``loss`` and ``grad_norm`` of every iterate (CPU f32 tensors,
        fetched once at the end)."""
        if state is None:
            state = self.init(tape=tape)
        if tape is not None and len(tape) < state.step + steps:
            raise ValueError(f"the tape holds {len(tape)} steps, not "
                             f"{state.step + steps}")
        losses, gnorms = [], []
        for _ in range(steps):
            state = self.step(state, tape)
            losses.append(self.problem.loss(state.x))
            gnorms.append(torch.linalg.vector_norm(self.problem.grad(state.x)))
        metrics = torch.stack([torch.stack(losses), torch.stack(gnorms)]).cpu()
        return state, {"loss": metrics[0], "grad_norm": metrics[1]}
