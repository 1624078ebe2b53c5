"""Byz-VR-MARINA-PP, Algorithm 1, as an eager PyTorch simulation engine.

The engine runs the server/client protocol over a ``FedProblem``:

  k:  c_k ~ Be(p);  cohort S_k of size C (c_k=0) or C_hat (c_k=1)
      x^{k+1} = x^k - gamma g^k;    lambda_{k+1} = alpha ||x^{k+1} - x^k||
      good i in S_k send  grad f_i(x^{k+1})                (c_k = 1)
                     or   Q(Dhat_i(x^{k+1}, x^k))           (c_k = 0)
      byzantines send attack payloads
      g^{k+1} = ARAgg({g_i})                                (c_k = 1)
              = g^k + ARAgg({clip_lambda(messages)})        (c_k = 0)

Clipping happens at the server, fused into the aggregation on the kernel
backends.  Only the sampled rows enter the mask-aware aggregation.

Compression.  Each client compresses its own difference (Algorithm 1,
line 8): the (n, d) differences go through ``Compressor.rows``, one draw
per row, never through the compressor of the flattened matrix.

Randomness.  Each step draws c_k, the cohort permutation, the (n, batch)
minibatch indices, (difference rounds with a compressor) the (n, d)
compressor uniforms, (an adaptive attack) the adversary's Bucketing
permutation, the attack's own draws (gauss) and the server's Bucketing
permutation from the state's CPU ``torch.Generator``, so a run makes the
same draws on every device.  A ``MarinaPPTape`` replaces every draw by a
recorded one (the reference's, in the parity tests); the tape's bucket
orders are final orders, which Bucketing's stable sampled-first re-sort
leaves as they are.

Scenarios.  ``MarinaPPConfig.scenario``, a ``ScenarioSpec``, wins over
``attack``: ``scenario.build(plan)`` binds the attack's tunables, and the
adaptive kinds gradient-ascend against the engine's own plan.

The step branches on c_k in Python; the iterates, the metrics and the
attack's majority bit stay on the device, and ``run`` fetches the
metrics once at its end.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from .attacks import make_attack
from .compressors import identity as _identity_compressor
from .compressors import make_compressor
from .problems import FedProblem

__all__ = ["MarinaPPConfig", "MarinaPPState", "MarinaPPTape",
           "ByzVRMarinaPP"]


@dataclasses.dataclass(frozen=True)
class MarinaPPConfig:
    gamma: float  # stepsize
    p: float  # Bernoulli full-sync probability
    C: int  # small cohort size
    C_hat: int  # large cohort size (full-grad rounds)
    batch: int = 32  # minibatch size b for Dhat
    # the server-step composition: a repro_torch.api.ServerPlan; None
    # builds the paper's default (CM over Bucketing(2), lambda_k =
    # 1.0 * ||x^{k+1} - x^k||, no compression)
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
class MarinaPPState:
    x: torch.Tensor  # current iterate x^k (d,)
    g: torch.Tensor  # server estimate g^k (d,)
    x0: torch.Tensor  # initial point (for SHB and logging)
    gen: torch.Generator  # the CPU generator of the step draws
    step: int = 0

    @classmethod
    def from_numpy(cls, x, g, x0, step: int = 0, *, seed: int = 1,
                   device=None) -> "MarinaPPState":
        """A state from numpy vectors (e.g. the reference's), with a
        generator seeded ``seed`` for the draws of later steps."""
        dev = resolve_device(device)

        def t(v):
            return torch.from_numpy(np.asarray(v, np.float32).copy()).to(dev)

        return cls(x=t(x), g=t(g), x0=t(x0),
                   gen=torch.Generator().manual_seed(seed), step=int(step))


@dataclasses.dataclass(frozen=True)
class MarinaPPTape:
    """Recorded draws of ``steps`` steps over n clients: ``c`` (steps,)
    bool coins, ``sampled`` (steps, n) bool cohorts, ``batch_idx``
    (steps, n, batch) minibatch indices, ``order`` (steps, n) Bucketing
    row orders, ``g0_order`` (n,) the order of g^0's aggregation, and
    ``q_draws`` (steps, n, d) the compressor's draws of each client (its
    uniforms, or RandK keep masks), needed only with a compressor.  The
    attack's draws: ``attack_noise`` (steps, n, d) the standard normal
    noise of gauss, ``attack_order`` (steps, n) the adaptive adversary's
    Bucketing order; without them the attack draws from the generator."""

    c: np.ndarray
    sampled: np.ndarray
    batch_idx: np.ndarray
    order: np.ndarray
    g0_order: np.ndarray
    q_draws: Optional[np.ndarray] = None
    attack_noise: Optional[np.ndarray] = None
    attack_order: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.c)


def attack_key(attack, gen, tape, k: int, n: int):
    """The attack context's ``key`` at step ``k``: the tape's attack draw
    where it has one (the adaptive adversary's order, else gauss noise);
    else, for an adaptive attack, one Bucketing permutation drawn from
    ``gen`` here, which every ascent step of the round uses, forward and
    backward alike, whatever the budget; else ``gen`` itself, so that a
    registry attack draws as it does without a scenario."""
    if tape is not None:
        draws = tape.attack_order if attack.adaptive else tape.attack_noise
        if draws is not None:
            return torch.tensor(np.asarray(draws[k]))
    if attack.adaptive:
        return torch.randperm(n, generator=gen)
    return gen


class ByzVRMarinaPP:
    """The server-side engine: ``init``, then ``step`` or ``run``.

    ``device`` (None = "cuda") must be the problem's device."""

    def __init__(self, problem: FedProblem, cfg: MarinaPPConfig,
                 device=None):
        self.device = resolve_device(device)
        if problem.device.type != self.device.type:
            raise ValueError(f"the problem is on {problem.device}, the "
                             f"engine on {self.device}")
        if not (1 <= cfg.C <= cfg.C_hat <= problem.n_clients):
            raise ValueError("need 1 <= C <= C_hat <= n")
        self.problem = problem
        self.cfg = cfg
        self.plan = cfg.resolve_plan()
        self.server = self.plan.build()
        self.compressor = self.server.compressor or _identity_compressor()
        from ..scenarios.stage import AttackStage

        # a ScenarioSpec wins over the plain ``attack`` registry name
        self.attack = (cfg.scenario.build(self.plan)
                       if cfg.scenario is not None else make_attack(cfg.attack))
        self.attack_stage = AttackStage(self.attack)
        n = problem.n_clients
        self._good = torch.arange(n, device=self.device) < problem.n_good

    @classmethod
    def from_theory(cls, problem: FedProblem, *, C: int, C_hat: int,
                    p: float, delta: float, theorem: str = "4.1",
                    aggregator: str = "cm", bucket_s: int = 2,
                    attack: str = "none", batch: int = 32,
                    compressor: str = "identity", compressor_kwargs=(),
                    backend: str = "auto", device=None):
        """The engine with the stepsize and clip level of Theorem 4.1 or 4.2
        (``core.theory``) from the problem's smoothness bound; the
        reference's signature, plus ``device`` (None = "cuda")."""
        from ..api import (AggregatorSpec, BucketSpec, ClipSpec, CompressSpec,
                           ScheduleSpec, ServerPlan)
        from .theory import MarinaTheory

        comp = make_compressor(compressor, **dict(compressor_kwargs))
        th = MarinaTheory(
            n=problem.n_clients, G=problem.n_good, C=C, C_hat=C_hat,
            delta=delta, p=p, L=problem.smoothness(),
            omega=comp.omega(problem.dim), d_q=comp.dq(problem.dim) or 1.0)
        comp_spec = None
        if compressor not in ("identity", "none"):
            kw = dict(compressor_kwargs)
            comp_spec = CompressSpec(kind=compressor, k=int(kw.get("k", 1)),
                                     frac=float(kw.get("frac", 0.01)))
        plan = ServerPlan(
            aggregate=AggregatorSpec(aggregator),
            clip=ClipSpec(alpha=th.clip_alpha(theorem)),
            compress=comp_spec,
            bucket=BucketSpec(s=bucket_s) if bucket_s >= 2 else None,
            schedule=ScheduleSpec(backend=backend))
        cfg = MarinaPPConfig(gamma=th.gamma(theorem), p=p, C=C, C_hat=C_hat,
                             batch=batch, plan=plan, attack=attack)
        return cls(problem, cfg, device=device)

    def init(self, x0=None, tape: Optional[MarinaPPTape] = None
             ) -> MarinaPPState:
        """g^0: the aggregate of the initial full gradients of ALL clients,
        in the bucket order drawn from a generator seeded ``cfg.seed``
        (or the tape's ``g0_order``)."""
        x = self.problem.x0 if x0 is None else x0
        key = (torch.tensor(np.asarray(tape.g0_order)) if tape is not None
               else torch.Generator().manual_seed(self.cfg.seed))
        g0 = self.server.aggregate(self.problem.all_full_grads(x), key=key)
        return MarinaPPState(x=x, g=g0, x0=x,
                             gen=torch.Generator().manual_seed(self.cfg.seed + 1))

    # ------------------------------------------------------------------
    def _draws(self, state: MarinaPPState, tape, k: int):
        """(c_k, sampled (n,) bool, batch idx (n, b) or None, compressor
        key, bucket key) on the host: from the tape's step ``k``, or from
        the generator (which the compressor then draws from)."""
        n, cfg = self.problem.n_clients, self.cfg
        if tape is not None:
            c = bool(tape.c[k])
            idx = qkey = None
            if not c:
                idx = torch.tensor(np.asarray(tape.batch_idx[k]))
                if self.compressor.rows_fn is not None:
                    if tape.q_draws is None:
                        raise ValueError(f"the plan compresses with "
                                         f"{self.compressor.name!r}: the "
                                         "tape needs its q_draws")
                    qkey = torch.tensor(np.asarray(tape.q_draws[k]))
            return (c, torch.tensor(np.asarray(tape.sampled[k], bool)), idx,
                    qkey, torch.tensor(np.asarray(tape.order[k])))
        gen = state.gen
        c = bool(torch.rand((), generator=gen) < cfg.p)
        perm = torch.randperm(n, generator=gen)
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(n)
        sampled = rank < (cfg.C_hat if c else cfg.C)
        idx = None if c else torch.randint(0, self.problem.m, (n, cfg.batch),
                                           generator=gen)
        return c, sampled, idx, gen, gen

    def step(self, state: MarinaPPState, tape: Optional[MarinaPPTape] = None
             ) -> tuple:
        """One iteration; returns (next state, c_k)."""
        from ..scenarios.stage import make_context

        prob = self.problem
        dev = self.device
        c, sampled, idx, qkey, key = self._draws(state, tape, state.step)
        sampled = sampled.to(dev)
        x_new = state.x - self.cfg.gamma * state.g
        if c:
            honest = prob.all_full_grads(x_new)
        else:
            # each client compresses its own row, with its own draw
            honest = self.compressor.rows(qkey, prob.all_minibatch_diffs(
                idx.to(dev), x_new, state.x))
        ctx = make_context(honest, good_mask=self._good, sampled=sampled,
                           x_now=x_new, x_prev=state.x, x0=state.x0,
                           g_prev=state.g,
                           key=attack_key(self.attack, state.gen, tape,
                                          state.step, prob.n_clients))
        msgs = self.attack_stage.corrupt(ctx)
        if c:
            g_new = self.server.aggregate(msgs, mask=sampled, key=key)
        else:
            # lambda_{k+1} from the plan's ClipSpec; None without a clip
            # stage, then the server aggregates the raw differences
            lam = self.server.radius(x_new, state.x)
            g_new = state.g + self.server(msgs, mask=sampled, key=key,
                                          radius=lam)
        return MarinaPPState(x=x_new, g=g_new, x0=state.x0, gen=state.gen,
                             step=state.step + 1), c

    # ------------------------------------------------------------------
    def run(self, steps: int, state: Optional[MarinaPPState] = None,
            tape: Optional[MarinaPPTape] = None):
        """Run ``steps`` iterations; returns (state, metrics) with metrics
        ``loss`` and ``grad_norm`` of every iterate (CPU f32 tensors,
        fetched once at the end) and ``full_round``, the coins c_k."""
        if state is None:
            state = self.init(tape=tape)
        if tape is not None and len(tape) < state.step + steps:
            raise ValueError(f"the tape holds {len(tape)} steps, not "
                             f"{state.step + steps}")
        losses, gnorms, coins = [], [], []
        for _ in range(steps):
            state, c = self.step(state, tape)
            losses.append(self.problem.loss(state.x))
            gnorms.append(torch.linalg.vector_norm(self.problem.grad(state.x)))
            coins.append(c)
        metrics = torch.stack([torch.stack(losses), torch.stack(gnorms)]).cpu()
        return state, {"loss": metrics[0], "grad_norm": metrics[1],
                       "full_round": torch.tensor(coins, dtype=torch.bool)}
