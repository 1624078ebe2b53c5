"""The port's scenario engine (``repro_torch.scenarios``, ``ScenarioSpec``
and ``scenario=`` in both engines) against the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through both packages.  The
reference draws its randomness from ``jax.random``; where a test needs
its draws the tape records them from its key schedule: per step the
cohort, minibatch and Bucketing draws of ``tests/test_torch_engine.py``
and ``tests/test_torch_heuristic.py``, plus the attack key ``k_att``'s
draws, the gauss noise ``normal(k_att, (n, d))`` and the adaptive
adversary's Bucketing order ``_bucket_order(k_att, sampled, n)``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as T
from repro.configs.paper import fig1_marina_pp as ref_fig1
from repro.configs.paper import fig1_problem_kwargs as ref_fig1_kwargs
from repro.core import ByzVRMarinaPP as RefMarina
from repro.core import ClippedPPConfig as RefClippedConfig
from repro.core import ClippedPPMomentum as RefClipped
from repro.core import logistic_problem as ref_logistic_problem
from repro.core import mlp_problem as ref_mlp_problem
from repro.core.aggregators import _bucket_order as ref_bucket_order
from repro.scenarios import differentiable_aggregate as ref_diff_agg
from repro.scenarios import make_context as ref_make_context
from repro.scenarios import run_cell as ref_run_cell
from repro.scenarios.matrix import SMOKE_GRID as REF_SMOKE_GRID
from repro.scenarios.matrix import _fstar_cache as ref_fstar_cache
from repro_torch import attack_grid
from repro_torch.configs.paper import fig1_marina_pp
from repro_torch.core import (
    ByzVRMarinaPP,
    ClippedPPConfig,
    ClippedPPMomentum,
    ClippedPPTape,
    MarinaPPTape,
    logistic_problem,
    mlp_problem_from_numpy,
    problem_from_numpy,
)
from repro_torch.core.aggregators import Aggregator
from repro_torch.kernels import ops
from repro_torch.launch.cli import add_attack_args, scenario_from_args
from repro_torch.scenarios import (
    ADAPTIVE_OBJECTIVES,
    SMOKE_GRID,
    AttackStage,
    MatrixGrid,
    append_resilience,
    breakdown_points,
    differentiable_aggregate,
    make_adaptive_attack,
    make_context,
    run_cell,
    torch_shadow_plan,
)
from repro_torch.scenarios import matrix as tmatrix
from repro_torch.scenarios.adaptive import KernelForward

RULES = ("mean", "cm", "trimmed_mean", "rfa", "centered_clip")
N, D = 12, 8


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _plans(rule, *, clip, bucket, backend="torch", radius=None, alpha=None,
           byz_bound=4):
    """(reference plan, port plan) of one configuration; CenteredClip at
    tau = 1 so that its inner clip acts on these inputs."""
    out = []
    for api, be in ((R, "jnp"), (T, backend)):
        clip_spec = None
        if clip:
            clip_spec = api.ClipSpec(radius=radius) if radius is not None \
                else api.ClipSpec(alpha=alpha if alpha else 1.0)
        out.append(api.ServerPlan(
            aggregate=api.AggregatorSpec(
                rule, byz_bound=byz_bound,
                tau=1.0 if rule == "centered_clip" else 10.0),
            clip=clip_spec,
            bucket=api.BucketSpec(s=2) if bucket else None,
            schedule=api.ScheduleSpec(backend=be)))
    return out


def _msgs(seed, n=N, d=D):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:8]] = True
    ct = rng.randn(d).astype(np.float32)
    return x, mask, ct


def _ref_order(key_seed, mask, n):
    return np.array(ref_bucket_order(jax.random.PRNGKey(key_seed),
                                     jnp.asarray(mask), n))


def _ctx_arrays(n=N, n_byz=4, d=D, seed=3):
    """The reference's pinned context (tests/test_scenarios.py ``_ctx``)."""
    rng = np.random.RandomState(seed)
    mu = (0.1 * rng.randn(d)).astype(np.float32)
    honest = mu[None] + 0.05 * rng.randn(n, d).astype(np.float32)
    return honest, np.arange(n) < n - n_byz


def _port_ctx(honest, good, key, sampled=None, **iterates):
    n = honest.shape[0]
    sampled = np.ones(n, bool) if sampled is None else sampled
    return make_context(
        torch.from_numpy(honest), good_mask=torch.from_numpy(good),
        sampled=torch.from_numpy(sampled), key=key,
        **{k: torch.from_numpy(v) for k, v in iterates.items()})


def _ref_ctx(honest, good, key_seed, sampled=None, **iterates):
    n = honest.shape[0]
    sampled = np.ones(n, bool) if sampled is None else sampled
    return ref_make_context(
        jnp.asarray(honest), good_mask=jnp.asarray(good),
        sampled=jnp.asarray(sampled), key=jax.random.PRNGKey(key_seed),
        **{k: jnp.asarray(v) for k, v in iterates.items()})


# ---------------------------------------------------------------------------
# ScenarioSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad, match", [
    (dict(attack="zzz"), "unknown scenario attack"),
    (dict(attack="bf", byz_frac=1.5), "byz_frac"),
    (dict(attack="adaptive", budget=0), "budget"),
    (dict(attack="adaptive", objective="chaos"), "objective"),
    (dict(attack="alie", z_max=0.0), "z_max"),
])
def test_scenario_spec_validates_as_the_reference(bad, match):
    with pytest.raises(R.PlanError, match=match):
        R.ScenarioSpec(**bad)
    with pytest.raises(T.PlanError, match=match):
        T.ScenarioSpec(**bad)


@pytest.mark.parametrize("kw", [
    dict(attack="adaptive", budget=3, lr=0.25, objective="descent"),
    dict(attack="autogm", byz_frac=0.2),
    dict(attack="gauss", scale=2.0),
])
def test_scenario_spec_json_round_trips_between_packages(kw):
    doc = R.ScenarioSpec(**kw).to_json()
    spec = T.ScenarioSpec.from_json(doc)
    assert spec.to_json() == doc
    assert R.ScenarioSpec.from_json(spec.to_json()) == R.ScenarioSpec(**kw)


def test_adaptive_spec_builds_against_a_plan_and_needs_one():
    _, plan = _plans("cm", clip=True, bucket=True, radius=0.5)
    for kind in ("adaptive", "autogm"):
        with pytest.raises(T.PlanError, match="pass the ServerPlan"):
            T.ScenarioSpec(attack=kind).build()
        attack = T.ScenarioSpec(attack=kind, budget=2).build(plan)
        assert attack.name == kind and attack.adaptive and attack.omniscient
    assert ADAPTIVE_OBJECTIVES == ("deviation", "descent")
    with pytest.raises(ValueError, match="objective"):
        make_adaptive_attack(plan, objective="chaos")
    with pytest.raises(ValueError, match="budget"):
        make_adaptive_attack(plan, budget=0)


def test_autogm_forces_descent():
    """autogm is the descent objective whatever the spec's objective."""
    honest, good = _ctx_arrays()
    _, plan = _plans("cm", clip=True, bucket=False, radius=0.5)
    ctx = _port_ctx(honest, good, None)
    auto = T.ScenarioSpec(attack="autogm", objective="deviation",
                          budget=4).build(plan)(ctx)
    desc = make_adaptive_attack(plan, budget=4, objective="descent")(ctx)
    torch.testing.assert_close(auto, desc, rtol=0, atol=0)


def test_cli_flags_round_trip_the_scenario():
    import argparse

    ap = argparse.ArgumentParser()
    add_attack_args(ap)
    args = ap.parse_args(["--attack", "autogm", "--budget", "3", "--lr",
                          "0.25", "--objective", "descent", "--byz-frac",
                          "0.2", "--z-max", "2.0"])
    spec = scenario_from_args(args)
    assert spec == T.ScenarioSpec(attack="autogm", budget=3, lr=0.25,
                                  objective="descent", byz_frac=0.2,
                                  z_max=2.0)
    assert "adaptive" in ap.format_help()


def test_shadow_plan_is_plain_naive_and_uncompressed():
    plan = T.ServerPlan(aggregate="rfa", compress=T.CompressSpec("rand_k", k=2),
                        schedule=T.ScheduleSpec(backend="cuda"))
    shadow = torch_shadow_plan(plan)
    assert shadow.schedule.backend == "torch"
    assert shadow.schedule.placement == "naive" and shadow.compress is None
    assert shadow.aggregate == plan.aggregate and shadow.clip == plan.clip


# ---------------------------------------------------------------------------
# differentiable_aggregate: the payload gradient against the reference's
# ---------------------------------------------------------------------------

_GRAD_CASES = [(rule, clip, bucket) for rule in RULES
               for clip in (True, False) for bucket in (False, True)]
_GRAD_CASES += [("krum", False, False), ("krum", False, True)]


@pytest.mark.parametrize("rule, clip, bucket", _GRAD_CASES)
def test_gradient_matches_reference_jax_grad(rule, clip, bucket):
    """The port's torch.autograd gradient of <Agg(clip(msgs)), w> against
    the reference's jax.grad through its jnp shadow, on the Bucketing
    order the reference derives from its key: rtol 1e-5 (atol 1e-7
    against gradients of order 0.1-1).  Krum runs without a clip only:
    the two packages clip Krum by different algebra (ROADMAP queue 3)."""
    x, mask, w = _msgs(7)
    radius = 2.0
    rplan, plan = _plans(rule, clip=clip, bucket=bucket, radius=radius)
    rad = radius if clip else None
    order = _ref_order(11, mask, N)

    def ref_damage(m):
        out = ref_diff_agg(rplan)(m, mask=jnp.asarray(mask),
                                  key=jax.random.PRNGKey(11),
                                  radius=None if rad is None
                                  else jnp.float32(rad))
        return jnp.vdot(out, jnp.asarray(w))

    want = np.asarray(jax.grad(ref_damage)(jnp.asarray(x)))
    m = torch.from_numpy(x).requires_grad_(True)
    out = differentiable_aggregate(plan)(
        m, mask=torch.from_numpy(mask), key=torch.from_numpy(order),
        radius=rad)
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), m)
    assert np.isfinite(got.numpy()).all() and float(got.abs().sum()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    # the forward too
    ref_out = ref_diff_agg(rplan)(jnp.asarray(x), mask=jnp.asarray(mask),
                                  key=jax.random.PRNGKey(11),
                                  radius=None if rad is None
                                  else jnp.float32(rad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rule", ["cm", "rfa", "centered_clip"])
def test_gradient_finite_at_zero_rows_and_zero_radius(rule):
    """Zero rows (a clip factor's norm at 0) and a zero radius (the
    heuristic's adversary at step 0) give finite gradients."""
    x, mask, w = _msgs(8)
    x[:3] = 0.0
    _, plan = _plans(rule, clip=True, bucket=True, radius=1.0)
    for radius in (1.0, 0.0):
        m = torch.from_numpy(x).requires_grad_(True)
        out = differentiable_aggregate(plan)(
            m, mask=torch.from_numpy(mask),
            key=torch.Generator().manual_seed(0), radius=radius)
        (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), m)
        assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# the Function's wiring (the kernels' plain versions as the stand-in forward)
# ---------------------------------------------------------------------------

@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """Every non-"torch" aggregator takes its kernel path on the CPU,
    where each kernel wrapper runs its plain version: the Function's
    forward then runs under no_grad as on the card."""
    monkeypatch.setattr(Aggregator, "uses_kernels",
                        lambda self, xs: self.backend != "torch")


@pytest.mark.parametrize("rule, clip, bucket", [
    ("cm", True, True), ("mean", False, False), ("rfa", True, True),
    ("centered_clip", True, False), ("trimmed_mean", False, True)])
def test_kernel_forward_pairs_with_the_plain_backward(kernels_on_cpu, rule,
                                                      clip, bucket):
    """Through the Function the gradient equals the direct plain
    gradient, the result always carries a gradient, and a generator key
    is drawn once so that forward and backward share one order."""
    x, mask, w = _msgs(9)
    _, plan = _plans(rule, clip=clip, bucket=bucket, backend="cuda",
                     radius=2.0)
    _, plain = _plans(rule, clip=clip, bucket=bucket, backend="torch",
                      radius=2.0)
    order = torch.from_numpy(_ref_order(3, mask, N))
    rad = 2.0 if clip else None
    grads = []
    for p in (plan, plain):
        m = torch.from_numpy(x).requires_grad_(True)
        out = differentiable_aggregate(p)(m, mask=torch.from_numpy(mask),
                                          key=order, radius=rad)
        assert out.requires_grad and out.grad_fn is not None
        assert (type(out.grad_fn).__name__ == "KernelForwardBackward") == (
            p is plan)
        (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), m)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    m = torch.from_numpy(x).requires_grad_(True)
    out = differentiable_aggregate(plan)(
        m, mask=torch.from_numpy(mask), key=torch.Generator().manual_seed(4),
        radius=rad)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), m)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0


def test_kernel_path_refuses_a_tensor_that_records_a_gradient(kernels_on_cpu):
    """The kernels build no graph: handing them a grad-recording tensor
    raises instead of returning a result without a gradient."""
    x, mask, _ = _msgs(10)
    _, plan = _plans("cm", clip=True, bucket=True, backend="cuda", radius=2.0)
    step = plan.build()
    m = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(ValueError, match="no autograd graph"):
        step(m, mask=torch.from_numpy(mask), radius=2.0)
    with pytest.raises(ValueError, match="no autograd graph"):
        step.aggregate(m, mask=torch.from_numpy(mask))
    with torch.no_grad():
        step(m, mask=torch.from_numpy(mask), radius=2.0)


def test_kernel_forward_direct_apply():
    """KernelForward alone: the forward's value, the backward's gradient."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    out = KernelForward.apply(x, lambda m: 3.0 * m.sum(0),
                              lambda m: (m * m).sum(0))
    torch.testing.assert_close(out, 3.0 * x.detach().sum(0))
    (g,) = torch.autograd.grad(out.sum(), x)
    torch.testing.assert_close(g, 2.0 * x.detach())


def test_cuda_backend_on_a_cpu_tensor_raises():
    """Nothing falls back: a "cuda" plan on a CPU tensor raises."""
    x, mask, _ = _msgs(12)
    _, plan = _plans("cm", clip=True, bucket=False, backend="cuda",
                     radius=2.0)
    with pytest.raises(ValueError, match="backend 'cuda'"):
        differentiable_aggregate(plan)(
            torch.from_numpy(x).requires_grad_(True),
            mask=torch.from_numpy(mask), key=None, radius=2.0)


# ---------------------------------------------------------------------------
# make_adaptive_attack against the reference's
# ---------------------------------------------------------------------------

_PAYLOAD_CASES = [("cm", True, True), ("cm", False, False),
                  ("mean", False, False), ("rfa", True, True),
                  ("centered_clip", True, False), ("trimmed_mean", True, True)]


@pytest.mark.parametrize("objective", ["deviation", "descent"])
@pytest.mark.parametrize("rule, clip, bucket", _PAYLOAD_CASES)
def test_adaptive_payload_matches_reference(rule, clip, bucket, objective):
    """The same context (half the cohort sampled, the iterates set so
    that the ClipSpec(alpha) radius acts), the reference's adversary
    order: the payloads agree to rtol 1e-4."""
    honest, good = _ctx_arrays()
    rng = np.random.RandomState(5)
    sampled = np.zeros(N, bool)
    sampled[rng.permutation(N)[:8]] = True
    x_now = (0.1 * rng.randn(D)).astype(np.float32)
    x_prev = np.zeros(D, np.float32)
    rplan, plan = _plans(rule, clip=clip, bucket=bucket, alpha=0.5)
    ref = R.ScenarioSpec(attack="adaptive", budget=8,
                         objective=objective).build(rplan)
    want = np.asarray(ref(_ref_ctx(honest, good, 2, sampled, x_now=x_now,
                                   x_prev=x_prev)))
    order = torch.from_numpy(_ref_order(2, sampled, N))
    got = T.ScenarioSpec(attack="adaptive", budget=8,
                         objective=objective).build(plan)(
        _port_ctx(honest, good, order, sampled, x_now=x_now, x_prev=x_prev))
    assert got.shape == (N, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def _adaptive_deviation(rule, *, clip, backend, budget=16, radius=0.5):
    """The reference pin's measure: the aggregate's distance from the good
    mean under the adversary optimised against THIS plan."""
    honest, good = _ctx_arrays()
    n_byz = int((~good).sum())
    plan = T.ServerPlan(
        aggregate=T.AggregatorSpec(rule, byz_bound=n_byz),
        clip=T.ClipSpec(radius=radius) if clip else None,
        schedule=T.ScheduleSpec(backend=backend))
    ctx = _port_ctx(honest, good, torch.Generator().manual_seed(1))
    attack = T.ScenarioSpec(attack="adaptive", budget=budget).build(plan)
    msgs = AttackStage(attack).corrupt(ctx)
    out = plan.build()(msgs, mask=ctx.sampled, key=ctx.key)
    return float(torch.linalg.vector_norm(
        out - torch.from_numpy(honest[good]).mean(0)))


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_adaptive_degrades_mean_but_not_robust_plus_clip(backend):
    """The reference's acceptance pin (tests/test_scenarios.py), mirrored:
    under the same budget the adversary drags a plain-mean server far off
    the good mean, while each robust rule with clipping stays close."""
    dev_mean = _adaptive_deviation("mean", clip=False, backend=backend)
    assert dev_mean > 0.6
    for rule in ("cm", "rfa", "centered_clip"):
        dev = _adaptive_deviation(rule, clip=True, backend=backend)
        assert dev < 0.3, (rule, dev)
        assert dev_mean > 2.5 * dev, (rule, dev_mean, dev)


def test_adaptive_draws_one_order_from_a_generator_key():
    """A generator key is drawn from once a round (one permutation),
    whatever the budget."""
    honest, good = _ctx_arrays()
    _, plan = _plans("cm", clip=True, bucket=True, radius=0.5)
    counts = []
    for budget in (1, 5):
        gen = torch.Generator().manual_seed(0)
        make_adaptive_attack(plan, budget=budget)(_port_ctx(honest, good, gen))
        counts.append(torch.randint(0, 1 << 30, (1,), generator=gen).item())
    assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# the engines on the reference's tape
# ---------------------------------------------------------------------------

def _record_marina(cfg, n, m, d, steps):
    """The reference Algorithm-1 engine's draws (tests/test_torch_engine.py
    ``_record_tape``) plus the attack key's: gauss noise and the adaptive
    adversary's Bucketing order."""

    def one(key, _):
        key, k_bern, k_cohort, k_q, k_att, k_agg = jax.random.split(key, 6)
        c = jax.random.bernoulli(k_bern, cfg.p)
        perm = jax.random.permutation(k_cohort, n)
        rank = jnp.zeros((n,), jnp.int32).at[perm].set(
            jnp.arange(n, dtype=jnp.int32))
        sampled = rank < jnp.where(c, cfg.C_hat, cfg.C)
        idx = jax.vmap(lambda k: jax.random.randint(k, (cfg.batch,), 0, m))(
            jax.random.split(k_q, n))
        return key, (c, sampled, idx, ref_bucket_order(k_agg, sampled, n),
                     jax.random.normal(k_att, (n, d), jnp.float32),
                     ref_bucket_order(k_att, sampled, n))

    _, (c, sampled, idx, order, noise, att) = jax.lax.scan(
        one, jax.random.PRNGKey(cfg.seed + 1), None, length=steps)
    return MarinaPPTape(
        c=np.asarray(c), sampled=np.asarray(sampled),
        batch_idx=np.asarray(idx), order=np.asarray(order),
        g0_order=np.asarray(jax.random.permutation(
            jax.random.PRNGKey(cfg.seed), n)),
        attack_noise=np.asarray(noise), attack_order=np.asarray(att))


def _record_clipped(cfg, n, m, d, steps):
    """The reference heuristic engine's draws
    (tests/test_torch_heuristic.py ``_record_tape``) plus the attack
    key's."""

    def one(key, _):
        key, k_cohort, k_b, k_att, k_agg = jax.random.split(key, 5)
        perm = jax.random.permutation(k_cohort, n)
        rank = jnp.zeros((n,), jnp.int32).at[perm].set(
            jnp.arange(n, dtype=jnp.int32))
        sampled = rank < cfg.C
        idx = jax.vmap(lambda k: jax.random.randint(k, (cfg.batch,), 0, m))(
            jax.random.split(k_b, n))
        return key, (sampled, idx, ref_bucket_order(k_agg, sampled, n),
                     jax.random.normal(k_att, (n, d), jnp.float32),
                     ref_bucket_order(k_att, sampled, n))

    _, (sampled, idx, order, noise, att) = jax.lax.scan(
        one, jax.random.PRNGKey(cfg.seed + 1), None, length=steps)
    return ClippedPPTape(
        sampled=np.asarray(sampled), batch_idx=np.asarray(idx),
        order=np.asarray(order),
        g0_order=np.asarray(jax.random.permutation(
            jax.random.PRNGKey(cfg.seed), n)),
        attack_noise=np.asarray(noise), attack_order=np.asarray(att))


@pytest.fixture(scope="module")
def fig1():
    kw = ref_fig1_kwargs()
    ref_prob = ref_logistic_problem(jax.random.PRNGKey(0), **kw)
    prob = problem_from_numpy(
        np.asarray(ref_prob.features[0]), np.asarray(ref_prob.labels[0]),
        np.asarray(ref_prob.x0), n_good=ref_prob.n_good, l2=ref_prob.l2,
        n_clients=ref_prob.n_clients, device="cpu")
    tape = _record_marina(ref_fig1(True), ref_prob.n_clients, ref_prob.m,
                          ref_prob.dim, 300)
    return ref_prob, prob, tape


def _ref_losses(algo, steps):
    _, met = jax.jit(lambda s: algo.run(steps, s))(algo.init())
    return np.asarray(met["loss"])


@pytest.mark.parametrize("attack, clip", [("alie", True), ("alie", False),
                                          ("shb", True), ("gauss", True)])
def test_fig1_scenario_trajectory_matches_reference(fig1, attack, clip):
    """``scenario=ScenarioSpec(attack)`` in Fig. 1 on the reference's draws
    (gauss with its noise on the tape): the losses agree to 1e-5 abs
    over 300 steps."""
    ref_prob, prob, tape = fig1
    rcfg = dataclasses.replace(ref_fig1(clip),
                               scenario=R.ScenarioSpec(attack=attack))
    want = _ref_losses(RefMarina(ref_prob, rcfg), 300)
    cfg = dataclasses.replace(fig1_marina_pp(clip),
                              scenario=T.ScenarioSpec(attack=attack))
    _, met = ByzVRMarinaPP(prob, cfg, device="cpu").run(300, tape=tape)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(met["loss"].numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("clip", [True, False])
def test_fig1_adaptive_trajectory_matches_reference(fig1, clip):
    """The adaptive adversary (budget 8) in Fig. 1 on the reference's
    draws, its Bucketing order from the tape: 50 steps within rtol 1e-4."""
    ref_prob, prob, tape = fig1
    spec = dict(attack="adaptive", budget=8)
    rcfg = dataclasses.replace(ref_fig1(clip),
                               scenario=R.ScenarioSpec(**spec))
    want = _ref_losses(RefMarina(ref_prob, rcfg), 50)
    cfg = dataclasses.replace(fig1_marina_pp(clip),
                              scenario=T.ScenarioSpec(**spec))
    _, met = ByzVRMarinaPP(prob, cfg, device="cpu").run(50, tape=tape)
    np.testing.assert_allclose(met["loss"].numpy(), want, rtol=1e-4, atol=0)


SMALL_FIG2 = dict(n_clients=20, n_good=15, m=64, in_dim=4, hidden=4,
                  n_classes=4, heterogeneous=True)


@pytest.mark.parametrize("rule", ["rfa", "cm"])
def test_small_fig2_adaptive_trajectory_matches_reference(rule):
    """The heuristic engine under the adaptive adversary (budget 8) on a
    small Fig. 2 problem (d = 40, over Bucketing(2), clipped) on the
    reference's draws: 50 steps within rtol 1e-4."""
    ref_prob = ref_mlp_problem(jax.random.PRNGKey(0), **SMALL_FIG2)
    assert ref_prob.dim <= 64
    prob = mlp_problem_from_numpy(
        np.asarray(ref_prob.features), np.asarray(ref_prob.labels),
        np.asarray(ref_prob.x0), n_good=ref_prob.n_good,
        hidden=SMALL_FIG2["hidden"], n_classes=SMALL_FIG2["n_classes"],
        device="cpu")
    rplan, plan = _plans(rule, clip=True, bucket=True, alpha=1.0,
                         byz_bound=None)
    spec = dict(attack="adaptive", budget=8)
    rcfg = RefClippedConfig(gamma=0.1, C=4, plan=rplan,
                            scenario=R.ScenarioSpec(**spec))
    want = _ref_losses(RefClipped(ref_prob, rcfg), 50)
    tape = _record_clipped(rcfg, ref_prob.n_clients, ref_prob.m,
                           ref_prob.dim, 50)
    cfg = ClippedPPConfig(gamma=0.1, C=4, plan=plan,
                          scenario=T.ScenarioSpec(**spec))
    _, met = ClippedPPMomentum(prob, cfg, device="cpu").run(50, tape=tape)
    np.testing.assert_allclose(met["loss"].numpy(), want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("attack", ["gauss", "shb", "alie"])
@pytest.mark.parametrize("engine", ["marina", "clipped"])
def test_non_adaptive_scenario_keeps_todays_draws(attack, engine):
    """On the port's own generator a registry scenario makes exactly the
    draws of the plain ``attack=`` name: the same losses, bit for bit,
    and the generator left in the same state."""
    if engine == "marina":
        prob = logistic_problem(0, device="cpu", n_clients=12, n_good=9,
                                m=50, dim=10)
        base = dataclasses.replace(fig1_marina_pp(True), C_hat=12,
                                   attack=attack)
        make = ByzVRMarinaPP
    else:
        from repro_torch.core import mlp_problem

        prob = mlp_problem(0, device="cpu", **SMALL_FIG2)
        base = ClippedPPConfig(gamma=0.1, C=4, attack=attack)
        make = ClippedPPMomentum
    runs = []
    for cfg in (base, dataclasses.replace(
            base, attack="none", scenario=T.ScenarioSpec(attack=attack))):
        state, met = make(prob, cfg, device="cpu").run(20)
        runs.append((met["loss"], torch.randint(
            0, 1 << 30, (4,), generator=state.gen)))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert torch.equal(runs[0][1], runs[1][1])


def test_adaptive_run_on_own_draws_is_budget_independent_in_its_draws():
    """The adversary draws one order a round from the engine's generator,
    whatever its budget: the coins and cohorts of two budgets match."""
    prob = logistic_problem(0, device="cpu", n_clients=12, n_good=9, m=50,
                            dim=10)
    coins, gens = [], []
    for budget in (1, 3):
        cfg = dataclasses.replace(
            fig1_marina_pp(True), C_hat=12,
            scenario=T.ScenarioSpec(attack="adaptive", budget=budget))
        state, met = ByzVRMarinaPP(prob, cfg, device="cpu").run(15)
        assert torch.isfinite(met["loss"]).all()
        coins.append(met["full_round"])
        gens.append(torch.randint(0, 1 << 30, (4,), generator=state.gen))
    assert torch.equal(coins[0], coins[1]) and torch.equal(gens[0], gens[1])


def test_engines_accept_every_scenario_attack():
    """Both engines build every registry attack and the adaptive kinds as a
    ScenarioSpec, and take a step with each."""
    from repro_torch.core import mlp_problem
    from repro_torch.core.attacks import ATTACKS

    lp = logistic_problem(0, device="cpu", n_clients=12, n_good=9, m=40,
                          dim=6)
    mp = mlp_problem(0, device="cpu", **SMALL_FIG2)
    for kind in sorted(ATTACKS) + ["adaptive", "autogm"]:
        spec = T.ScenarioSpec(attack=kind, budget=2)
        m = ByzVRMarinaPP(lp, dataclasses.replace(
            fig1_marina_pp(True), C_hat=12, scenario=spec), device="cpu")
        c = ClippedPPMomentum(mp, ClippedPPConfig(gamma=0.1, scenario=spec),
                              device="cpu")
        for algo in (m, c):
            assert algo.attack.name == kind
            _, met = algo.run(3)
            assert torch.isfinite(met["loss"]).all()


# ---------------------------------------------------------------------------
# the resilience matrix
# ---------------------------------------------------------------------------

def test_breakdown_points_reduce_curves():
    cells = [
        {"key": "a", "byz_frac": 0.45, "converged": False},
        {"key": "a", "byz_frac": 0.1, "converged": True},
        {"key": "a", "byz_frac": 0.25, "converged": False},
        {"key": "b", "byz_frac": 0.1, "converged": True},
        {"key": "b", "byz_frac": 0.25, "converged": True},
    ]
    assert breakdown_points(cells) == {"a": 0.25, "b": 1.0}


def test_run_cell_validates_the_clip_axis_and_runs():
    with pytest.raises(ValueError, match="clip axis"):
        run_cell(SMOKE_GRID, rule="cm", attack="shb", byz_frac=0.1,
                 participation=0.2, clip="sometimes", device="cpu")
    grid = dataclasses.replace(SMOKE_GRID, steps=20)
    c = run_cell(grid, rule="cm", attack="adaptive", byz_frac=0.25,
                 participation=0.2, clip="clip", device="cpu")
    assert c["key"] == "cm.adaptive.clip.C4.none" and c["n_byz"] == 5
    assert np.isfinite(c["gap"]) and isinstance(c["converged"], bool)
    with pytest.raises(ValueError, match="matrix compressor"):
        run_cell(grid, rule="cm", attack="shb", byz_frac=0.1,
                 participation=0.2, compressor="topk", device="cpu")


def test_smoke_grid_matches_the_reference():
    assert SMOKE_GRID.to_dict() == REF_SMOKE_GRID.to_dict()
    assert MatrixGrid().to_dict() == REF_SMOKE_GRID.to_dict()


@pytest.fixture(scope="module")
def ref_fstar():
    return ref_fstar_cache()


@pytest.mark.parametrize("rule, attack, clip, frac", [
    ("cm", "shb", "clip", 0.45), ("cm", "shb", "noclip", 0.45),
    ("mean", "shb", "clip", 0.45), ("mean", "shb", "noclip", 0.45),
    ("cm", "gauss", "clip", 0.25)])
def test_matrix_cell_on_reference_draws_matches_reference(ref_fstar, rule,
                                                          attack, clip, frac):
    """A SMOKE_GRID cell on the reference's draws and data (gauss with its
    noise on the tape): the port's gap equals the reference's run_cell
    within rtol 1e-5, and the verdict is the same."""
    grid = SMOKE_GRID
    n = grid.n_clients
    n_good = n - int(round(frac * n))
    want = ref_run_cell(REF_SMOKE_GRID, rule=rule, attack=attack,
                        byz_frac=frac, participation=0.2, clip=clip,
                        fstar=ref_fstar)
    ref_prob = ref_logistic_problem(
        jax.random.PRNGKey(grid.seed), n_clients=n, n_good=n_good, m=grid.m,
        dim=grid.dim, homogeneous=True)
    prob = problem_from_numpy(
        np.asarray(ref_prob.features[0]), np.asarray(ref_prob.labels[0]),
        np.asarray(ref_prob.x0), n_good=n_good, l2=ref_prob.l2,
        n_clients=n, device="cpu")
    cfg = dataclasses.replace(ref_fig1(True), C=4, C_hat=n, seed=grid.seed + 1,
                              batch=grid.batch, p=grid.p)
    tape = _record_marina(cfg, n, grid.m, grid.dim, grid.steps)
    got = run_cell(grid, rule=rule, attack=attack, byz_frac=frac,
                   participation=0.2, clip=clip,
                   fstar=tmatrix._fstar_cache(), device="cpu", tape=tape,
                   problem=prob)
    assert got["key"] == want["key"] and got["n_byz"] == want["n_byz"]
    assert got["converged"] == want["converged"]
    np.testing.assert_allclose(got["gap"], want["gap"], rtol=1e-5)


def test_matrix_main_writes_its_own_json(tmp_path, capsys):
    out = tmp_path / "res.json"
    out.write_text(json.dumps({"other": 1}))
    res = tmatrix.main(["--rules", "cm", "--attacks", "shb", "--clips",
                        "clip", "--byz-fracs", "0.1", "--steps", "10",
                        "--device", "cpu", "--json-out", str(out)])
    doc = json.loads(out.read_text())
    assert doc["other"] == 1 and doc["resilience"] == json.loads(
        json.dumps(res))
    assert list(res["breakdown"]) == ["cm.shb.clip.C4.none"]
    assert "breakdown points" in capsys.readouterr().out
    with pytest.raises(ValueError, match="BENCH_kernels.json"):
        append_resilience(str(tmp_path / "BENCH_kernels.json"), res)
    fresh = tmp_path / "fresh.json"
    append_resilience(str(fresh), res)
    assert json.loads(fresh.read_text()) == {"resilience": json.loads(
        json.dumps(res))}


def test_attack_grid_shim_runs_on_the_cpu(capsys):
    res = attack_grid.main(["--steps", "10", "--rules", "cm", "--attacks",
                            "alie", "--device", "cpu"])
    assert set(res["breakdown"]) == {"cm.alie.clip.C4.none",
                                     "cm.alie.noclip.C4.none"}
    assert "breakdown points" in capsys.readouterr().out


def test_matrix_entry_points_run_on_the_card_by_default(monkeypatch):
    """Without ``device`` the matrix runs on the card, and raises where
    there is none."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.cuda_available.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_cell(SMOKE_GRID, rule="cm", attack="shb", byz_frac=0.1,
                     participation=0.2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            attack_grid.main(["--steps", "2"])
    finally:
        _build.cuda_available.cache_clear()


def test_no_kernel_launches_on_the_cpu():
    """The CPU path runs plain versions only."""
    ops.reset_launch_counts()
    _adaptive_deviation("cm", clip=True, backend="auto", budget=2)
    assert sum(ops.launch_counts().values()) == 0
