"""The port's Fig. 2 path (the eq.-10 heuristic, ``ClippedPPMomentum`` on
the MLP problem, with RFA) against the JAX reference, on the CPU.

The reference draws its randomness from ``jax.random``, the port from a
``torch.Generator``.  For trajectory parity the tests record a tape of
the reference's draws by replaying its key schedule here (``init``:
``PRNGKey(seed)`` for g^0's Bucketing order, ``PRNGKey(seed + 1)`` for the
steps; ``step``: ``split(key, 5)`` into cohort, minibatch, attack and
aggregation keys), carry the problem across as numpy arrays, and run both
engines on the same draws.  The runs:

  fig2-rfa              ``fig2_heuristic("rfa", "shb", True)`` on the Fig. 2
                        problem (20 clients, 15 good, d = 698), 300 steps;
  unbucketed clip/noclip RFA without Bucketing on the bench's majority
                        cell (10 clients, 7 good, C = 3, gamma = 0.15,
                        shift-back, data ``PRNGKey(5)``), 300 steps: the
                        run where the geometric median's answer matters
                        (under Bucketing(2) with C <= 4 at most two buckets
                        are non-empty, and the Weiszfeld iterate of two
                        points stays at their mean).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AggregatorSpec as RAggSpec
from repro.api import ClipSpec as RClipSpec
from repro.api import ServerPlan as RPlan
from repro.configs.paper import fig2_heuristic as ref_fig2
from repro.configs.paper import fig2_problem_kwargs as ref_fig2_kwargs
from repro.core import ClippedPPConfig as RefConfig
from repro.core import ClippedPPMomentum as RefEngine
from repro.core import estimators as rest
from repro.core import mlp_problem as ref_mlp_problem
from repro_torch.api import AggregatorSpec, ClipSpec, ServerPlan
from repro_torch.configs.paper import fig2_heuristic, fig2_problem_kwargs
from repro_torch.core import (
    ClippedPPConfig,
    ClippedPPMomentum,
    ClippedPPTape,
    mlp_problem,
    mlp_problem_from_numpy,
    page_update,
    page_update_tree,
    p_choice,
)
from repro_torch.kernels import _build

STEPS = 300
MAJORITY = dict(n_clients=10, n_good=7, m=128, in_dim=32, hidden=16,
                heterogeneous=True)
# the thresholds chip_smoke.py holds the port's own unbucketed runs to
CLIPPED_BELOW, UNCLIPPED_ABOVE = 2.0, 20.0


def _record_tape(cfg, n, m, steps):
    """The reference's draws, replayed from its key schedule
    (repro/core/heuristic.py ``init``/``step``/``_cohort`` and
    repro/core/aggregators.py ``_bucket_order``)."""

    def one(key, _):
        key, k_cohort, k_b, _k_att, k_agg = jax.random.split(key, 5)
        perm = jax.random.permutation(k_cohort, n)
        rank = jnp.zeros((n,), jnp.int32).at[perm].set(
            jnp.arange(n, dtype=jnp.int32))
        sampled = rank < cfg.C
        idx = jax.vmap(lambda k: jax.random.randint(k, (cfg.batch,), 0, m))(
            jax.random.split(k_b, n))
        bperm = jax.random.permutation(k_agg, n)
        order = bperm[jnp.argsort(jnp.where(sampled[bperm], 0, 1),
                                  stable=True)]
        return key, (sampled, idx, order)

    _, (sampled, idx, order) = jax.lax.scan(
        one, jax.random.PRNGKey(cfg.seed + 1), None, length=steps)
    g0_order = jax.random.permutation(jax.random.PRNGKey(cfg.seed), n)
    return ClippedPPTape(sampled=np.asarray(sampled),
                         batch_idx=np.asarray(idx), order=np.asarray(order),
                         g0_order=np.asarray(g0_order))


def _carry(ref_prob, hidden):
    return mlp_problem_from_numpy(
        np.asarray(ref_prob.features), np.asarray(ref_prob.labels),
        np.asarray(ref_prob.x0), n_good=ref_prob.n_good, hidden=hidden,
        device="cpu")


def _unbucketed(api, clip, config):
    plan = api[0](aggregate=api[1]("rfa"),
                  clip=api[2](alpha=1.0) if clip else None)
    return config(gamma=0.15, C=3, attack="shb", plan=plan)


@pytest.fixture(scope="module")
def runs():
    """name -> (port problem, port config, reference losses, tape)."""
    out = {}
    kw = ref_fig2_kwargs("shb")
    ref_prob = ref_mlp_problem(jax.random.PRNGKey(0), **kw)
    cases = [("fig2-rfa", ref_prob, ref_fig2("rfa", "shb", True),
              fig2_heuristic("rfa", "shb", True))]
    maj = ref_mlp_problem(jax.random.PRNGKey(5), **MAJORITY)
    for clip in (True, False):
        cases.append((f"unbucketed-{'clip' if clip else 'noclip'}", maj,
                      _unbucketed((RPlan, RAggSpec, RClipSpec), clip,
                                  RefConfig),
                      _unbucketed((ServerPlan, AggregatorSpec, ClipSpec),
                                  clip, ClippedPPConfig)))
    for name, rprob, rcfg, cfg in cases:
        algo = RefEngine(rprob, rcfg)
        _, met = jax.jit(lambda s: algo.run(STEPS, s))(algo.init())
        tape = _record_tape(rcfg, rprob.n_clients, rprob.m, STEPS)
        out[name] = (_carry(rprob, kw["hidden"]), cfg,
                     np.asarray(met["loss"]), tape, rcfg, rprob)
    return out


@pytest.mark.parametrize("attack", ["shb", "lf"])
def test_mlp_problem_carried_across_matches_reference(attack):
    """Same data: the loss, the full gradients and the minibatch gradients
    agree to rtol 1e-5 (atol 1e-7 for entries near 0, against gradients
    of order 0.5; the port backpropagates by hand, the reference by
    autodiff)."""
    kw = ref_fig2_kwargs(attack)
    ref_prob = ref_mlp_problem(jax.random.PRNGKey(0), **kw)
    prob = _carry(ref_prob, kw["hidden"])
    assert prob.dim == ref_prob.dim == 698
    np.testing.assert_array_equal(prob.labels.numpy(),
                                  np.asarray(ref_prob.labels))
    rng = np.random.RandomState(3)
    x = np.asarray(ref_prob.x0) + 0.05 * rng.randn(prob.dim).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(prob.loss(xt)),
                               float(jax.jit(ref_prob.loss)(xj)), rtol=1e-6)
    np.testing.assert_allclose(
        prob.all_full_grads(xt).numpy(),
        np.asarray(jax.jit(ref_prob.all_full_grads)(xj)), **tol)
    np.testing.assert_allclose(prob.grad(xt).numpy(),
                               np.asarray(jax.jit(ref_prob.grad)(xj)), **tol)
    idx = rng.randint(0, prob.m, (prob.n_clients, 32))
    batch_grad = jax.jit(jax.grad(ref_prob._batch_loss))
    want = np.stack([batch_grad(xj, ref_prob.features[i][idx[i]],
                                ref_prob.labels[i][idx[i]])
                     for i in range(prob.n_clients)])
    np.testing.assert_allclose(
        prob.all_minibatch_grads(torch.from_numpy(idx), xt).numpy(),
        np.asarray(want), **tol)


def test_tape_replays_the_reference_draws(runs):
    """Cohorts of size C, sampled rows first in every Bucketing order, the
    port's g^0 on the tape's order equals the reference's."""
    prob, cfg, _, tape, rcfg, rprob = runs["fig2-rfa"]
    assert set(tape.sampled.sum(axis=1)) == {cfg.C}
    for k in range(STEPS):
        ordered = tape.sampled[k][tape.order[k]]
        assert ordered[: cfg.C].all() and not ordered[cfg.C:].any()
    own = ClippedPPMomentum(prob, cfg, device="cpu").init(tape=tape)
    ref = RefEngine(rprob, rcfg).init()
    np.testing.assert_allclose(own.g.numpy(), np.asarray(ref.g), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["fig2-rfa", "unbucketed-clip"])
def test_clipped_trajectory_matches_reference(runs, name):
    """Same draws, same data: the per-step loss agrees to 1e-5 abs over
    300 steps (about 5e-7 is seen: the clipped runs contract, so the
    ulp-level differences of sum order stay small)."""
    prob, cfg, ref_loss, tape, _, _ = runs[name]
    _, met = ClippedPPMomentum(prob, cfg, device="cpu").run(STEPS, tape=tape)
    np.testing.assert_allclose(met["loss"].numpy(), ref_loss, rtol=0,
                               atol=1e-5)
    assert float(met["loss"][-1]) < 1.9


def test_unclipped_trajectory_matches_reference_then_diverges(runs):
    """The unclipped run diverges (2.3 -> about 1131), so ulp differences
    grow with it: steps 1-100 agree to rtol 1e-4 (about 2e-7 is seen); the
    end is judged by outcome."""
    prob, cfg, ref_loss, tape, _, _ = runs["unbucketed-noclip"]
    _, met = ClippedPPMomentum(prob, cfg, device="cpu").run(STEPS, tape=tape)
    np.testing.assert_allclose(met["loss"].numpy()[:100], ref_loss[:100],
                               rtol=1e-4, atol=0)
    assert float(met["loss"][-1]) > 100.0 and float(ref_loss[-1]) > 100.0


def test_own_rng_separates_clip_from_noclip():
    """The port's own draws and data (the runs of chip_smoke.py): on the
    unbucketed majority cell the clipped run learns and the unclipped one
    diverges."""
    prob = mlp_problem(5, device="cpu", **MAJORITY)
    final = {}
    for clip in (True, False):
        cfg = _unbucketed((ServerPlan, AggregatorSpec, ClipSpec), clip,
                          ClippedPPConfig)
        _, met = ClippedPPMomentum(prob, cfg, device="cpu").run(STEPS)
        assert torch.isfinite(met["loss"]).all()
        final[clip] = float(met["loss"][-1])
    assert final[True] < CLIPPED_BELOW < float(prob.loss(prob.x0))
    assert final[False] > UNCLIPPED_ABOVE


def test_fig2_configs_match_reference():
    for agg in ("cm", "rfa"):
        for clip in (True, False):
            ours, ref = fig2_heuristic(agg, "alie", clip), \
                ref_fig2(agg, "alie", clip)
            assert ours.plan.to_json() == ref.plan.to_json()
            assert (ours.gamma, ours.beta, ours.C, ours.batch, ours.attack) \
                == (ref.gamma, ref.beta, ref.C, ref.batch, ref.attack)
    assert fig2_problem_kwargs("lf") == ref_fig2_kwargs("lf")


def test_estimators_match_reference():
    rng = np.random.RandomState(1)
    g, full, diff = (rng.randn(7).astype(np.float32) for _ in range(3))
    for c in (True, False):
        np.testing.assert_array_equal(
            page_update(c, *(torch.from_numpy(v) for v in (g, full, diff)))
            .numpy(),
            np.asarray(rest.page_update(c, *(jnp.asarray(v)
                                             for v in (g, full, diff)))))
    tree = page_update_tree(False, {"a": torch.ones(2)}, {"a": torch.zeros(2)},
                            {"a": torch.ones(2)})
    torch.testing.assert_close(tree["a"], torch.full((2,), 2.0))
    assert p_choice(4, 20, 32, 300, 1.0, 40) == \
        rest.p_choice(4, 20, 32, 300, 1.0, 40)


def test_static_radius_applies_from_step_zero():
    """The 3.4e37 warm-up is for ClipSpec(alpha=) only: a static radius
    clips the very first step."""
    prob = mlp_problem(0, device="cpu", **dict(MAJORITY, m=16))
    tiny = ClippedPPConfig(gamma=0.1, C=3, plan=ServerPlan(
        aggregate=AggregatorSpec("rfa"), clip=ClipSpec(radius=1e-6)))
    algo = ClippedPPMomentum(prob, tiny, device="cpu")
    st = algo.init()
    st1 = algo.step(st)
    assert float(torch.linalg.vector_norm(st1.g - st.g)) <= 1e-6 * 1.0001


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.cuda_available.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mlp_problem(0, **fig2_problem_kwargs())
        prob = mlp_problem(0, device="cpu", **fig2_problem_kwargs())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ClippedPPMomentum(prob, fig2_heuristic("rfa"))
    finally:
        _build.cuda_available.cache_clear()


def test_rfa_equals_cm_under_bucketing_with_small_cohorts():
    """Fig. 2's plan, Bucketing(2) with C = 4: at most two buckets hold a
    sampled row, the coordinate median of two values is their mean, and a
    Weiszfeld iterate that starts at the mean of two points stays there,
    so RFA and CM give the same run (to the rounding of their sums).
    Without Bucketing the two rules separate."""
    prob = mlp_problem(0, device="cpu", **fig2_problem_kwargs("shb"))
    loss = {}
    for agg in ("rfa", "cm"):
        _, met = ClippedPPMomentum(prob, fig2_heuristic(agg, "shb", True),
                                   device="cpu").run(100)
        loss[agg] = met["loss"]
    assert float((loss["rfa"] - loss["cm"]).abs().max()) < 1e-5
    prob = mlp_problem(5, device="cpu", **MAJORITY)
    for agg in ("rfa", "cm"):
        cfg = ClippedPPConfig(gamma=0.15, C=3, attack="shb", plan=ServerPlan(
            aggregate=AggregatorSpec(agg), clip=ClipSpec(alpha=1.0)))
        _, met = ClippedPPMomentum(prob, cfg, device="cpu").run(100)
        loss[agg] = met["loss"]
    assert float((loss["rfa"] - loss["cm"]).abs().max()) > 1e-3
