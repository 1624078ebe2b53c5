"""The PyTorch port's Fig. 1 engine against the JAX reference, on the CPU.

The reference draws all its randomness from ``jax.random``; the port from
``torch.Generator``s.  For trajectory parity the test records a tape of
the reference's draws by replaying its key schedule here (``split(key,
6)`` per step, the Bernoulli coin, the cohort permutation, the per-client
minibatch ``randint``, the per-client compressor uniforms and Bucketing's
sampled-first order), carries the problem across as numpy arrays, and
runs both engines on the same draws.

The reference compresses client i's difference with ``split(k_q, n)[i]``,
the very key its minibatch indices came from (``marina_pp.py:218``,
``problems.py:69-73``): the tape records the uniforms that key gives, so
the port replays that schedule; its own generator path draws them apart.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataclasses

import repro.api as R
import repro_torch.api as T
from repro.configs.paper import fig1_marina_pp as ref_fig1
from repro.configs.paper import fig1_problem_kwargs as ref_problem_kwargs
from repro.configs.paper import paper_plan as ref_paper_plan
from repro.core import ByzVRMarinaPP as RefEngine
from repro.core import logistic_problem as ref_logistic_problem
from repro_torch import quickstart
from repro_torch.configs.paper import fig1_marina_pp, fig1_problem_kwargs
from repro_torch.core import (
    ByzVRMarinaPP,
    MarinaPPState,
    MarinaPPTape,
    logistic_problem,
    problem_from_numpy,
)
from repro_torch.kernels import _build

STEPS = 300
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _record_tape(cfg, n, m, steps, d=40):
    """The reference's draws, replayed from its key schedule
    (repro/core/marina_pp.py ``init``/``step``/``_sample_cohort``,
    repro/core/problems.py ``all_minibatch_diffs``, the compressor's
    ``jax.random.uniform(qkey, (d,))`` and repro/core/aggregators.py
    ``_bucket_order``)."""

    def one(key, _):
        key, k_bern, k_cohort, k_q, _k_att, k_agg = jax.random.split(key, 6)
        c = jax.random.bernoulli(k_bern, cfg.p)
        perm = jax.random.permutation(k_cohort, n)
        size = jnp.where(c, cfg.C_hat, cfg.C)
        rank = jnp.zeros((n,), jnp.int32).at[perm].set(
            jnp.arange(n, dtype=jnp.int32))
        sampled = rank < size
        qkeys = jax.random.split(k_q, n)
        idx = jax.vmap(lambda k: jax.random.randint(k, (cfg.batch,), 0, m))(
            qkeys)
        # the compressor's draws come from the same per-client keys
        qdraws = jax.vmap(lambda k: jax.random.uniform(k, (d,)))(qkeys)
        bperm = jax.random.permutation(k_agg, n)
        order = bperm[jnp.argsort(jnp.where(sampled[bperm], 0, 1),
                                  stable=True)]
        return key, (c, sampled, idx, qdraws, order)

    _, (c, sampled, idx, qdraws, order) = jax.lax.scan(
        one, jax.random.PRNGKey(cfg.seed + 1), None, length=steps)
    # g^0 aggregates all rows (mask None), so its order is the permutation
    g0_order = jax.random.permutation(jax.random.PRNGKey(cfg.seed), n)
    return MarinaPPTape(c=np.asarray(c), sampled=np.asarray(sampled),
                        batch_idx=np.asarray(idx), order=np.asarray(order),
                        g0_order=np.asarray(g0_order),
                        q_draws=np.asarray(qdraws))


@pytest.fixture(scope="module")
def fig1_pair():
    """Reference problem + runs, the port's copy of the problem, and the
    tape of both configurations (clipped, unclipped)."""
    kw = ref_problem_kwargs()
    ref_prob = ref_logistic_problem(jax.random.PRNGKey(0), **kw)
    prob = problem_from_numpy(
        np.asarray(ref_prob.features[0]), np.asarray(ref_prob.labels[0]),
        np.asarray(ref_prob.x0), n_good=ref_prob.n_good, l2=ref_prob.l2,
        n_clients=ref_prob.n_clients, device="cpu")
    runs = {}
    for clip in (True, False):
        cfg = ref_fig1(clip)
        algo = RefEngine(ref_prob, cfg)
        state, met = jax.jit(lambda s: algo.run(STEPS, s))(algo.init())
        tape = _record_tape(cfg, ref_prob.n_clients, ref_prob.m, STEPS)
        runs[clip] = (np.asarray(met["loss"]), np.asarray(state.x), tape)
    return prob, runs


# the compressed and the CenteredClip Fig. 1 runs: name -> (reference plan,
# its reference engine config)
_VARIANTS = {
    "randk10": dataclasses.replace(
        ref_paper_plan("cm", 1.0), compress=R.CompressSpec("rand_k", k=10)),
    "cclip-bucket2": ref_paper_plan("centered_clip", 1.0),
    "l2quant": dataclasses.replace(
        ref_paper_plan("cm", 1.0), compress=R.CompressSpec("l2_quantization")),
}


@pytest.fixture(scope="module")
def fig1_variants(fig1_pair):
    """The reference's runs of the Fig. 1 problem under each plan of
    _VARIANTS, with the tape of their (shared) draws."""
    prob, runs = fig1_pair
    tape = runs[True][2]
    ref_prob = ref_logistic_problem(jax.random.PRNGKey(0),
                                    **ref_problem_kwargs())
    out = {}
    for name, plan in _VARIANTS.items():
        cfg = dataclasses.replace(ref_fig1(True), plan=plan)
        algo = RefEngine(ref_prob, cfg)
        state, met = jax.jit(lambda s: algo.run(STEPS, s))(algo.init())
        out[name] = (cfg, np.asarray(met["loss"]), np.asarray(state.x))
    return prob, tape, out


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_fig1_variant_trajectory_matches_reference(fig1_variants, name):
    """RandK (k = 10), l2 quantization and CenteredClip over Bucketing(2)
    on the reference's draws: the per-step losses agree to 1e-5 abs over
    300 steps.  The compressed runs pin the per-row compression: the
    compressor of the flattened (n, d) matrix would keep k of n*d
    coordinates and scale them by n*d/k."""
    prob, tape, out = fig1_variants
    cfg, ref_loss, ref_x = out[name]
    port_cfg = dataclasses.replace(
        fig1_marina_pp(True), plan=T.ServerPlan.from_json(cfg.plan.to_json()))
    algo = ByzVRMarinaPP(prob, port_cfg, device="cpu")
    state, met = algo.run(STEPS, tape=tape)
    np.testing.assert_allclose(met["loss"].numpy(), ref_loss, atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(state.x.numpy(), ref_x, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(met["full_round"].numpy(), tape.c)


def test_compressed_run_needs_the_tapes_draws(fig1_pair):
    prob, runs = fig1_pair
    tape = dataclasses.replace(runs[True][2], q_draws=None)
    cfg = dataclasses.replace(fig1_marina_pp(True), plan=T.ServerPlan.from_json(
        _VARIANTS["randk10"].to_json()))
    with pytest.raises(ValueError, match="q_draws"):
        ByzVRMarinaPP(prob, cfg, device="cpu").run(STEPS, tape=tape)


def test_problem_carried_across_matches_reference(fig1_pair):
    prob, _ = fig1_pair
    ref_prob = ref_logistic_problem(jax.random.PRNGKey(0),
                                    **ref_problem_kwargs())
    assert prob.homogeneous  # kept a broadcast view
    x = np.random.RandomState(0).randn(prob.dim).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(float(prob.loss(xt)),
                               float(ref_prob.loss(jnp.asarray(x))),
                               rtol=1e-6)
    # closed-form gradients vs the reference's autodiff: f32 rounding only
    np.testing.assert_allclose(prob.all_full_grads(xt).numpy(),
                               np.asarray(ref_prob.all_full_grads(
                                   jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def test_tape_replays_the_reference_draws(fig1_pair):
    """The tape is what the reference engine drew: its coins produce the
    cohort sizes C and C_hat, and the orders put sampled rows first."""
    _, runs = fig1_pair
    tape = runs[True][2]
    sizes = tape.sampled.sum(axis=1)
    cfg = ref_fig1(True)
    assert set(sizes[tape.c]) == {cfg.C_hat}
    assert set(sizes[~tape.c]) == {cfg.C}
    for k in range(STEPS):
        ordered = tape.sampled[k][tape.order[k]]
        assert ordered[: sizes[k]].all() and not ordered[sizes[k]:].any()


def test_fig1_clipped_trajectory_matches_reference(fig1_pair):
    """Same draws, same data: the per-step loss and x^300 agree to 2e-6
    (the issue asks 1e-5 and 1e-4; about 3e-7 is seen).  The clipped run
    contracts, so the ulp-level differences of reduction order (norms,
    sums, closed-form vs autodiff gradients) stay small."""
    prob, runs = fig1_pair
    ref_loss, ref_x, tape = runs[True]
    algo = ByzVRMarinaPP(prob, fig1_marina_pp(True), device="cpu")
    state, met = algo.run(STEPS, tape=tape)
    np.testing.assert_allclose(met["loss"].numpy(), ref_loss, atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(state.x.numpy(), ref_x, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(met["full_round"].numpy(), tape.c)


def test_state_carried_across_continues_the_run(fig1_pair):
    """``MarinaPPState.from_numpy`` takes the reference's g^0: the port's
    own g^0 on the tape's order equals it, and a run from the carried
    state is the run from ``init``."""
    prob, runs = fig1_pair
    tape = runs[True][2]
    ref_prob = ref_logistic_problem(jax.random.PRNGKey(0),
                                    **ref_problem_kwargs())
    ref_state = RefEngine(ref_prob, ref_fig1(True)).init()
    algo = ByzVRMarinaPP(prob, fig1_marina_pp(True), device="cpu")
    own = algo.init(tape=tape)
    np.testing.assert_allclose(own.g.numpy(), np.asarray(ref_state.g),
                               atol=1e-7, rtol=0)
    carried = MarinaPPState.from_numpy(
        np.asarray(ref_state.x), np.asarray(ref_state.g),
        np.asarray(ref_state.x0), 0, device="cpu")
    _, a = algo.run(20, carried, tape=tape)
    _, b = algo.run(20, own, tape=tape)
    np.testing.assert_allclose(a["loss"].numpy(), b["loss"].numpy(),
                               atol=1e-7, rtol=0)


def test_fig1_unclipped_trajectory_matches_reference_then_diverges(fig1_pair):
    """The unclipped run diverges (its loss grows by orders of
    magnitude), so ulp differences grow with it: steps 0-99, while the
    loss is bounded, agree to rtol 5e-6 (the issue asks 1e-4; about 5e-7
    is seen); the end is judged by outcome."""
    prob, runs = fig1_pair
    ref_loss, _, tape = runs[False]
    algo = ByzVRMarinaPP(prob, fig1_marina_pp(False), device="cpu")
    _, met = algo.run(STEPS, tape=tape)
    np.testing.assert_allclose(met["loss"].numpy()[:100], ref_loss[:100],
                               rtol=5e-6, atol=0)
    assert float(met["loss"][-1]) > 5.0 and float(ref_loss[-1]) > 5.0


def test_quickstart_own_rng_separates(capsys):
    """The port's own draws: clipping converges (below 0.64, and within
    1e-3 of the optimum of this data), no clipping diverges."""
    losses = quickstart.main(device="cpu")
    assert float(losses[True][-1]) < 0.64
    assert float(losses[False][-1]) > 5.0
    prob = logistic_problem(0, device="cpu", **fig1_problem_kwargs())
    x = prob.x0.clone()
    for _ in range(2000):
        x = x - 2.0 * prob.grad(x)
    assert float(losses[True][-1]) - float(prob.loss(x)) < 1e-3
    assert "with clipping" in capsys.readouterr().out


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means the card: with no card every entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.cuda_available.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            logistic_problem(0, **fig1_problem_kwargs())
        prob = logistic_problem(0, device="cpu", **fig1_problem_kwargs())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ByzVRMarinaPP(prob, fig1_marina_pp(True))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quickstart.main()
    finally:
        _build.cuda_available.cache_clear()


def test_engine_rejects_unported_scenario_and_device_mismatch():
    """A ScenarioSpec is accepted (it wins over ``attack``, the adaptive
    kinds built against the engine's plan); C > n still raises."""
    prob = logistic_problem(0, device="cpu", **fig1_problem_kwargs())
    cfg = fig1_marina_pp(True)
    for kind in ("alie", "adaptive"):
        algo = ByzVRMarinaPP(prob, dataclasses.replace(
            cfg, scenario=T.ScenarioSpec(attack=kind, budget=2)), device="cpu")
        assert algo.attack.name == kind
        assert algo.attack.adaptive == (kind == "adaptive")
    with pytest.raises(ValueError, match="need 1 <= C"):
        ByzVRMarinaPP(prob, type(cfg)(**{**cfg.__dict__, "C": 30}),
                      device="cpu")


def test_port_sources_import_neither_jax_nor_repro():
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro(\.|\s))")
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert len(files) > 10 and not bad, bad


def test_port_imports_without_jax():
    """The port is independent of JAX: importing all of it in a fresh
    interpreter loads neither jax nor the reference package."""
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
