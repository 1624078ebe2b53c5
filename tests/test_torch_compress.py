"""The port's compression slice against the JAX reference, on the CPU: the
compressors on the reference's own draws, ``theory.py``, ``from_theory``,
the compressed plans, and the worker-side ``clipped_diff``.

The compressors take their randomness as an input: the uniforms
``jax.random.uniform(key, (d,))`` of the reference's key are what its
RandK thresholds (the top k of them are kept) and what its l2
quantization compares (``jax.random.bernoulli`` draws a uniform below
p), so fed the same uniforms the port gives the reference's output.
``clipped_diff``'s plain version is held against the reference's Pallas
kernel in interpret mode; its CUDA kernels against the plain version in
tests/test_torch_cuda.py, on the card.
"""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as T
from repro.core import compressors as rcomp
from repro.core import theory as rtheory
from repro.core.marina_pp import ByzVRMarinaPP as RefEngine
from repro.core.problems import logistic_problem as ref_logistic_problem
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import ByzVRMarinaPP, problem_from_numpy
from repro_torch.core import compressors as tcomp
from repro_torch.core import theory as ttheory
from repro_torch.kernels import clipped_diff as cdk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-6, atol=1e-7)
KINDS = [("rand_k", {"k": 1}), ("rand_k", {"k": 10}), ("rand_k", {"k": 40}),
         ("rand_k", {"k": 100}), ("rand_fraction", {"frac": 0.1}),
         ("rand_fraction", {"frac": 0.33}), ("rand_fraction", {"frac": 1.0}),
         ("l2_quantization", {}), ("identity", {})]
IDS = [f"{k}-{'-'.join(f'{a}{b}' for a, b in kw.items())}" for k, kw in KINDS]


def _uniforms(key, d):
    return torch.from_numpy(np.array(jax.random.uniform(key, (d,))))


@pytest.mark.parametrize("kind,kw", KINDS, ids=IDS)
@pytest.mark.parametrize("shape", [(40,), (37,), (5, 8)], ids=str)
def test_compressor_on_the_reference_draws(kind, kw, shape):
    """One tensor (flattened inside), the reference's key against its
    uniforms, and the same omega, zeta and D_Q."""
    rc, tc = rcomp.make_compressor(kind, **kw), tcomp.make_compressor(kind,
                                                                      **kw)
    d = math.prod(shape)
    assert tc.name == rc.name
    assert (tc.omega(d), tc.zeta(d), tc.dq(d)) == (rc.omega(d), rc.zeta(d),
                                                   rc.dq(d))
    for seed in range(3):
        x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
        key = jax.random.PRNGKey(seed + 10)
        want = np.asarray(rc(key, jnp.asarray(x)))
        got = tc(_uniforms(key, d), torch.from_numpy(x))
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind,kw", KINDS, ids=IDS)
def test_compressor_rows_use_one_draw_per_client(kind, kw):
    """The batched form is the reference's vmap over per-client keys."""
    rc, tc = rcomp.make_compressor(kind, **kw), tcomp.make_compressor(kind,
                                                                      **kw)
    n, d = 6, 40
    xs = np.random.RandomState(3).randn(n, d).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    want = np.asarray(jax.vmap(rc)(keys, jnp.asarray(xs)))
    draws = torch.stack([_uniforms(k, d) for k in keys])
    got = tc.rows(draws, torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rand_k_takes_a_keep_mask_and_a_generator():
    """A bool draw is the keep mask itself; a generator draws the scores:
    exactly k coordinates survive, scaled by d/k, and the mean over draws
    is x (unbiased)."""
    c = tcomp.rand_k(5)
    x = torch.arange(1.0, 21.0)
    keep = torch.zeros(20, dtype=torch.bool)
    keep[[0, 3, 7, 11, 19]] = True
    torch.testing.assert_close(c(keep, x), x * keep * 4.0)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([c(gen, x) for _ in range(4000)])
    assert ((draws != 0).sum(dim=1) == 5).all()
    assert set(torch.unique(draws / x).tolist()) == {0.0, 4.0}
    torch.testing.assert_close(draws.mean(dim=0), x, rtol=0.12, atol=0.0)
    with pytest.raises(ValueError, match="recorded draw of shape"):
        c(torch.rand(7), x)
    xs = torch.randn(3, 20)
    rows = c.rows(torch.Generator().manual_seed(1), xs)
    assert ((rows != 0).sum(dim=1) == 5).all()


def test_l2_quantization_is_unbiased_on_a_generator():
    c = tcomp.l2_quantization()
    x = torch.tensor([3.0, -4.0, 0.0, 1.0])
    gen = torch.Generator().manual_seed(0)
    q = torch.stack([c(gen, x) for _ in range(6000)])
    norm = float(torch.linalg.vector_norm(x))
    assert set(torch.unique(q.abs()).tolist()) <= {0.0, norm}
    torch.testing.assert_close(q.mean(dim=0), x, rtol=0.1, atol=0.1)


def test_make_compressor_builds_every_kind():
    for kind, kw in KINDS:
        assert tcomp.make_compressor(kind, **kw).name == \
            rcomp.make_compressor(kind, **kw).name
    assert tcomp.make_compressor("none").rows_fn is None
    with pytest.raises(ValueError, match="unknown compressor"):
        tcomp.make_compressor("top_k")


@pytest.mark.parametrize("spec", [
    lambda A: A.CompressSpec("rand_k", k=3),
    lambda A: A.CompressSpec("rand_fraction", frac=0.25),
    lambda A: A.CompressSpec("l2_quantization")], ids=["randk", "frac", "l2"])
def test_compressed_plans_build_the_reference_compressor(spec):
    """The same plan document builds the same compressor in both packages,
    and it compresses one vector alike on the same draws."""
    rplan = R.ServerPlan(aggregate="cm", compress=spec(R))
    tplan = T.ServerPlan.from_json(rplan.to_json())
    assert tplan.to_json() == rplan.to_json()
    rc, tc = rplan.build_compressor(), tplan.build().compressor
    assert tc.name == rc.name and tc.omega(40) == rc.omega(40)
    x = np.random.RandomState(5).randn(40).astype(np.float32)
    key = jax.random.PRNGKey(5)
    np.testing.assert_allclose(tc(_uniforms(key, 40), torch.from_numpy(x))
                               .numpy(), np.asarray(rc(key, jnp.asarray(x))),
                               **TOL)


def test_plan_from_args_builds_a_working_rand_fraction_plan():
    """The launcher's ``compress_frac`` gives a rand_fraction plan that
    builds in both packages and serializes alike."""
    import argparse

    from repro.launch import cli as rcli
    from repro_torch.launch import cli as tcli

    def parse(cli):
        p = argparse.ArgumentParser()
        cli.add_plan_args(p)
        return p.parse_args(["--aggregator", "cm", "--agg-schedule", "naive"])

    rp = rcli.plan_from_args(parse(rcli), compress_frac=0.25)
    tp = tcli.plan_from_args(parse(tcli), compress_frac=0.25)
    assert tp.to_json() == rp.to_json()
    assert tp.build().compressor.name == rp.build_compressor().name == \
        "randp0.25"


# ---------------------------------------------------------------------------
# theory
# ---------------------------------------------------------------------------

_GRID = [c for c in itertools.product((10, 20), (7, 15), (1, 4, 10),
                                      (0.1, 0.25), (0.2, 0.5))
         if c[1] <= c[0]]  # at most n good clients


@pytest.mark.parametrize("n,G,C,delta,p", _GRID, ids=str)
def test_theory_functions_equal_the_reference(n, G, C, delta, p):
    assert ttheory.cohort_probabilities(n, G, C, delta) == \
        rtheory.cohort_probabilities(n, G, C, delta)
    for omega, dq in ((0.0, 1.0), (3.0, 4.0), (5.32, 6.32)):
        kw = dict(n=n, G=G, C=C, C_hat=n, delta=delta, p=p, omega=omega,
                  c_const=1.0, f_a=2.0)
        for got, want in ((ttheory.theorem41_A(**kw),
                           rtheory.theorem41_A(**kw)),
                          (ttheory.theorem42_A(d_q=dq, **kw),
                           rtheory.theorem42_A(d_q=dq, **kw))):
            assert got == pytest.approx(want, rel=1e-12, abs=0)
            for pl in (False, True):
                assert ttheory.stepsize(1.3, got, pl) == pytest.approx(
                    rtheory.stepsize(1.3, want, pl), rel=1e-12, abs=0)
        th = dict(n=n, G=G, C=C, C_hat=n, delta=delta, p=p, L=0.7,
                  omega=omega, d_q=dq)
        tt, rt = ttheory.MarinaTheory(**th), rtheory.MarinaTheory(**th)
        assert tt.p_g == rt.p_g
        for thm in ("4.1", "4.2"):
            assert tt.gamma(thm) == pytest.approx(rt.gamma(thm), rel=1e-12,
                                                  abs=0)
            assert tt.clip_alpha(thm) == rt.clip_alpha(thm)


@pytest.fixture(scope="module")
def theory_problem():
    ref = ref_logistic_problem(jax.random.PRNGKey(0), n_clients=10,
                               n_good=8, m=100, dim=20, homogeneous=True)
    port = problem_from_numpy(np.asarray(ref.features[0]),
                              np.asarray(ref.labels[0]), np.asarray(ref.x0),
                              n_good=ref.n_good, l2=ref.l2,
                              n_clients=ref.n_clients, device="cpu")
    return ref, port


@pytest.mark.parametrize("theorem,comp,ckw", [
    ("4.1", "identity", ()), ("4.2", "identity", ()),
    ("4.2", "rand_k", (("k", 10),)), ("4.1", "rand_fraction",
                                      (("frac", 0.5),)),
    ("4.2", "l2_quantization", ())], ids=str)
def test_from_theory_equals_the_reference(theory_problem, theorem, comp, ckw):
    """Same smoothness bound, stepsize, clip level and plan document."""
    ref, port = theory_problem
    assert port.smoothness() == ref.smoothness()
    kw = dict(C=2, C_hat=10, p=0.25, delta=0.2, theorem=theorem,
              aggregator="centered_clip", attack="shb", compressor=comp,
              compressor_kwargs=ckw)
    r = RefEngine.from_theory(ref, **kw, backend="jnp")
    t = ByzVRMarinaPP.from_theory(port, **kw, backend="torch", device="cpu")
    assert t.cfg.gamma == r.cfg.gamma
    assert t.plan.clip.alpha == r.plan.clip.alpha
    assert t.plan.to_json() == r.plan.to_json().replace('"jnp"', '"torch"')
    assert (t.cfg.p, t.cfg.C, t.cfg.C_hat, t.cfg.batch, t.cfg.attack) == \
        (r.cfg.p, r.cfg.C, r.cfg.C_hat, r.cfg.batch, r.cfg.attack)


def test_from_theory_descends_on_its_own_draws(theory_problem):
    """The reference's own criterion: the theory stepsize brings the loss
    below where it started."""
    _, port = theory_problem
    alg = ByzVRMarinaPP.from_theory(port, C=2, C_hat=10, p=0.25, delta=0.2,
                                    attack="shb", device="cpu")
    assert 0 < alg.cfg.gamma < 1.0
    assert alg.plan.clip.alpha == 2.0 * port.smoothness()
    _, m = alg.run(150)
    assert float(m["loss"][-1]) < float(m["loss"][0])


# ---------------------------------------------------------------------------
# clipped_diff (worker side)
# ---------------------------------------------------------------------------

def _diff_case(shape, seed, keep_dtype):
    rng = np.random.RandomState(seed)
    gn = rng.randn(*shape).astype(np.float32)
    go = rng.randn(*shape).astype(np.float32)
    keep = rng.rand(*shape) < 0.3
    return gn, go, keep.astype(keep_dtype)


@pytest.mark.parametrize("shape", [(8192,), (5000,), (3, 1001), (2, 3, 7),
                                   (1,)], ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("radius", [0.5, 1e9], ids=["clips", "no-clip"])
def test_clipped_diff_matches_pallas_interpret(shape, dtype, radius):
    """Odd lengths and multi-dimensional shapes flatten as the reference's
    do; f32 to 1e-6, bf16 to one ulp (its d is rounded before the clip in
    both packages)."""
    gn, go, keep = _diff_case(shape, sum(shape) + len(dtype), np.float32)
    scale = 10.0 / 3.0
    jgn, jgo = jnp.asarray(gn), jnp.asarray(go)
    tgn, tgo = torch.from_numpy(gn), torch.from_numpy(go)
    if dtype == "bf16":
        jgn, jgo = jgn.astype(jnp.bfloat16), jgo.astype(jnp.bfloat16)
        tgn, tgo = tgn.bfloat16(), tgo.bfloat16()
    want, wnorm = rops.clipped_diff(jgn, jgo, radius, jnp.asarray(keep),
                                    scale)
    got, norm = ops.clipped_diff(tgn, tgo, radius, torch.from_numpy(keep),
                                 scale)
    assert got.shape == shape and got.dtype == tgn.dtype
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    w32 = np.asarray(want.astype(jnp.float32))
    if dtype == "bf16":
        np.testing.assert_allclose(got.float().numpy(), w32,
                                   rtol=2.0 ** -7, atol=1e-30)
    else:
        np.testing.assert_allclose(got.numpy(), w32, rtol=1e-6, atol=1e-7)
    oracle, onorm = tref.clipped_diff_ref(tgn, tgo, radius,
                                          torch.from_numpy(keep), scale)
    np.testing.assert_allclose(float(onorm), float(norm), rtol=1e-6)
    ro, _ = rref.clipped_diff_ref(jgn, jgo, radius, jnp.asarray(keep), scale)
    np.testing.assert_allclose(oracle.float().numpy(),
                               np.asarray(ro.astype(jnp.float32)),
                               rtol=1e-6 if dtype == "f32" else 2.0 ** -7,
                               atol=1e-7)


def test_clipped_diff_bool_keep_equals_numeric_keep():
    """A bool keep mask (the bytes the kernel reads) gives the numeric
    mask's result bit for bit."""
    gn, go, keep = _diff_case((4, 999), 1, bool)
    args = (torch.from_numpy(gn), torch.from_numpy(go))
    a = cdk.clipped_diff_plain(*args, 0.7, torch.from_numpy(keep), 2.5)
    b = cdk.clipped_diff_plain(*args, 0.7,
                               torch.from_numpy(keep.astype(np.float32)), 2.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert sum(ops.launch_counts().values()) == 0  # the CPU never launches


def test_clipped_diff_checks_its_inputs():
    g = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="g_old has shape"):
        ops.clipped_diff(g, torch.zeros(20), 1.0, torch.ones(4, 5), 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.clipped_diff(g.double(), g.double(), 1.0, torch.ones(4, 5), 1.0)
    with pytest.raises(TypeError, match="g_old is"):
        ops.clipped_diff(g, g.bfloat16(), 1.0, torch.ones(4, 5), 1.0)
    with pytest.raises(ValueError, match="empty"):
        ops.clipped_diff(torch.zeros(0), torch.zeros(0), 1.0,
                         torch.zeros(0), 1.0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64],
                         ids=["f16", "f64"])
def test_clipped_diff_scale_refuses_other_dtypes(dtype):
    """The scale pass takes f32 and bf16 only, with the TypeError of the
    other wrappers, on the CPU as on a card."""
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cdk.clipped_diff_scale(torch.ones(7, dtype=dtype), torch.tensor(0.5))
    assert sum(ops.launch_counts().values()) == 0
