"""The port's core modules (aggregators, Bucketing, clipping, tree
helpers, attacks, the attack stage) against the JAX reference, on the
CPU, with numpy inputs from seeds and Bucketing orders carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.aggregators as ragg
from repro.core import attacks as ratt
from repro.core import clipping as rclip
from repro.core import compressors as rcomp
from repro.core.tree_utils import tree_batch_ravel as r_tree_batch_ravel
from repro.scenarios import stage as rstage
from repro_torch.core import aggregators as tagg
from repro_torch.core import attacks as tatt
from repro_torch.core import clipping as tclip
from repro_torch.core import compressors as tcomp
from repro_torch.core.tree_utils import tree_batch_ravel, tree_norm
from repro_torch.kernels import ops
from repro_torch.scenarios import stage as tstage

TOL = dict(rtol=1e-5, atol=1e-6)
RULES = [("cm", {}), ("trimmed_mean", {"trim_ratio": 0.2}), ("mean", {}),
         ("rfa", {"iters": 5}), ("centered_clip", {"tau": 1.5, "iters": 4})]


def _case(n, d, seed):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n) > 0.4
    mask[0] = True
    return xs, mask


def _ref_order(key, mask, n):
    return np.asarray(ragg._bucket_order(key, jnp.asarray(mask), n))


@pytest.mark.parametrize("rule,kw", RULES, ids=[r for r, _ in RULES])
@pytest.mark.parametrize("bucket_s", [0, 2, 3])
@pytest.mark.parametrize("n,d", [(20, 40), (21, 130), (7, 5)], ids=str)
def test_aggregate_matches_reference_jnp(rule, kw, bucket_s, n, d):
    xs, mask = _case(n, d, n * 7 + d + bucket_s)
    key = jax.random.PRNGKey(n + bucket_s)
    ref = ragg.make_aggregator(rule, bucket_s, backend="jnp", **kw)
    port = tagg.make_aggregator(rule, bucket_s, backend="torch", **kw)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, n)))
    out = port(torch.from_numpy(xs), torch.from_numpy(mask), key=perm)
    want = ref(jnp.asarray(xs), jnp.asarray(mask), key=key)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    clipped = port.clip_then_aggregate(torch.from_numpy(xs), 0.7,
                                       torch.from_numpy(mask), key=perm)
    want = ref.clip_then_aggregate(jnp.asarray(xs), 0.7, jnp.asarray(mask),
                                   key=key)
    np.testing.assert_allclose(clipped.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rule,kw", RULES, ids=[r for r, _ in RULES])
@pytest.mark.parametrize("bucket_s", [0, 2])
def test_kernel_composition_matches_reference_pallas(rule, kw, bucket_s):
    """The kernel backends' composition (Bucketing order -> fused
    wrappers), run on CPU tensors through the kernels' plain versions,
    against the reference's pallas aggregator in interpret mode."""
    n, d = 21, 130
    xs, mask = _case(n, d, 11 + bucket_s)
    key = jax.random.PRNGKey(3)
    ref = ragg.make_aggregator(rule, bucket_s, backend="pallas", **kw)
    if rule in ("rfa", "centered_clip"):
        kernel = (ops.clip_then_geometric_median if rule == "rfa"
                  else ops.clip_then_centered_clip)
        aggregate, fused = tagg._kernel_fns(kernel, bucket_s, **kw)
    else:
        trim = {"cm": -1.0, "mean": 0.0}.get(rule, kw.get("trim_ratio"))
        aggregate, fused = tagg._cm_kernel_fns(trim, bucket_s)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, n)))
    xt, mt = torch.from_numpy(xs), torch.from_numpy(mask)
    np.testing.assert_allclose(
        aggregate(xt, mt, key=perm).numpy(),
        np.asarray(ref(jnp.asarray(xs), jnp.asarray(mask), key=key)), **TOL)
    np.testing.assert_allclose(
        fused(xt, 0.7, mt, key=perm).numpy(),
        np.asarray(ref.clip_then_aggregate(jnp.asarray(xs), 0.7,
                                           jnp.asarray(mask), key=key)),
        **TOL)


@pytest.mark.parametrize("n", [5, 20, 21])
def test_bucket_order_matches_reference(n):
    rng = np.random.RandomState(n)
    mask = rng.rand(n) > 0.5
    key = jax.random.PRNGKey(n)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, n)))
    got = tagg._bucket_order(perm, torch.from_numpy(mask), n, "cpu")
    np.testing.assert_array_equal(got.numpy(), _ref_order(key, mask, n))
    # a final (already sampled-first) order is left as it is
    again = tagg._bucket_order(got, torch.from_numpy(mask), n, "cpu")
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    # a generator draws a permutation of its own
    drawn = tagg._bucket_order(torch.Generator().manual_seed(1), None, n,
                               "cpu")
    assert sorted(drawn.tolist()) == list(range(n))


def test_backends_dispatch_by_device():
    xs = torch.randn(8, 16)
    ops.reset_launch_counts()
    for backend in ("torch", "jnp", "auto"):
        agg = tagg.make_aggregator("cm", 2, backend=backend)
        agg(xs)
        agg.clip_then_aggregate(xs, 1.0)
    assert sum(ops.launch_counts().values()) == 0  # CPU never launches
    for backend in ("cuda", "pallas"):
        agg = tagg.make_aggregator("cm", 2, backend=backend)
        assert agg.backend == "cuda"
        with pytest.raises(ValueError, match="backend 'cuda'"):
            agg(xs)
        with pytest.raises(ValueError, match="backend 'cuda'"):
            agg.clip_then_aggregate(xs, 1.0)
    with pytest.raises(ValueError, match="unknown backend"):
        tagg.make_aggregator("cm", backend="xla")
    with pytest.raises(ValueError, match="unknown aggregator"):
        tagg.make_aggregator("median")
    # the whole registry is ported: the legacy spelling builds CenteredClip
    assert tagg.make_aggregator("cclip", backend="auto").name == "cclip"
    for rule in ("krum", "multi_krum"):  # ported with the serve slice
        assert tagg.make_aggregator(rule, backend="auto").supports_two_phase
    for rule in ("rfa", "gm", "geometric_median"):  # ported with Fig. 2
        assert tagg.make_aggregator(rule, backend="auto").name == "rfa"


def test_aggregators_take_dicts_of_tensors():
    rng = np.random.RandomState(4)
    tree = {"w": rng.randn(6, 3, 4).astype(np.float32),
            "b": rng.randn(6, 5).astype(np.float32)}
    ref_mat, _ = r_tree_batch_ravel({k: jnp.asarray(v) for k, v in
                                     tree.items()})
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    mat, unravel = tree_batch_ravel(ttree)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(ref_mat))
    agg = tagg.make_aggregator("cm", backend="torch")
    out = agg(ttree)
    assert out["w"].shape == (3, 4) and out["b"].shape == (5,)
    torch.testing.assert_close(out["w"], unravel(agg(mat))["w"])
    with pytest.raises(ValueError, match="disagree"):
        tree_batch_ravel({"a": torch.zeros(2, 3), "b": torch.zeros(3, 3)})


def test_clipping_matches_reference():
    rng = np.random.RandomState(8)
    x = rng.randn(40).astype(np.float32)
    x_old = rng.randn(40).astype(np.float32)
    for radius in (0.5, 100.0):
        np.testing.assert_allclose(
            tclip.clip(torch.from_numpy(x), radius).numpy(),
            np.asarray(rclip.clip(jnp.asarray(x), radius)), **TOL)
    tree = {"a": torch.from_numpy(x[:10]), "b": torch.from_numpy(x[10:])}
    rtree = {"a": jnp.asarray(x[:10]), "b": jnp.asarray(x[10:])}
    got = tclip.clip_tree(tree, 0.5)
    want = rclip.clip_tree(rtree, 0.5)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    np.testing.assert_allclose(float(tree_norm(tree)), np.linalg.norm(x),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tclip.marina_radius(torch.from_numpy(x), torch.from_numpy(x_old),
                                  2.0)),
        float(rclip.marina_radius(jnp.asarray(x), jnp.asarray(x_old), 2.0)),
        rtol=1e-6)
    assert tclip.theorem41_alpha(3.0) == rclip.theorem41_alpha(3.0)
    assert tclip.theorem42_alpha(3.0, 2.0) == rclip.theorem42_alpha(3.0, 2.0)


def test_identity_compressor_and_unported_kinds():
    """The identity passes its input through; every other kind builds with
    the reference's constants and, on the reference's uniforms, its
    output."""
    c, r = tcomp.make_compressor("identity"), rcomp.make_compressor("identity")
    x = torch.randn(7)
    assert c(None, x) is x
    assert (c.omega(7), c.zeta(7), c.dq(7)) == (r.omega(7), r.zeta(7),
                                                r.dq(7))
    xs = np.random.RandomState(2).randn(40).astype(np.float32)
    key = jax.random.PRNGKey(2)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (40,))))
    for kind, kw in (("rand_k", {"k": 4}), ("rand_fraction", {"frac": 0.2}),
                     ("l2_quantization", {})):
        c, r = tcomp.make_compressor(kind, **kw), rcomp.make_compressor(kind,
                                                                        **kw)
        assert (c.omega(40), c.zeta(40), c.dq(40)) == (r.omega(40),
                                                       r.zeta(40), r.dq(40))
        np.testing.assert_allclose(c(u, torch.from_numpy(xs)).numpy(),
                                   np.asarray(r(key, jnp.asarray(xs))),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown compressor"):
        tcomp.make_compressor("top_k")


@pytest.mark.parametrize("name", ["none", "bf", "sf", "lf", "alie", "ipm",
                                  "shb"])
@pytest.mark.parametrize("majority", [False, True])
def test_attack_stage_matches_reference(name, majority):
    n, d = 20, 40
    rng = np.random.RandomState(9)
    honest = rng.randn(n, d).astype(np.float32)
    good = np.arange(n) < 15
    sampled = np.zeros(n, bool)
    # the sampled cohort of 4: byzantines 15..17 + one good, or 1 + 3 good
    sampled[[15, 16, 17, 0] if majority else [15, 0, 1, 2]] = True
    it = {k: rng.randn(d).astype(np.float32)
          for k in ("x_now", "x_prev", "x0", "g_prev")}
    tctx = tstage.make_context(
        torch.from_numpy(honest), good_mask=torch.from_numpy(good),
        sampled=torch.from_numpy(sampled),
        **{k: torch.from_numpy(v) for k, v in it.items()})
    rctx = rstage.make_context(
        jnp.asarray(honest), good_mask=jnp.asarray(good),
        sampled=jnp.asarray(sampled),
        **{k: jnp.asarray(v) for k, v in it.items()})
    assert bool(tctx.byz_majority) == bool(rctx.byz_majority) == majority
    got = tstage.AttackStage(name).corrupt(tctx)
    want = rstage.AttackStage(name).corrupt(rctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gauss_attack_draws_from_generator_or_uses_given_noise():
    honest = torch.zeros(6, 5)
    ctx = tstage.make_context(honest, good_mask=torch.arange(6) < 4,
                              sampled=torch.ones(6, dtype=torch.bool),
                              key=torch.Generator().manual_seed(0))
    a = tatt.make_attack("gauss", scale=2.0)(ctx)
    b = tatt.make_attack("gauss", scale=2.0)(
        ctx.replace(key=torch.Generator().manual_seed(0)))
    torch.testing.assert_close(a, b)
    noise = torch.randn(6, 5)
    torch.testing.assert_close(tatt.make_attack("gauss")(ctx.replace(
        key=noise)), 10.0 * noise)
    with pytest.raises(ValueError, match="takes no parameter"):
        tatt.make_attack("shb", scale=1.0)
    assert set(tatt.ATTACKS) == set(ratt.ATTACKS)
    assert tatt.ATTACK_PARAMS == ratt.ATTACK_PARAMS
