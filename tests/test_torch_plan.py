"""The port's ServerPlan against the reference's: the same canonical JSON
document drives both packages, and the same constructions fail."""
import warnings

import pytest

import repro.api as R
import repro_torch.api as T
from repro.configs.paper import paper_plan as ref_paper_plan
from repro_torch.configs.paper import fig1_marina_pp, paper_plan


def _both(build):
    """``build(api_module)`` in the reference and in the port."""
    return build(R), build(T)


@pytest.mark.parametrize("clip_alpha", [1.0, None], ids=["clip", "noclip"])
def test_fig1_plans_serialize_byte_equal(clip_alpha):
    ref = ref_paper_plan("cm", clip_alpha)
    port = paper_plan("cm", clip_alpha)
    assert port.to_json() == ref.to_json()
    assert T.ServerPlan.from_json(ref.to_json()) == port
    assert R.ServerPlan.from_json(port.to_json()) == ref
    cfg = fig1_marina_pp(clip_alpha is not None)
    assert cfg.plan.to_json() == ref.to_json()


@pytest.mark.parametrize("build", [
    lambda A: A.ServerPlan(aggregate=A.AggregatorSpec("tm", trim_ratio=0.2),
                           clip=A.ClipSpec(radius=2.5), cohort=4),
    lambda A: A.ServerPlan(aggregate=A.AggregatorSpec("mean"),
                           compress=A.CompressSpec("rand_k", k=3),
                           bucket=A.BucketSpec(s=3),
                           schedule=A.ScheduleSpec(backend="jnp")),
    lambda A: A.ServerPlan(aggregate=A.AggregatorSpec("krum", byz_bound=2),
                           schedule=A.ScheduleSpec(
                               placement="sharded", blocks="pipelined",
                               superleaf_elems=4096,
                               worker_axes=("pod", "data"))),
], ids=["tm-radius", "mean-randk-jnp", "krum-sharded"])
def test_other_plans_round_trip_byte_equal(build):
    ref, port = _both(build)
    assert port.to_json() == ref.to_json()
    assert T.ServerPlan.from_json(ref.to_json()).to_json() == ref.to_json()


BAD_PLANS = {
    "clip-neither": lambda A: A.ClipSpec(),
    "clip-both": lambda A: A.ClipSpec(alpha=1.0, radius=1.0),
    "clip-nonpositive": lambda A: A.ClipSpec(alpha=0.0),
    "compress-kind": lambda A: A.CompressSpec("top_k"),
    "compress-randk-k": lambda A: A.CompressSpec("rand_k", k=0),
    "compress-frac": lambda A: A.CompressSpec("rand_fraction", frac=1.5),
    "bucket-s": lambda A: A.BucketSpec(s=1),
    "rule": lambda A: A.AggregatorSpec("median"),
    "trim": lambda A: A.AggregatorSpec("trimmed_mean", trim_ratio=0.5),
    "byz-bound": lambda A: A.AggregatorSpec("krum", byz_bound=-1),
    "m-select-rule": lambda A: A.AggregatorSpec("krum", m_select=2),
    "tau": lambda A: A.AggregatorSpec("centered_clip", tau=0.0),
    "iters": lambda A: A.AggregatorSpec("rfa", iters=-1),
    "placement": lambda A: A.ScheduleSpec(placement="ring"),
    "blocks": lambda A: A.ScheduleSpec(blocks="async"),
    "superleaf": lambda A: A.ScheduleSpec(superleaf_elems=-1),
    "backend": lambda A: A.ScheduleSpec(backend="tpu"),
    "stage-type": lambda A: A.ServerPlan(aggregate=A.AggregatorSpec("cm"),
                                         clip=A.BucketSpec(s=2)),
    "cohort": lambda A: A.ServerPlan(aggregate="cm", cohort=0),
    "pipelined-naive": lambda A: A.ServerPlan(
        aggregate="cm", schedule=A.ScheduleSpec(blocks="pipelined")),
    "version": lambda A: A.ServerPlan.from_json(
        '{"version": 2, "aggregate": {"rule": "cm"}}'),
    "unknown-field": lambda A: A.ServerPlan.from_json(
        '{"aggregate": {"rule": "cm"}, "extra": 1}'),
    "no-aggregate": lambda A: A.ServerPlan.from_dict({}),
    "not-json": lambda A: A.ServerPlan.from_json("{nope"),
}


@pytest.mark.parametrize("name", sorted(BAD_PLANS))
def test_plan_errors_match_reference(name):
    build = BAD_PLANS[name]
    for api in (R, T):
        with pytest.raises(api.PlanError) as e:
            build(api)
        assert isinstance(e.value, ValueError)


def test_superleaf_on_iterative_rule_warns_in_both():
    for api in (R, T):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            api.ServerPlan(aggregate=api.AggregatorSpec("rfa"),
                           schedule=api.ScheduleSpec(superleaf_elems=64))
        assert any(issubclass(x.category, api.PlanWarning) for x in w)


def test_sharded_and_mesh_builds_name_their_roadmap_item():
    """Mesh builds are ported: the sharded placement without a mesh and a
    cohort larger than the mesh's workers raise the reference's
    PlanErrors (the mesh runs themselves: tests/test_torch_mesh.py)."""

    class FourWorkers:  # the two things a build reads of a mesh
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (4, 2)[dim]

    for api in (R, T):
        plan = api.ServerPlan(aggregate="cm",
                              schedule=api.ScheduleSpec(placement="sharded"))
        with pytest.raises(api.PlanError, match="needs a mesh"):
            plan.build()
    with pytest.raises(T.PlanError, match="exceeds the 4 available"):
        T.ServerPlan(aggregate="cm", cohort=5).build(mesh=FourWorkers())
    assert T.ServerPlan(aggregate="cm", cohort=4).build(
        mesh=FourWorkers()).mesh is not None


def test_unported_rules_and_compressors_raise_not_implemented():
    """Every rule and compressor kind of the reference now builds: the
    centered_clip plan gives the reference's aggregate, the rand_k plan
    the reference's compressed vector on the same draws."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    rng = np.random.RandomState(12)
    xs = rng.randn(9, 30).astype(np.float32)
    mask = rng.rand(9) > 0.3
    for bucket in (None, 2):
        doc = R.ServerPlan(
            aggregate=R.AggregatorSpec("centered_clip", tau=1.5, iters=3),
            clip=R.ClipSpec(radius=2.0),
            bucket=R.BucketSpec(s=bucket) if bucket else None,
            schedule=R.ScheduleSpec(placement="naive", backend="jnp"))
        ref = doc.build()
        step = T.ServerPlan.from_json(doc.to_json()).build()
        key = jax.random.PRNGKey(4)
        perm = torch.tensor(np.asarray(jax.random.permutation(key, 9)))
        got = step(torch.from_numpy(xs), mask=torch.from_numpy(mask),
                   key=perm)
        want = ref(jnp.asarray(xs), mask=jnp.asarray(mask), key=key)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    for rule in ("krum", "multi_krum"):  # ported with the serve slice
        assert T.ServerPlan(aggregate=rule).build().aggregator \
            .supports_two_phase
    plan = T.ServerPlan(aggregate="cm", compress=T.CompressSpec("rand_k", k=2))
    rplan = R.ServerPlan(aggregate="cm", compress=R.CompressSpec("rand_k", k=2))
    comp, rcomp = plan.build().compressor, rplan.build_compressor()
    x = rng.randn(30).astype(np.float32)
    key = jax.random.PRNGKey(8)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (30,))))
    np.testing.assert_allclose(comp(u, torch.from_numpy(x)).numpy(),
                               np.asarray(rcomp(key, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_server_step_radius_and_static_clip():
    import torch

    step = paper_plan("cm", 2.0).build()
    x_new, x_old = torch.tensor([3.0, 4.0]), torch.zeros(2)
    assert float(step.radius(x_new, x_old)) == pytest.approx(10.0)
    assert paper_plan("cm", None).build().radius(x_new, x_old) is None
    fixed = T.ServerPlan(aggregate="cm", clip=T.ClipSpec(radius=0.5)).build()
    assert fixed.radius(x_new, x_old) == 0.5
    xs = 10.0 * torch.ones(3, 4)
    # the static radius clips the rows (norm 20) to norm 0.5
    torch.testing.assert_close(fixed(xs), torch.full((4,), 0.25))
    # aggregate() is the unclipped form
    torch.testing.assert_close(fixed.aggregate(xs), torch.full((4,), 10.0))


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_rfa_plan_document_gives_the_same_aggregate_in_both(backend):
    """One plan document, ``AggregatorSpec("rfa", iters=3)`` over
    Bucketing(2), built by both packages: the same aggregate (clipped and
    not) on the same rows, mask and Bucketing order, and ``iters``
    reaches the rule (3 steps differ from the default 8)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    doc = R.ServerPlan(aggregate=R.AggregatorSpec("rfa", iters=3),
                       clip=R.ClipSpec(alpha=1.0), bucket=R.BucketSpec(s=2),
                       schedule=R.ScheduleSpec(backend=backend)).to_json()
    ref, port = R.ServerPlan.from_json(doc).build(), \
        T.ServerPlan.from_json(doc).build()
    rng = np.random.RandomState(12)
    xs = rng.randn(20, 300).astype(np.float32)
    mask = rng.rand(20) > 0.3
    key = jax.random.PRNGKey(4)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, 20)))
    xt, mt = torch.from_numpy(xs), torch.from_numpy(mask)
    xj, mj = jnp.asarray(xs), jnp.asarray(mask)
    np.testing.assert_allclose(port(xt, mt, key=perm, radius=2.0).numpy(),
                               np.asarray(ref(xj, mj, key=key, radius=2.0)),
                               rtol=0, atol=1e-5)
    got = port.aggregate(xt, mt, key=perm)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.aggregate(xj, mj, key=key)),
                               rtol=0, atol=1e-5)
    eight = T.ServerPlan(aggregate=T.AggregatorSpec("rfa"),
                         bucket=T.BucketSpec(s=2)).build()
    assert float((eight.aggregate(xt, mt, key=perm) - got).abs().max()) > 1e-6


@pytest.mark.parametrize("rule,bucket_s", [("krum", 0), ("multi_krum", 0),
                                           ("krum", 2), ("multi_krum", 2)])
@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_krum_plan_document_gives_the_same_aggregate_in_both(rule, bucket_s,
                                                             backend):
    """One Krum plan document (byz_bound, m_select, a static clip radius,
    optional Bucketing), built by both packages: the same aggregate,
    clipped and not, on the same rows, mask and Bucketing order."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    doc = R.ServerPlan(
        aggregate=R.AggregatorSpec(rule, byz_bound=2,
                                   m_select=3 if rule == "multi_krum" else 0),
        clip=R.ClipSpec(radius=4.0),
        bucket=R.BucketSpec(s=bucket_s) if bucket_s else None,
        schedule=R.ScheduleSpec(placement="naive", backend=backend)).to_json()
    ref, port = R.ServerPlan.from_json(doc).build(), \
        T.ServerPlan.from_json(doc).build()
    assert T.ServerPlan.from_json(doc).to_json() == doc
    rng = np.random.RandomState(21)
    xs = (rng.randn(16, 200) * rng.rand(16, 1) * 0.7).astype(np.float32)
    mask = rng.rand(16) > 0.2
    key = jax.random.PRNGKey(5)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, 16)))
    xt, mt = torch.from_numpy(xs), torch.from_numpy(mask)
    xj, mj = jnp.asarray(xs), jnp.asarray(mask)
    np.testing.assert_allclose(port(xt, mt, key=perm).numpy(),
                               np.asarray(ref(xj, mj, key=key)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.aggregate(xt, mt, key=perm).numpy(),
                               np.asarray(ref.aggregate(xj, mj, key=key)),
                               rtol=1e-5, atol=1e-6)
