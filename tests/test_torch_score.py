"""The port's robust-scoring endpoint (``repro_torch.launch.serve``
``make_scoring_step`` and ``--mode score``) against the reference's on
the CPU: the same aggregates, distances, clip factors and norms within
rtol 1e-5, for Krum and CM with and without a static radius and with a
partial ``batch_mask``; Bucketing's per-request order is fed from the
reference's own keys as permutations."""
import jax
import numpy as np
import pytest
import torch

from repro.api import AggregatorSpec as RAggregatorSpec
from repro.api import BucketSpec as RBucketSpec
from repro.api import ClipSpec as RClipSpec
from repro.api import ScheduleSpec as RScheduleSpec
from repro.api import ServerPlan as RServerPlan
from repro.launch.serve import make_scoring_step as rmake_scoring_step
from repro_torch.api import ClipSpec, PlanError, ScheduleSpec, ServerPlan
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch

CPU = "cpu"
B, N, D, N_BYZ = 4, 10, 48, 2


def _batch(seed=0):
    xs = np.random.RandomState(seed).randn(B, N, D).astype(np.float32)
    xs[:, N - N_BYZ:, :] *= 100.0  # as the launcher's synthetic batch
    return xs


def _plans(rule, radius, bucket_s, backend):
    rplan = RServerPlan(
        aggregate=RAggregatorSpec(rule, byz_bound=N_BYZ),
        clip=RClipSpec(radius=radius) if radius else None,
        bucket=RBucketSpec(s=bucket_s) if bucket_s else None,
        schedule=RScheduleSpec(placement="naive", backend="jnp"))
    tplan = ServerPlan.from_json(rplan.to_json().replace('"jnp"',
                                                         f'"{backend}"'))
    return rplan, tplan


@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "partial"])
@pytest.mark.parametrize("rule,radius,bucket_s", [
    ("krum", 5.0, 0), ("krum", None, 0), ("cm", None, 0), ("cm", 5.0, 0),
    ("cm", 5.0, 2)])
def test_scoring_step_matches_reference(rule, radius, bucket_s, masked,
                                        backend):
    rplan, tplan = _plans(rule, radius, bucket_s, backend)
    xs = _batch(1)
    mask = None
    if masked:
        mask = np.random.RandomState(2).rand(B, N) > 0.3
        mask[:, :3] = True  # every request keeps enough rows
    key = jax.random.PRNGKey(2)
    want = rmake_scoring_step(rplan)(xs, batch_mask=mask, key=key)
    # the reference's per-request keys, replayed as permutations
    perms = np.stack([np.asarray(jax.random.permutation(k, N))
                      for k in jax.random.split(key, B)])
    ops.reset_launch_counts()
    got = tlaunch.make_scoring_step(tplan, CPU)(xs, batch_mask=mask,
                                                 key=perms)
    assert sum(ops.launch_counts().values()) == 0
    assert set(got) == {"aggregate", "distance", "clip_factor", "norm"}
    assert got["aggregate"].shape == (B, D)
    for name in ("distance", "clip_factor", "norm"):
        assert got[name].shape == (B, N)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if radius is None:
        assert torch.all(got["clip_factor"] == 1.0)
    # the 100x payloads are the outliers of every request
    dist = got["distance"].numpy()
    flagged = dist > np.median(dist, axis=1, keepdims=True) * 3.0
    assert flagged[:, N - N_BYZ:].all() and not flagged[:, :N - N_BYZ].any()


def test_scoring_keys_default_to_per_request_generators():
    """None or an int seed gives request b the generator round_key(seed,
    b); the same orders passed as permutations give the same results."""
    from repro_torch.serve import round_key

    _, tplan = _plans("cm", 5.0, 2, "torch")
    score = tlaunch.make_scoring_step(tplan, CPU)
    xs = _batch(3)
    perms = np.stack([torch.randperm(N, generator=round_key(7, b)).numpy()
                      for b in range(B)])
    a, b = score(xs, key=7), score(xs, key=perms)
    for name in a:
        np.testing.assert_array_equal(a[name].numpy(), b[name].numpy())
    c, d = score(xs), score(xs, key=0)
    np.testing.assert_array_equal(c["aggregate"].numpy(),
                                  d["aggregate"].numpy())
    with pytest.raises(ValueError, match="one permutation per request"):
        score(xs, key=perms[:2])


def test_scoring_plan_errors():
    base = ServerPlan.from_json(_plans("krum", 5.0, 0, "torch")[1].to_json())
    with pytest.raises(PlanError, match="naive"):
        tlaunch.make_scoring_step(
            ServerPlan(aggregate=base.aggregate, clip=base.clip,
                       schedule=ScheduleSpec(placement="sharded")), CPU)
    with pytest.raises(PlanError, match="iterate pair"):
        tlaunch.make_scoring_step(
            ServerPlan(aggregate=base.aggregate, clip=ClipSpec(alpha=1.0),
                       schedule=base.schedule), CPU)


def test_scoring_runs_on_the_card_unless_told_otherwise():
    _, tplan = _plans("cm", None, 0, "auto")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.make_scoring_step(tplan)


@pytest.mark.parametrize("rule,radius", [("krum", "5.0"), ("cm", "0")])
def test_score_launcher_runs_on_the_cpu(capsys, rule, radius):
    tlaunch.main(["--mode", "score", "--aggregator", rule, "--requests", "3",
                  "--clients", "16", "--dim", "64", "--clip-radius", radius,
                  "--n-byz", "4", "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"scored 3 requests x 16 clients x d=64 (rule={rule}" in text
    assert "outliers flagged per request: [4, 4, 4]" in text
