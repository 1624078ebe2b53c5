"""The port's mesh trainer and decode launcher against the reference, in
this process (tests/test_torch_train_mesh.py runs eight ranks).

- The trainer's configuration: ``resolve_plan``'s default, ``from_plan``,
  PlanError for a compressor other than RandK by fraction and for shb
  (test_train_cfg_validation), ValueError for an adaptive attack.
- ``_leafwise_randk`` on the reference's uniforms (``jax.random.uniform``
  of each leaf's split key): the same keep masks and values, rtol 1e-6.
- ``TreeAttackStage`` against the reference's on a worker-stacked tree
  for bf, sf, lf, alie, ipm and gauss (gauss on the reference's noise,
  drawn from ``fold_in(key, i)`` per leaf), rtol 1e-6.
- ``_make_leaf_agg`` (tests/test_mesh_trainer.py:56-116 and :573-586)
  against numpy and the reference's leaf aggregation, Bucketing fed the
  reference's permutation, atol 2e-5 as there.
- The (1, 1) trainer: 4 steps (p = 0.5: a full round, then three
  difference rounds) of a 2-layer d_model 64 model in f32 on the
  reference's draws (the key chain of ``src/repro/launch/train.py:282-298``
  recomputed here) against the reference's ``make_train_step`` on
  ``make_debug_mesh(1, 1)``: params and g within 1e-5 of each leaf's
  max-abs after every step.  The port runs a one-rank gloo group.
- ``abstract_state`` on meta tensors: the reference's params and g shapes
  and dtypes.
- ``main --ckpt-dir``: a checkpoint that ``repro.checkpoint.restore``
  reads with the reference's template, equal to the port's own restore.
- Decode: ``make_serve_step`` against the reference's on the decodable
  smoke configs with the reference's weights (f32): the same next tokens
  and logits within 1e-4 of their max-abs over 4 steps; ``_main_decode``
  and ``serve_demo`` with ``--device cpu``.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.api as RA
import repro_torch.api as TA
from _torch_models import DECODABLE, Pair, to_jax, to_torch
from repro.launch import train as rt
from repro_torch.core.tree_utils import tree_flatten, tree_map, tree_unflatten
from repro_torch.launch import train as tt
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.scenarios import TreeAttackStage

TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=256, remat=False, dtype="float32")
REL = 1e-5  # the trainer, of each leaf's max-abs
STAGE_RTOL = 1e-6
AGG_ATOL = 2e-5
DECODE_REL, DECODE_STEPS = 1e-4, 4
ATTACKS = ("bf", "sf", "lf", "alie", "ipm", "gauss")


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process, and its (1, 1) mesh."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method="file://" + os.path.join(tmp, "r"))
        try:
            yield make_debug_mesh(1, 1)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_train_cfg_validation(one_rank):
    from repro_torch.models import ModelConfig

    plan = tt.resolve_plan(tt.ByzTrainConfig(n_byz=2, C=3))
    assert plan == TA.ServerPlan.from_json(
        rt.resolve_plan(rt.ByzTrainConfig(n_byz=2, C=3)).to_json())
    assert plan.schedule.placement == "sharded"
    assert plan.aggregate.rule == "cm" and plan.clip.alpha == 2.0
    mean = TA.ServerPlan(aggregate=TA.AggregatorSpec("mean"))
    cfg = tt.ByzTrainConfig.from_plan(mean, gamma=0.5, n_byz=1)
    assert cfg.plan is mean and tt.resolve_plan(cfg) is mean
    assert (cfg.gamma, cfg.n_byz, cfg.p) == (0.5, 1, 0.125)
    with pytest.raises(ValueError, match="unknown aggregator"):
        TA.AggregatorSpec("nope")
    model = ModelConfig(**TINY)
    for kind in ("rand_k", "identity", "l2_quantization"):
        bad = TA.ServerPlan(aggregate=TA.AggregatorSpec("cm"),
                            compress=TA.CompressSpec(kind, k=3))
        with pytest.raises(TA.PlanError, match="rand_fraction"):
            tt.make_train_step(model, one_rank,
                               tt.ByzTrainConfig.from_plan(bad))
    with pytest.raises(TA.PlanError, match="reads the iterates"):
        tt.make_train_step(model, one_rank, tt.ByzTrainConfig(attack="shb"))
    from repro_torch.api import ScenarioSpec

    adaptive = ScenarioSpec(attack="adaptive").build(mean)
    with pytest.raises(ValueError, match="adaptive"):
        TreeAttackStage(adaptive)


# ---------------------------------------------------------------------------
# worker-side messages
# ---------------------------------------------------------------------------

def _np_tree(seed, lead=()):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(*lead, 6, 32).astype(np.float32),
            "b": {"c": rng.randn(*lead, 17).astype(np.float32),
                  "d": rng.randn(*lead, 3, 2, 5).astype(np.float32)}}


def test_leafwise_randk_on_the_reference_uniforms():
    tree = _np_tree(0)
    for frac in (0.5, 0.1, 1.0):
        key = jax.random.PRNGKey(3)
        want = rt._leafwise_randk(key, to_jax(tree), frac)
        leaves = jax.tree_util.tree_leaves(tree)
        ks = jax.random.split(key, len(leaves))
        uniforms = [np.asarray(jax.random.uniform(k, (x.size,)))
                    for k, x in zip(ks, leaves)]
        got = tt._leafwise_randk(uniforms, tree_map(torch.from_numpy, tree),
                                 frac)
        for g, w in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(want)):
            w = np.asarray(w)
            assert np.array_equal(g.numpy() != 0, w != 0), frac
            np.testing.assert_allclose(g.numpy(), w, rtol=STAGE_RTOL, atol=0)


@pytest.mark.parametrize("attack", ATTACKS)
def test_tree_attack_stage_matches_the_reference(attack):
    from repro.scenarios.stage import TreeAttackStage as RStage

    W = 5
    tree = _np_tree(1, (W,))
    good = np.array([True, True, True, False, False])
    sampled = np.array([True, False, True, True, True])
    key = jax.random.PRNGKey(9)
    want = RStage(attack).corrupt_tree(
        to_jax(tree), good_mask=jnp.asarray(good),
        sampled=jnp.asarray(sampled), key=key)
    leaves = jax.tree_util.tree_leaves(tree)
    noise = [np.array(jax.random.normal(jax.random.fold_in(key, i),
                                          (W, x[0].size), jnp.float32))
             for i, x in enumerate(leaves)]
    tree_t = tree_map(torch.from_numpy, tree)
    got = TreeAttackStage(attack).corrupt_tree(
        tree_t, good_mask=torch.from_numpy(good),
        sampled=torch.from_numpy(sampled),
        key=[torch.from_numpy(n) for n in noise])
    for g, w, h in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(want),
                       leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=STAGE_RTOL, atol=1e-7)
        # honest rows pass through untouched, byzantine rows do not
        assert np.array_equal(g.numpy()[good], h[good])
        assert not np.array_equal(g.numpy()[~good], h[~good])
    # a generator draws the same way on every call it is given anew
    a = TreeAttackStage(attack).corrupt_tree(
        tree_t, good_mask=torch.from_numpy(good),
        sampled=torch.from_numpy(sampled),
        key=torch.Generator().manual_seed(0))
    b = TreeAttackStage(attack).corrupt_tree(
        tree_t, good_mask=torch.from_numpy(good),
        sampled=torch.from_numpy(sampled),
        key=torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in
               zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def test_tree_attack_stage_none_and_iterates():
    tree = tree_map(torch.from_numpy, _np_tree(2, (3,)))
    mask = torch.tensor([True, True, False])
    assert TreeAttackStage("none").corrupt_tree(
        tree, good_mask=mask, sampled=mask, key=None) is tree
    with pytest.raises(ValueError, match="reads the iterates"):
        TreeAttackStage("shb").corrupt_tree(tree, good_mask=mask,
                                            sampled=mask, key=None)


# ---------------------------------------------------------------------------
# _make_leaf_agg (tests/test_mesh_trainer.py's leaf cases)
# ---------------------------------------------------------------------------

def _mk_cfg(api, train, name, *, backend, n_byz=0, trim_ratio=0.25):
    bucket_s = 0
    if name.startswith("bucket_"):
        name, bucket_s = name[len("bucket_"):], 2
    plan = api.ServerPlan(
        aggregate=api.AggregatorSpec(name, trim_ratio=trim_ratio,
                                     byz_bound=n_byz),
        bucket=api.BucketSpec(s=bucket_s) if bucket_s else None,
        schedule=api.ScheduleSpec(backend=backend))
    return train.ByzTrainConfig.from_plan(plan, n_byz=n_byz)


def _leaf_agg(name, **kw):
    return tt._make_leaf_agg(_mk_cfg(TA, tt, name, backend="torch", **kw))


def test_leaf_agg_cm_tm_mean():
    rng = np.random.RandomState(0)
    leaf = rng.randn(9, 3, 4).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 0, 1], bool)
    out = _leaf_agg("cm")(torch.from_numpy(leaf), torch.from_numpy(mask),
                          None)
    assert out.shape == (3, 4)
    np.testing.assert_allclose(out.numpy(), np.median(leaf[mask], axis=0),
                               atol=1e-6)
    leaf = np.random.RandomState(1).randn(10, 5).astype(np.float32)
    out = _leaf_agg("tm", trim_ratio=0.2)(torch.from_numpy(leaf),
                                           torch.ones(10, dtype=torch.bool),
                                           None)
    np.testing.assert_allclose(out.numpy(),
                               np.sort(leaf, axis=0)[2:8].mean(axis=0),
                               atol=1e-5)
    leaf = torch.arange(12.0).reshape(4, 3)
    out = _leaf_agg("mean")(leaf, torch.tensor([True, False, True, False]),
                            None)
    np.testing.assert_allclose(out.numpy(), ((leaf[0] + leaf[2]) / 2).numpy())


def test_leaf_agg_registry_matches_the_reference():
    rng = np.random.RandomState(2)
    leaf = rng.randn(8, 3, 5).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], bool)
    key = jax.random.PRNGKey(7)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, 8)))
    factors = rng.rand(8).astype(np.float32)
    for name in ("cm", "tm", "mean", "cclip", "rfa", "krum", "multi_krum",
                 "bucket_cm", "bucket_krum", "bucket_rfa"):
        ra = rt._make_leaf_agg(_mk_cfg(RA, rt, name, backend="jnp",
                                       n_byz=1))
        ta = _leaf_agg(name, n_byz=1)
        for f in (None, factors):
            want = ra(jnp.asarray(leaf), jnp.asarray(mask), key,
                      factors=None if f is None else jnp.asarray(f))
            got = ta(torch.from_numpy(leaf), torch.from_numpy(mask), perm,
                     factors=None if f is None else torch.from_numpy(f))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=AGG_ATOL,
                                       err_msg=f"{name} {f is not None}")


def test_leaf_agg_bucketed_cm_resists_outlier_minority():
    rng = np.random.RandomState(3)
    leaf = np.concatenate([rng.randn(10, 4).astype(np.float32),
                           1e6 * np.ones((2, 4), np.float32)])
    perm = torch.from_numpy(np.asarray(jax.random.permutation(
        jax.random.PRNGKey(1), 12)))
    out = _leaf_agg("bucket_cm")(torch.from_numpy(leaf),
                                 torch.ones(12, dtype=torch.bool), perm)
    assert np.abs(out.numpy()).max() < 10.0


def test_cclip_leaf_agg_matches_core():
    from repro_torch.core.aggregators import centered_clip

    rng = np.random.RandomState(11)
    leaf = torch.from_numpy(rng.randn(8, 3, 5).astype(np.float32))
    mask = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.bool)
    out = _leaf_agg("cclip")(leaf, mask, None)
    ref = centered_clip(tau=10.0, iters=5)(leaf.reshape(8, -1), mask=mask)
    np.testing.assert_allclose(out.numpy(), ref.reshape(3, 5).numpy(),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the (1, 1) trainer against the reference's
# ---------------------------------------------------------------------------

def _reference_run(steps, b, seq):
    """The reference's 4 steps on make_debug_mesh(1, 1): its batches,
    start state, draws and every step's (params, g), as numpy."""
    from repro.data.pipeline import make_batch_iterator
    from repro.launch.mesh import make_debug_mesh as r_mesh
    from repro.launch.mesh import set_mesh
    from repro.models import ModelConfig, apply_train, init_params

    cfg = ModelConfig(**TINY)
    tc = rt.ByzTrainConfig(gamma=0.3, attack="bf", p=0.5)
    mesh = r_mesh(1, 1)
    it = make_batch_iterator(cfg, b, seq, seed=3)
    batches = [jax.tree_util.tree_map(np.asarray, next(it))
               for _ in range(steps + 1)]
    draws = {"c": [], "sampled": [], "order": []}
    key = jax.random.PRNGKey(1)
    for _ in range(steps):  # the step's key chain (W = 1: all sampled)
        key, kb, _, _, _, kg = jax.random.split(key, 6)
        draws["c"].append(bool(jax.random.bernoulli(kb, tc.p)))
        draws["sampled"].append([True])
        draws["order"].append(np.asarray(jax.random.permutation(kg, 1)))
    with set_mesh(mesh):
        params = init_params(jax.random.PRNGKey(0), cfg)
        g0 = jax.grad(lambda p: apply_train(p, cfg, batches[0])[0])(params)
        state = rt.MeshTrainState(params=params, g=g0,
                                  key=jax.random.PRNGKey(1),
                                  step=jnp.int32(0))
        step = jax.jit(rt.make_train_step(cfg, mesh, tc))
        start = jax.tree_util.tree_map(np.asarray, (params, g0))
        traj = []
        for k in range(steps):
            state = step(state, batches[k + 1])
            traj.append(jax.tree_util.tree_map(np.asarray,
                                               (state.params, state.g)))
    return batches, start, draws, traj


def test_one_rank_trainer_follows_the_reference(one_rank):
    from repro_torch.models import ModelConfig, params_from_numpy
    from repro_torch.sharding.rules import state_sharding

    batches, (p0, g0), draws, traj = _reference_run(4, 2, 32)
    assert draws["c"] == [True, False, False, False]  # both branches
    cfg = ModelConfig(**TINY)
    tape = tt.TrainTape(c=np.array(draws["c"]),
                        sampled=np.array(draws["sampled"]),
                        order=np.array(draws["order"]))
    state = tt.MeshTrainState(params_from_numpy(p0, "cpu"),
                              params_from_numpy(g0, "cpu"), tt.train_key(0),
                              torch.zeros((), dtype=torch.int32))
    tc = tt.ByzTrainConfig(gamma=0.3, attack="bf", p=0.5)
    step = tt.make_train_step(cfg, one_rank, tc)
    for k in range(4):
        state = step(state, to_torch(batches[k + 1]), tape)
        for what, got, want in zip(("params", "g"), (state.params, state.g),
                                   traj[k]):
            for i, (a, w) in enumerate(zip(tree_flatten(got)[0],
                                           jax.tree_util.tree_leaves(want))):
                err = np.abs(a.numpy() - w).max()
                assert err <= REL * np.abs(w).max(), (k, what, i, err)
    assert int(state.step) == 4 and state.step.dtype == torch.int32
    # one rank: every leaf's piece is the whole leaf
    specs = tt.state_specs(one_rank, cfg, state, tc)
    cut = state_sharding(one_rank, specs)
    for rule, leaf in zip(tree_flatten(cut.params)[0],
                          tree_flatten(state.params)[0]):
        assert torch.equal(rule(leaf), leaf)


def test_trainer_own_draws_are_deterministic(one_rank):
    """Without a tape, the step draws from the generator in ``key``: the
    same key gives the same step, and the key advances."""
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.models import ModelConfig, init_params

    cfg = ModelConfig(**TINY)
    params = init_params(0, cfg, device="cpu")
    g = tree_unflatten(tree_flatten(params)[1],
                       tt.worker_grads(params, cfg,
                                       next(make_batch_iterator(
                                           cfg, 2, 16, device="cpu"))))
    state = tt.MeshTrainState(params, g, tt.train_key(5),
                              torch.zeros((), dtype=torch.int32))
    batch = next(make_batch_iterator(cfg, 2, 16, seed=1, device="cpu"))
    step = tt.make_train_step(cfg, one_rank, tt.ByzTrainConfig(gamma=0.1))
    a, b = step(state, batch), step(state, batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0],
                                                 tree_flatten(b)[0]))
    assert not torch.equal(a.key, state.key)


def test_on_aggregate_sees_the_aggregate_and_one_rank_axes_move_nothing(
        one_rank):
    """``on_aggregate`` gets each step's coin and whole aggregate, which
    g+ is made of (full round: agg; difference round: g + agg in f32,
    cast back); over the (1, 1) mesh's axes no all_to_all and no
    all-gather runs (the clip factors' all_reduces still do)."""
    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.models import ModelConfig, init_params

    cfg = ModelConfig(**TINY).replace(dtype="bfloat16")
    it = make_batch_iterator(cfg, 2, 16, seed=2, device="cpu")
    params = init_params(0, cfg, device="cpu")
    g = tree_unflatten(tree_flatten(params)[1],
                       tt.worker_grads(params, cfg, next(it)))
    state = tt.MeshTrainState(params, g, tt.train_key(0),
                              torch.zeros((), dtype=torch.int32))
    tape = tt.TrainTape(c=np.array([True, False]),
                        sampled=np.ones((2, 1), bool),
                        order=np.zeros((2, 1), np.int64))
    seen = []
    step = tt.make_train_step(cfg, one_rank, tt.ByzTrainConfig(gamma=0.1),
                              on_aggregate=lambda c, agg: seen.append(
                                  (c, agg)))
    reset_collective_counts()
    for k in range(2):
        new = step(state, next(it), tape)
        c, agg = seen[k]
        assert c == bool(tape.c[k])
        for a, g0, g1 in zip(agg, tree_flatten(state.g)[0],
                             tree_flatten(new.g)[0]):
            want = a if c else g0.float() + a.float()
            assert torch.equal(g1, want.to(g0.dtype))
        state = new
    assert set(collective_counts()) == {"all_reduce"}


def test_abstract_state_matches_the_reference():
    from repro.configs import get_config as rget
    from repro.models import ModelConfig as RCfg
    from repro_torch.configs import get_config
    from repro_torch.models import ModelConfig

    for rcfg, cfg in ((RCfg(**TINY), ModelConfig(**TINY)),
                      (rget("minitron_8b"), get_config("minitron_8b"))):
        want = rt.abstract_state(rcfg, rt.ByzTrainConfig())
        got = tt.abstract_state(cfg, tt.ByzTrainConfig())
        for tree_w, tree_g in ((want.params, got.params), (want.g, got.g)):
            wl = jax.tree_util.tree_leaves(tree_w)
            gl = tree_flatten(tree_g)[0]
            assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
            assert [str(x.dtype).split(".")[-1] for x in gl] == \
                [str(x.dtype) for x in wl]
            assert all(x.device.type == "meta" for x in gl)
        assert got.key.dtype == torch.uint8 and got.step.dtype == torch.int32


def test_main_checkpoint_reads_in_the_reference(one_rank, tmp_path, capsys):
    import repro.checkpoint as rckpt
    from repro.configs import get_smoke_config as rsmoke
    from repro.models import init_params as rinit
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params

    tt.main(["--smoke", "--steps", "2", "--seq", "16", "--per-worker-batch",
             "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "[train] step    1 loss" in text and "checkpoint:" in text
    rcfg = rsmoke("minitron_8b").replace(dtype="float32", remat=False)
    want = rckpt.restore(str(tmp_path), 2,
                         jax.eval_shape(lambda: rinit(jax.random.PRNGKey(0),
                                                      rcfg)))
    cfg = get_smoke_config("minitron_8b").replace(dtype="float32",
                                                  remat=False)
    got = restore(str(tmp_path), 2, init_params(0, cfg, device="cpu"))
    for a, w in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODABLE)
def test_serve_step_matches_the_reference(arch):
    from repro.launch.serve import make_serve_step as rstep
    from repro.models import init_cache as rcache
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import init_cache

    pair = Pair(arch)
    B = 2
    ref_step = jax.jit(rstep(pair.rcfg))
    step = make_serve_step(pair.tcfg)
    rc = rcache(pair.rcfg, B, DECODE_STEPS)
    tc = init_cache(pair.tcfg, B, DECODE_STEPS, device="cpu")
    batch = {k: v for k, v in pair.batch.items()}
    tok = batch["tokens"][:B, :1]
    for t in range(DECODE_STEPS):
        b = dict(batch, tokens=tok)
        rn, rl, rc = ref_step(pair.ref_params, to_jax(b), rc, t)
        tn, tl, tc = step(pair.params, to_torch(b), tc, t)
        assert tn.dtype == torch.int32
        assert np.array_equal(tn.numpy(), np.asarray(rn)), (arch, t)
        err = np.abs(tl.numpy() - np.asarray(rl)).max()
        assert err <= DECODE_REL * np.abs(np.asarray(rl)).max(), (arch, t)
        tok = np.asarray(rn)[:, None]


def test_abstract_serve_inputs_match_the_reference():
    from repro.configs import get_config as rget
    from repro.launch.serve import abstract_serve_inputs as rabs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import abstract_serve_inputs

    for arch in ("minitron_8b", "llama32_vision_90b"):
        want = rabs(rget(arch), 8, 1024)
        got = abstract_serve_inputs(get_config(arch), 8, 1024)
        wl = jax.tree_util.tree_leaves(want)
        gl = tree_flatten(got)[0]
        assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
        assert [str(x.dtype).split(".")[-1] for x in gl] == \
            [str(x.dtype) for x in wl]


def test_decode_launcher_and_demo_run_on_the_cpu(capsys):
    from repro_torch import serve_demo
    from repro_torch.launch import serve

    serve.main(["--mode", "decode", "--arch", "jamba_v01_52b", "--batch",
                "2", "--tokens", "3", "--device", "cpu"])
    assert "3 tokens x batch 2" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert_xlarge", "--device", "cpu"])
    serve_demo.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                     "--tokens", "4"])
    assert capsys.readouterr().out.rstrip().endswith("OK")
