"""The port's mesh aggregation (``ServerPlan.build(mesh)``,
``repro_torch.api.mesh_exec``) on ``torch.distributed`` with gloo, on the
CPU, against the reference's (tests/test_mesh_trainer.py,
tests/test_superleaf.py).

Eight ranks on a (data=4, model=2) mesh, as the reference fakes eight
devices, run in ONE spawned job per test function (``launch.mesh.spawn``,
a file rendezvous under a temporary directory): the whole registry x
clipped and unclipped x the naive, sharded-sequential and
sharded-pipelined schedules x superleaf_elems {0, 24}, on the tree of
tests/test_mesh_trainer.py:186-190 with the mask [T, T, F, T].  Every
rank's output must lie within atol 3e-5 of the reference's naive
``plan.build(make_debug_mesh(1, 1))`` on the same tree, computed in this
process, with Bucketing fed the reference's permutation; pipelined must
equal sequential bit for bit.  A second layout splits the leaf "a" over
"model" through ``base_specs``: every rank then holds and returns its
half, held against that half of the reference.  (With superleaf chunks,
the iterative rules aggregate each chunk, and a split leaf packs into
other chunks than the naive whole tree: that pair is compared only at
superleaf_elems 0.)  A (pod=2, data=2, model=2) mesh, whose workers are
enumerated by two axes, runs four rules (one of each kind) against the
same reference: the all_to_all over each worker axis in turn must land
every worker's chunk in worker order (the reference's sharded placement
does not on such a mesh: ROADMAP queue 3).  Whole-tree Krum on the mesh
runs the reference's 8-step recursion g += Agg(msgs(g)) and must equal
the port's engine form on the raveled tree bit for bit, with the
reference's winners.

The spawned ranks import this module to find their job; JAX is imported
only inside the functions that compute the reference, so the ranks never
load it.  The single-process tests run a one-rank gloo group.
"""
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.api as T
from repro_torch.api.mesh_exec import collective_counts, naive_aggregate
from repro_torch.api.mesh_exec import reset_collective_counts
from repro_torch.core.aggregators import Aggregator, make_aggregator
from repro_torch.core.tree_utils import tree_batch_ravel, tree_leaves, tree_map
from repro_torch.kernels.clip_aggregate import clip_factor, row_ssq
from repro_torch.launch.mesh import P, make_debug_mesh, spawn

RULES = ("cm", "tm", "mean", "cclip", "rfa", "krum", "multi_krum",
         "bucket_cm", "bucket_krum", "bucket_rfa")
ITERATIVE = ("cclip", "rfa", "bucket_rfa")
POD_RULES = ("cm", "rfa", "krum", "bucket_krum")
SCHEDULES = (("naive", "sequential"), ("sharded", "sequential"),
             ("sharded", "pipelined"))
MASK = [True, True, False, True]
W = 4
ATOL = 3e-5
SPAWN_TIMEOUT = 300


def _tree_np(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(W, 6, 32).astype(np.float32),
            "b": {"c": rng.randn(W, 17).astype(np.float32)}}


def _rule(agg):
    return (agg[7:], 2) if agg.startswith("bucket_") else (agg, 0)


def _plan(api, agg, placement="naive", blocks="sequential", sle=0,
          backend="torch", cohort=None):
    rule, s = _rule(agg)
    return api.ServerPlan(
        aggregate=api.AggregatorSpec(rule, byz_bound=1),
        bucket=api.BucketSpec(s=s) if s else None,
        schedule=api.ScheduleSpec(placement=placement, blocks=blocks,
                                  superleaf_elems=sle, backend=backend),
        cohort=cohort)


def _configs(layout):
    for agg in RULES:
        for radius in (3.0, None):
            for sle in (0, 24):
                if layout == "split" and sle and agg in ITERATIVE:
                    continue  # other chunks than the whole tree's
                yield agg, radius, sle


def _local(tree, d, m, layout):
    a = tree["a"][d:d + 1]
    if layout == "split":
        a = a[:, :, 16 * m:16 * (m + 1)]
    return {"a": torch.from_numpy(a.copy()),
            "b": {"c": torch.from_numpy(tree["b"]["c"][d:d + 1].copy())}}


def _registry_job(rank, perm):
    """One rank of the registry run: returns {(layout, agg, radius, sle,
    placement, blocks): [leaf arrays]} and the collective counts."""
    warnings.simplefilter("ignore")  # the PlanWarning of superleaf + rfa
    mesh = make_debug_mesh(4, 2)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    tree = _tree_np()
    mask, key = torch.tensor(MASK), torch.from_numpy(perm)
    out = {}
    reset_collective_counts()
    for layout, specs in (("whole", None),
                          ("split", {"a": P(None, "model"), "b": {"c": P()}})):
        local = _local(tree, d, m, layout)
        for agg, radius, sle in _configs(layout):
            for placement, blocks in SCHEDULES:
                step = _plan(T, agg, placement, blocks, sle).build(mesh)
                got = step(local, mask=mask, key=key, radius=radius,
                           base_specs=specs)
                out[(layout, agg, radius, sle, placement, blocks)] = [
                    x.numpy() for x in tree_leaves(got)]
    # two worker axes: (pod, data, model) = (2, 2, 2), worker 2 * pod + data
    pod = make_debug_mesh(2, 2, pod=2)
    w = 2 * pod.get_local_rank("pod") + pod.get_local_rank("data")
    local = _local(tree, w, 0, "whole")
    for agg in POD_RULES:
        for radius in (3.0, None):
            for placement, blocks in SCHEDULES:
                step = _plan(T, agg, placement, blocks).build(pod)
                got = step(local, mask=mask, key=key, radius=radius)
                out[("pod", agg, radius, 0, placement, blocks)] = [
                    x.numpy() for x in tree_leaves(got)]
    return out, collective_counts()


def _reference_outputs(perm_key):
    """The reference's naive step on a (1, 1) mesh, per (agg, radius,
    sle), as numpy leaves (a, b.c)."""
    import jax
    import jax.numpy as jnp
    import repro.api as R
    from repro.launch.mesh import make_debug_mesh as r_mesh
    from repro.launch.mesh import set_mesh

    tree = jax.tree_util.tree_map(jnp.asarray, _tree_np())
    mask = jnp.asarray(MASK)
    mesh = r_mesh(1, 1)
    ref = {}
    with warnings.catch_warnings(), set_mesh(mesh):
        warnings.simplefilter("ignore")
        for agg, radius, sle in _configs("whole"):
            step = _plan(R, agg, sle=sle, backend="jnp").build(mesh)
            r = None if radius is None else jnp.float32(radius)
            got = step(tree, mask, perm_key, radius=r)
            ref[(agg, radius, sle)] = [np.asarray(x) for x in
                                       jax.tree_util.tree_leaves(got)]
    return ref


def test_mesh_registry_matches_the_reference():
    import jax

    key = jax.random.PRNGKey(0)
    perm = np.asarray(jax.random.permutation(key, W))  # Bucketing's order
    ref = _reference_outputs(key)
    results = spawn(_registry_job, 8, (perm,), timeout=SPAWN_TIMEOUT)
    for rank, (outs, counts) in enumerate(results):
        m = rank % 2  # rank = 2 * data + model
        for (layout, agg, radius, sle, placement, blocks), got in \
                outs.items():
            want = ref[(agg, radius, sle)]
            if layout == "split":
                want = [want[0][:, 16 * m:16 * (m + 1)], want[1]]
            for g, w in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=ATOL,
                    err_msg=f"rank {rank} {layout} {agg} radius={radius} "
                            f"sle={sle} {placement}/{blocks}")
            if blocks == "pipelined":
                seq = outs[(layout, agg, radius, sle, placement,
                            "sequential")]
                for g, s in zip(got, seq):
                    assert np.array_equal(g, s), (rank, layout, agg, radius,
                                                  sle)
        # every schedule ran its collectives: the scatter, the gathers and
        # the row statistics' all-reduces
        assert {"all_to_all", "all_gather", "all_reduce"} <= set(counts)
        # CPU tensors: no collective took gloo's host staging of CUDA ones
        assert {c["route"] for c in counts.values()} == {"cpu"}


def _krum_job(rank, agg_names):
    """One rank of the whole-tree Krum recursion: the sharded mesh step
    and the engine form on the raveled tree, 8 steps each; returns each
    step's messages and both traces."""
    mesh = make_debug_mesh(4, 2)
    d = mesh.get_local_rank("data")
    base = tree_map(torch.from_numpy, _tree_np())
    mask = torch.tensor(MASK)
    byz = torch.arange(W) == 1  # a sampled byzantine worker sending -3x

    def messages(g):
        honest = tree_map(lambda b, gg: b + 0.3 * gg[None], base, g)
        return tree_map(lambda h: torch.where(
            byz.reshape((-1,) + (1,) * (h.ndim - 1)), -3.0 * h, h), honest)

    def factors(msgs):
        # the mesh's own arithmetic for each worker's global norm: each
        # rank's pass-1 sums of its row, leaf by leaf
        ssq = None
        for leaf in tree_leaves(msgs):
            part = torch.cat([row_ssq(leaf[w:w + 1].reshape(1, -1))
                              for w in range(W)])
            ssq = part if ssq is None else ssq + part
        return clip_factor(torch.sqrt(ssq), 2.5).float()

    out = {}
    for agg in agg_names:
        for clip in (True, False):
            step = _plan(T, agg, "sharded").build(mesh)
            eng = make_aggregator(agg, backend="torch", byz_bound=1)
            g1 = tree_map(lambda b: torch.zeros(b.shape[1:]), base)
            g2 = g1
            tr1, tr2, msgs_seen = [], [], []
            for _ in range(8):
                m1, m2 = messages(g1), messages(g2)
                local = tree_map(lambda x: x[d:d + 1].contiguous(), m1)
                a1 = step(local, mask=mask, radius=2.5 if clip else None)
                if clip:
                    a2 = eng.clip_then_aggregate(m2, 2.5, mask=mask,
                                                 factors=factors(m2))
                else:
                    a2 = eng(m2, mask=mask)
                g1 = tree_map(torch.add, g1, a1)
                g2 = tree_map(torch.add, g2, a2)
                msgs_seen.append(tree_batch_ravel(m1)[0].numpy())
                tr1.append(tree_batch_ravel(tree_map(lambda x: x[None], g1))
                           [0][0].numpy())
                tr2.append(tree_batch_ravel(tree_map(lambda x: x[None], g2))
                           [0][0].numpy())
            out[(agg, clip)] = (np.stack(msgs_seen), np.stack(tr1),
                                np.stack(tr2))
    return out


def test_whole_tree_mesh_krum_is_the_engine_form_bitwise():
    import jax.numpy as jnp
    from repro.core.aggregators import make_aggregator as r_make
    from repro.kernels.clip_aggregate import clip_factor as r_factor

    results = spawn(_krum_job, 8, (("krum", "multi_krum"),),
                    timeout=SPAWN_TIMEOUT)
    for (agg, clip), (msgs, tr_mesh, tr_eng) in results[0].items():
        for r in results[1:]:  # every rank holds the same trace
            assert np.array_equal(r[(agg, clip)][1], tr_mesh)
        assert np.array_equal(tr_mesh, tr_eng), (
            agg, clip, np.abs(tr_mesh - tr_eng).max())
        # each step's aggregate against the reference's engine on the
        # same messages: the same winners, the same rows
        ragg = r_make(agg, backend="jnp", byz_bound=1)
        steps = np.diff(np.concatenate([np.zeros_like(tr_mesh[:1]),
                                        tr_mesh]), axis=0)
        for t, x in enumerate(msgs):
            xj = jnp.asarray(x)
            if clip:
                f = r_factor(jnp.sqrt(jnp.sum(xj * xj, axis=1)), 2.5)
                want = ragg.clip_then_aggregate(xj, 2.5,
                                                mask=jnp.asarray(MASK),
                                                factors=f)
                rows = np.asarray(xj * f[:, None])
            else:
                want = ragg(xj, mask=jnp.asarray(MASK))
                rows = x
            np.testing.assert_allclose(steps[t], np.asarray(want), rtol=0,
                                       atol=ATOL, err_msg=f"{agg} {t}")
            if agg == "krum":
                near = np.abs(rows - np.asarray(want)[None]).max(axis=1)
                got = np.abs(rows - steps[t][None]).max(axis=1)
                assert int(np.argmin(got)) == int(np.argmin(near))


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp_path, "rdv"),
        rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _ragged_tree(n=6, seed=0):
    """tests/test_superleaf.py's ragged tree: odd widths, a stacked 0-d
    scalar, a nested bf16 leaf."""
    rng = np.random.RandomState(seed)
    return {
        "w": torch.from_numpy(rng.randn(n, 3, 5).astype(np.float32)),
        "scalar": torch.from_numpy(rng.randn(n).astype(np.float32)),
        "nested": {
            "b16": torch.from_numpy(rng.randn(n, 17)).to(torch.bfloat16),
            "odd": torch.from_numpy(rng.randn(n, 2, 1, 3).astype(np.float32)),
        },
    }


@pytest.fixture(params=["torch", "kernel-wrappers"])
def backend(request, monkeypatch):
    """"kernel-wrappers" routes every rule through the kernel wrappers,
    which run their plain versions on CPU tensors."""
    if request.param == "torch":
        return "torch"
    monkeypatch.setattr(Aggregator, "uses_kernels",
                        lambda self, xs: self.backend != "torch")
    return "auto"


# selections: bit for bit under any partition.  Sums over the rows: torch's
# CPU reduction over dim 0 picks its order by the width, so a chunk's
# column sums may round apart from the whole leaf's by an f32 unit
_EXACT_RULES = ("cm", "krum", "bucket_cm")
_SUM_RULES = ("tm", "mean", "multi_krum", "bucket_krum")


@pytest.mark.parametrize("rules", ["exact", "sums"])
def test_packed_naive_aggregate_bitwise_equals_per_leaf(one_rank, backend,
                                                        rules):
    """Coordinate-wise rules are partition-independent per coordinate and
    the selection rules make one whole-tree decision from the additive
    Gram: superleaf packing changes no bit of the naive output of the
    selections, clipped or not, bf16 leaf included, and moves the rules
    that sum rows by at most f32 rounding."""
    tree = _ragged_tree()
    mask = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.bool)
    perm = torch.randperm(6, generator=torch.Generator().manual_seed(3))
    for agg in _EXACT_RULES if rules == "exact" else _SUM_RULES:
        for radius in (2.0, None):
            outs = {chunk: _plan(T, agg, sle=chunk, backend=backend)
                    .build(one_rank)(tree, mask=mask, key=perm,
                                     radius=radius)
                    for chunk in (0, 13, 64)}
            for chunk in (13, 64):
                for a, b in zip(tree_leaves(outs[0]),
                                tree_leaves(outs[chunk])):
                    assert a.dtype == b.dtype
                    if rules == "exact":
                        assert torch.equal(a, b), (agg, radius, chunk)
                    elif a.dtype == torch.bfloat16:
                        torch.testing.assert_close(a, b, rtol=2 ** -7,
                                                   atol=0)
                    else:
                        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_pipelined_schedule_bitwise_equals_sequential_inprocess(one_rank,
                                                                backend):
    tree = tree_map(lambda x: x[:1], _ragged_tree())
    mask = torch.ones(1, dtype=torch.bool)
    for agg in ("cm", "cclip", "krum", "bucket_krum", "rfa"):
        for chunk in (0, 16):
            outs = {}
            for blocks in ("sequential", "pipelined"):
                with warnings.catch_warnings():  # superleaf + iterative
                    warnings.simplefilter("ignore")
                    step = _plan(T, agg, "sharded", blocks, chunk,
                                 backend=backend).build(one_rank)
                outs[blocks] = step(tree, mask=mask, radius=2.0)
            for a, b in zip(tree_leaves(outs["sequential"]),
                            tree_leaves(outs["pipelined"])):
                assert torch.equal(a, b), (agg, chunk)


def test_one_rank_sharded_equals_naive_and_the_engine(one_rank, backend):
    """On a (1, 1) mesh the sharded placement (W = 1 row, through the
    all_to_all and the all-reduces) equals the naive one, and the naive
    one is the single-process ``naive_aggregate``."""
    tree = tree_map(lambda x: x[:1], _ragged_tree())
    tree["nested"]["b16"] = tree["nested"]["b16"].float()
    mask = torch.ones(1, dtype=torch.bool)
    for agg in RULES:
        for radius in (2.0, None):
            naive = _plan(T, agg, backend=backend).build(one_rank)(
                tree, mask=mask, radius=radius)
            sharded = _plan(T, agg, "sharded", backend=backend).build(
                one_rank)(tree, mask=mask, radius=radius)
            agg_obj = _plan(T, agg, backend=backend).build_aggregator()
            f = None
            if radius is not None:
                flat = tree_batch_ravel(tree)[0]
                f = clip_factor(torch.linalg.vector_norm(flat, dim=1),
                                radius)
            plain = naive_aggregate(tree, mask, None, agg=agg_obj, factors=f)
            for a, b, c in zip(tree_leaves(naive), tree_leaves(sharded),
                               tree_leaves(plain)):
                torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
                torch.testing.assert_close(a, c, rtol=0, atol=ATOL)


def test_schedule_and_shape_validation(one_rank):
    tree = {"a": torch.ones(2, 4)}
    with pytest.raises(T.PlanError, match="unknown schedule"):
        T.ScheduleSpec(blocks="nope")
    with pytest.raises(T.PlanError, match="superleaf_elems"):
        T.ScheduleSpec(superleaf_elems=-1)
    with pytest.raises(ValueError, match="one row per worker"):
        # 2 rows on a 1-worker mesh: the scatter would drop a worker
        _plan(T, "cm", "sharded").build(one_rank)(
            tree, mask=torch.ones(2, dtype=torch.bool))
    with pytest.raises(T.PlanError, match="needs a mesh"):
        _plan(T, "cm", "sharded").build()
    with pytest.raises(T.PlanError, match="mesh-build argument"):
        _plan(T, "cm").build()(tree, base_specs={"a": P(None)})
    with pytest.raises(T.PlanError, match="exceeds the 1 available"):
        _plan(T, "cm", cohort=2).build(one_rank)
    with pytest.raises(T.PlanError, match="base_specs has 2 leaves"):
        _plan(T, "cm").build(one_rank)(
            tree, base_specs={"a": P(), "b": P()})


def test_meshes_name_the_world_size_they_need(one_rank):
    from repro_torch.launch import mesh as M

    with pytest.raises(ValueError, match="needs a world size of 256"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="needs a world size of 512"):
        M.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs a world size of 8"):
        M.make_debug_mesh(2, 2, pod=2)
    assert M.worker_axes(one_rank) == ("data",)
    assert M.num_workers(one_rank) == 1
    with M.set_mesh(one_rank) as active:
        assert active is one_rank
    assert repr(P(None, ("data", "model"))) == "P(None, ('data', 'model'))"


def test_server_step_stage_helpers():
    """``ServerStep.clips`` and ``.compress(key, x)``, which a trainer
    reads, as the reference's: compress is the plan's compressor, or the
    identity (the same object) without a compress stage."""
    x = torch.randn(40)
    bare = _plan(T, "cm").build()
    assert bare.mesh is None and not bare.clips
    assert bare.compress(None, x) is x
    plan = T.ServerPlan(aggregate="cm", clip=T.ClipSpec(radius=1.0),
                        compress=T.CompressSpec(kind="rand_k", k=10))
    step = plan.build()
    assert step.clips
    draw = torch.Generator().manual_seed(4)
    again = torch.Generator().manual_seed(4)
    got = step.compress(draw, x)
    assert torch.equal(got, step.compressor(again, x))
    assert int((got != 0).sum()) == 10
    assert T.ServerPlan.from_json(plan.to_json()).build().clips
