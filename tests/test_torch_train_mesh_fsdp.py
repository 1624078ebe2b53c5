"""fsdp_tp's split over "data" (``sharding.rules.held_specs``,
``models.tp.gather_from_data``, ``launch.train``) on gloo ranks of the CPU,
against the reference's trainer on eight faked devices.

One reference subprocess runs the reference's ``make_train_step`` on a
(pod 2, data 2, model 2) debug mesh under fsdp_tp with
``worker_axes_override=("pod",)``: each pod is one worker, whose 4 batch
rows split over "data" (the reference's ``override_data_axes``).  It runs
the trainer's test model (TINY) and deepseek-v3-671b's smoke config (MLA,
MoE, the dense prefix, the MTP head; f32, remat on) for 4 steps (p = 0.5:
a full round, then three difference rounds, the default plan under bf at
gamma 0.3) and writes its draws (coins, cohorts, Bucketing orders), the
batches, its starting state and every step's params and g.  One spawn of
8 ranks replays both on a ``TrainTape``.  Each rank holds its "data" x
"model" pieces: its params and g must have exactly ``param_specs``'s
local shapes and lie within 1e-5 of each leaf's max-abs of the matching
slices of the reference's after every step.  The same spawn replays TINY
with the cross-entropy's count of valid positions left out of the sum
over "data" (a planted fault: each rank then divides by its own rows'
count), which must fail that limit, and takes ``held_norm`` of the
replayed g, which must equal ``tree_norm`` of the reference's whole g.

A spawn of 4 ranks, run while the reference computes, checks the "data"
gather against its plain twin on groups of 2 and 4 ranks in each of its
backward modes ("reduce_scatter" by ``gradcheck`` in f64 of the whole
computation, "keep" and "narrow" against the plain gradient),
``moe.route`` on the rows split over two "data" ranks against ``route``
on all of them (the same slots, keeps, capacity, load-balance and z
losses, with choices dropped), and the mamba2 and jamba smoke configs
under fsdp_tp (rows split over "data", and "data" a worker axis), TINY
with a vocabulary of 255, which "model" does not divide, and the
llama-3.2-vision smoke config with its gates opened and the hubert-xlarge
smoke config on frame inputs (each with its rows split over "data", the
vision rows with the tokens, the frames, targets and mask together),
against the whole model: the same loss, gradient pieces within 1e-5 of
max-abs; the llama-3.2-vision case once more in f64 (the layers' f32
casts made f64), within 1e-12; and the deepseek-v3 and jamba smoke
configs under zero3 (each rank its pieces of the "fsdp" slots over
"model", each layer gathered over "model", the rows split over it; and
v3 on 3 rows, which 2 does not divide, so that every rank runs them all
and keeps its piece of the gradient), within 1e-5.

JAX runs only in the reference subprocess.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           XLA_FLAGS="--xla_force_host_platform_device_count=8")
W, STEPS = 2, 4
REL = 1e-5  # of each leaf's max-abs
MESH = (2, 2, 2)  # pod, data, model
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=256, remat=False, dtype="float32")
MODELS = {"tiny": TINY,
          "v3": ("deepseek_v3_671b", dict(dtype="float32", remat=True))}
SPAWN_TIMEOUT = 300

REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.data.pipeline import make_batch_iterator
from repro.launch.mesh import make_debug_mesh, set_mesh
from repro.launch.train import (ByzTrainConfig, MeshTrainState,
                                make_train_step, state_specs)
from repro.models import ModelConfig, apply_train, init_params

STEPS, W = %(steps)d, %(W)d
MODELS = {"tiny": ModelConfig(**%(tiny)r),
          "v3": get_smoke_config(%(v3)r[0]).replace(**%(v3)r[1])}
mesh = make_debug_mesh(2, 2, pod=2)
tc = ByzTrainConfig(gamma=0.3, n_byz=1, attack="bf", p=0.5,
                    shard_mode="fsdp_tp", worker_axes_override=("pod",))
out = {}
for name, cfg in MODELS.items():
    it = make_batch_iterator(cfg, 8, 32, seed=3)
    batches = [jax.tree_util.tree_map(np.asarray, next(it))
               for _ in range(STEPS + 1)]
    for k, b in enumerate(batches):
        out[f"{name}_batch_{k}"] = b["tokens"]
    params = init_params(jax.random.PRNGKey(0), cfg)
    g0 = jax.jit(jax.grad(lambda p: apply_train(p, cfg, batches[0])[0]))(
        params)
    for i, (x, g) in enumerate(zip(jax.tree_util.tree_leaves(params),
                                   jax.tree_util.tree_leaves(g0))):
        out[f"{name}_params0_{i}"] = np.asarray(x)
        out[f"{name}_g0_{i}"] = np.asarray(g)
    with set_mesh(mesh):
        key = jax.random.PRNGKey(1)
        for k in range(STEPS):  # the step's key chain
            key, kb, kc, kq, ka, kg = jax.random.split(key, 6)
            out[f"{name}_c_{k}"] = np.array(bool(jax.random.bernoulli(
                kb, tc.p)))
            perm = np.asarray(jax.random.permutation(kc, W))
            rank = np.zeros(W, int)
            rank[perm] = np.arange(W)
            out[f"{name}_sampled_{k}"] = rank < W
            out[f"{name}_order_{k}"] = np.asarray(
                jax.random.permutation(kg, W))
        state = MeshTrainState(params=params, g=g0,
                               key=jax.random.PRNGKey(1), step=jnp.int32(0))
        sh = jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s),
            state_specs(mesh, cfg, state, tc),
            is_leaf=lambda x: isinstance(x, P))
        state = jax.device_put(state, sh)
        step = jax.jit(make_train_step(cfg, mesh, tc), out_shardings=sh)
        for k in range(STEPS):
            state = step(state, batches[k + 1])
            for i, (x, g) in enumerate(zip(
                    jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(state.g))):
                out[f"{name}_params_{k}_{i}"] = np.asarray(x)
                out[f"{name}_g_{k}_{i}"] = np.asarray(g)
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


def _model(name):
    from test_torch_train_mesh import model_config

    return model_config(MODELS[name])


def _config():
    from repro_torch.launch.train import ByzTrainConfig

    return ByzTrainConfig(gamma=0.3, n_byz=1, attack="bf", p=0.5,
                          shard_mode="fsdp_tp",
                          worker_axes_override=("pod",))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference subprocess, started before the module's first test
    (the unit checks run meanwhile); yields a function that waits for it
    and returns the npz path."""
    path = str(tmp_path_factory.mktemp("fsdp_ref") / "ref.npz")
    script = REF_SCRIPT % {"steps": STEPS, "W": W, "tiny": TINY,
                           "v3": MODELS["v3"]}
    proc = subprocess.Popen([sys.executable, "-c", script, path], env=ENV,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in out, err[-3000:]
        return path

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---------------------------------------------------------------------------
# the gather over "data" and the routing on split rows (4 ranks)
# ---------------------------------------------------------------------------

def _data_axes(size):
    """A ``DataAxis`` of every rank on groups of ``size`` consecutive ranks
    of the world (every rank makes every group, in one order)."""
    import torch.distributed as dist

    from repro_torch.sharding.constraints import DataAxis

    rank, world = dist.get_rank(), dist.get_world_size()
    group = None
    for lo in range(0, world, size):
        g = dist.new_group(list(range(lo, lo + size)))
        if lo <= rank < lo + size:
            group = g
    return DataAxis(group, rank % size, size, None)


def _gather_checks(data):
    """The "data" gather on ``data``'s group in each backward mode against
    its plain twin: {mode: (gradcheck passed or None, max error)}."""
    import dataclasses

    from repro_torch.models import tp

    r, n = data.rank, data.size
    gen = torch.Generator().manual_seed(7)
    f64 = dict(dtype=torch.float64)
    w = torch.randn(3, 4 * n, generator=gen, **f64)
    c = torch.arange(1, n + 1, **f64)  # each rank's own factor
    out = {}

    # rows split: each rank's partial product, summed (the loss); the
    # replicated input enters through the copy whose backward sums
    rs = dataclasses.replace(data, worker=False, rows=True)

    def split(w):
        piece = tp.copy_to_model(w, rs).narrow(1, 4 * r, 4)
        return tp.reduce_from_data(
            tp.gather_from_data(piece, rs, 1) * c[r], rs)

    wg = w.detach().requires_grad_(True)
    ok = torch.autograd.gradcheck(split, (wg,), eps=1e-6, atol=1e-8,
                                  rtol=1e-6)
    with torch.no_grad():
        err = float((split(wg) - tp.gather_from_model_plain(
            w.split(4, dim=1), 1) * c.sum()).abs().max())
    out["reduce_scatter"] = (bool(ok), err)

    # a worker axis: this rank's gradient of the gathered leaf, whole,
    # in its sink
    keep = dataclasses.replace(data, worker=True)
    piece = w.narrow(1, 4 * r, 4).clone().requires_grad_(True)
    sink = torch.zeros_like(w)
    loss = (tp.gather_from_data(piece, keep, 1, sink) * w * c[r]).sum()
    loss.backward()
    out["keep"] = (None, float((sink - w * c[r]).abs().max())
                   + float(piece.grad is not None))

    # every rank has every row: the same loss, this rank's piece of it
    nar = dataclasses.replace(data, worker=False, rows=False)
    piece = w.narrow(1, 4 * r, 4).clone().requires_grad_(True)
    (tp.gather_from_data(piece, nar, 1) ** 3).sum().backward()
    want = (3 * w ** 2).narrow(1, 4 * r, 4)
    out["narrow"] = (None, float((piece.grad - want).abs().max()))
    return out


def _route_checks(data):
    """``route`` on this rank's half of the tokens (the rows split over
    ``data``, 2 ranks) against ``route`` on all of them: the max
    differences of (slots, keeps, lb, z) on this rank's tokens, both
    capacities, and the choices dropped."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, moe

    cfg = get_smoke_config("deepseek_v3_671b").replace(dtype="float32")
    params = init_params(0, cfg, device="cpu")
    mo = params["body"][0]["mlp"]
    mo = {k: v[0] for k, v in mo.items() if k != "shared"}
    gen = torch.Generator().manual_seed(11)
    xt = torch.randn(64, cfg.d_model, generator=gen)
    rows = dataclasses.replace(data, worker=False, rows=True)
    # a low capacity factor, so that some choices are dropped
    whole = moe.route(mo, cfg, xt, 0.5)
    n = xt.shape[0] // data.size
    mine = slice(data.rank * n, (data.rank + 1) * n)
    got = moe.route(mo, cfg, xt[mine], 0.5, rows)
    diffs = [int((got[2] - whole[2][mine]).abs().max()),
             int((got[3] != whole[3][mine]).sum()),
             float((got[5][0] - whole[5][0]).abs()),
             float((got[5][1] - whole[5][1]).abs())]
    return diffs, (got[4], whole[4]), int((~whole[3]).sum())


def _split_checks(arch, mesh_shape, waxes, f64=False, mode="fsdp_tp",
                  rows=4):
    """The smoke config of ``arch`` (f32, or with ``f64`` its params, its
    vision rows and the layers' f32 casts f64; or ``SPLIT_MODELS[arch]``)
    under ``mode`` on this rank of ``mesh_shape``, on a batch of
    ``rows``: (its loss, the whole model's, the worst error of its
    gradient pieces of max-abs against the slices of the whole gradient,
    that leaf's index and name)."""
    from repro_torch.api.mesh_exec import _local_piece
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tree_utils import tree_flatten, tree_map
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import (model_axis_of, train_loss,
                                          worker_grads)
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.model import shard_params
    from repro_torch.sharding.rules import (_map_with_name, held_specs,
                                            only_axis)

    from test_torch_train_mesh import open_gates

    if arch in SPLIT_MODELS:
        cfg = ModelConfig(**SPLIT_MODELS[arch])
    else:
        cfg = get_smoke_config(arch).replace(dtype="float32")
    mesh = _mesh(mesh_shape)
    params = open_gates(init_params(0, cfg, device="cpu"), cfg)
    batch = next(make_batch_iterator(cfg, rows, 32, seed=3, device="cpu"))
    if f64:
        params = tree_map(lambda x: x.double(), params)
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    with _casts_to(torch.float64 if f64 else None):
        whole = worker_grads(params, cfg, batch)
        held = shard_params(params, mesh, cfg, mode)
        axis = model_axis_of(mesh, cfg, mode, waxes)
        got = worker_grads(held, cfg, batch, axis)
        losses = (train_loss(held, cfg, batch, mesh, mode, waxes),
                  train_loss(params, cfg, batch))
    specs = tree_flatten(held_specs(mesh, cfg, params, mode),
                         is_leaf=lambda x: isinstance(x, P))[0]
    names = tree_flatten(_map_with_name(lambda name, _: name, params))[0]
    worst, where = 0.0, None
    for i, (a, b, sp) in enumerate(zip(got, whole, specs)):
        if axis.data.worker:  # the worker's gradient, whole over "data"
            sp = only_axis(sp, "model")
        b = _local_piece(b, sp, mesh) if any(sp) else b
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if err >= worst:
            worst, where = err, (i, names[i])
    return (*losses, worst, where)


@contextlib.contextmanager
def _casts_to(dtype):
    """The model's f32 casts made ``dtype`` inside (None: as they are)."""
    from repro_torch.models import layers, model

    f32 = layers.F32
    if dtype is not None:
        layers.F32 = model.F32 = dtype
    try:
        yield
    finally:
        layers.F32 = model.F32 = f32


def _mesh(shape):
    from repro_torch.launch.mesh import make_debug_mesh

    if len(shape) == 2:
        return make_debug_mesh(*shape)
    return make_debug_mesh(shape[1], shape[2], pod=shape[0])


# TINY with a vocabulary that "model" does not divide: the unembedding
# stays whole over "model", and the cross-entropy must still add up the
# rows split over "data"
SPLIT_MODELS = {"tiny_v255": dict(TINY, name="tiny_v255", vocab=255)}
# the SSM and hybrid decoders under fsdp_tp: the rows split over "data"
# (pod workers) and "data" a worker axis; TINY's unsplit vocabulary; and
# the cross-attention decoder (its gates opened), whose vision rows split
# over "data" with the tokens
SPLITS = (("mamba2_780m", (1, 2, 2), ("pod",)),
          ("jamba_v01_52b", (1, 2, 2), ("pod",)),
          ("jamba_v01_52b", (2, 2), ("data",)),
          ("tiny_v255", (1, 2, 2), ("pod",)),
          ("llama32_vision_90b", (1, 2, 2), ("pod",)),
          ("hubert_xlarge", (1, 2, 2), ("pod",)))
# zero3 by family, (arch, mesh, rows): the rows split over "model" (4 on
# 2 ranks), and not (3 on 2: every rank runs them all)
ZERO3_SPLITS = (("deepseek_v3_671b", (2, 2), 4),
                ("jamba_v01_52b", (2, 2), 4),
                ("deepseek_v3_671b", (2, 2), 3))
# the cross-attention decoder's split in f64: the split's own error is
# rounding, so it vanishes there (chip_smoke.py's vision-small runs the
# same split on (pod 1, data 2, model 2) in f32 on the card)
VISION_F64 = ("llama32_vision_90b", (1, 2, 2), ("pod",))
F64_REL = 1e-12


def _unit_job(rank):
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    for size in (2, 4):
        data = _data_axes(size)
        out[size] = _gather_checks(data)
    out["route"] = _route_checks(_data_axes(2))
    for run in SPLITS:
        out[run] = _split_checks(*run)
    out["vision-f64"] = _split_checks(*VISION_F64, f64=True)
    for arch, shape, rows in ZERO3_SPLITS:
        out[("zero3", arch, rows)] = _split_checks(
            arch, shape, ("data",), mode="zero3", rows=rows)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def units(reference):
    return spawn(_unit_job, 4, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("mode", ["reduce_scatter", "keep", "narrow"])
@pytest.mark.parametrize("size", [2, 4])
def test_data_gather_against_plain_twin(units, size, mode):
    for rank, out in enumerate(units):
        ok, err = out[size][mode]
        assert ok is None or ok, (rank, size, mode)
        assert err <= 1e-12, (rank, size, mode, err)


@pytest.mark.parametrize("run", SPLITS, ids=lambda r: f"{r[0]}-{r[2][0]}")
def test_ssm_and_hybrid_split_over_data_match_the_whole_model(units, run):
    for rank, out in enumerate(units):
        loss, whole, worst, where = out[run]
        assert loss == pytest.approx(whole, rel=1e-6), (rank, run)
        assert worst <= REL, (rank, run, worst, where)


@pytest.mark.parametrize("run", ZERO3_SPLITS,
                         ids=lambda r: f"{r[0]}-{r[2]}rows")
def test_zero3_split_over_model_matches_the_whole_model(units, run):
    for rank, out in enumerate(units):
        loss, whole, worst, where = out[("zero3", run[0], run[2])]
        assert loss == pytest.approx(whole, rel=1e-6), (rank, run)
        assert worst <= REL, (rank, run, worst, where)


def test_vision_split_over_data_in_f64_matches_the_whole_model(units):
    for rank, out in enumerate(units):
        loss, whole, worst, where = out["vision-f64"]
        assert loss == pytest.approx(whole, rel=F64_REL), rank
        assert worst <= F64_REL, (rank, worst, where)


def test_route_on_split_rows_equals_route_on_all_rows(units):
    for rank, out in enumerate(units):
        diffs, (cap, cap_whole), dropped = out["route"]
        assert cap == cap_whole, rank
        assert dropped > 0, rank
        assert diffs[:2] == [0, 0], (rank, diffs)
        assert max(diffs[2:]) <= 1e-6, (rank, diffs)


# ---------------------------------------------------------------------------
# the replay on (pod 2, data 2, model 2)
# ---------------------------------------------------------------------------

def _replay(ref, name, mesh, tc, steps=STEPS):
    """Rows of (worst error of max-abs, every leaf of the param_specs
    local shape) per step of the run ``name`` replayed on the tape, the
    collectives of its first difference round, the choices its MoE
    layers dropped, and its final state."""
    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import (MeshTrainState, TrainTape,
                                          make_train_step, train_key)
    from repro_torch.models import init_params, moe
    from repro_torch.models.model import shard_params
    from repro_torch.sharding.rules import local_shape, param_specs

    cfg = _model(name)
    whole = init_params(0, cfg, device="meta")
    leaves, treedef = tree_flatten(whole)
    specs = tree_flatten(param_specs(mesh, cfg, whole, tc.shard_mode),
                         is_leaf=lambda x: isinstance(x, P))[0]
    want_shapes = [local_shape(mesh, x.shape, sp)
                   for x, sp in zip(leaves, specs)]

    def pieces(prefix):
        tree = tree_unflatten(treedef, [torch.from_numpy(
            ref[f"{name}_{prefix}_{i}"]) for i in range(len(leaves))])
        return tree_flatten(shard_params(tree, mesh, cfg, tc.shard_mode))[0]

    tape = TrainTape(
        c=np.array([ref[f"{name}_c_{k}"] for k in range(steps)]),
        sampled=np.array([ref[f"{name}_sampled_{k}"] for k in range(steps)]),
        order=np.array([ref[f"{name}_order_{k}"] for k in range(steps)]))
    state = MeshTrainState(
        tree_unflatten(treedef, pieces("params0")),
        tree_unflatten(treedef, pieces("g0")), train_key(0),
        torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg, mesh, tc)
    rows, counts = [], None
    with moe.count_drops() as drops:
        for k in range(steps):
            batch = {"tokens": torch.from_numpy(ref[f"{name}_batch_{k + 1}"])}
            reset_collective_counts()
            state = step(state, batch, tape)
            if k == 1:  # the first difference round
                counts = collective_counts()
            worst, shaped = 0.0, True
            for what in ("params", "g"):
                wants = pieces(f"{what}_{k}")
                for got, want, shp in zip(tree_flatten(getattr(
                        state, what))[0], wants, want_shapes):
                    want = want.numpy()
                    err = np.abs(got.numpy() - want).max()
                    worst = max(worst, float(
                        err / max(np.abs(want).max(), 1e-30)))
                    shaped &= tuple(got.shape) == shp
            rows.append((worst, shaped))
    return rows, counts, int(drops[0]), state


def _replay_job(rank, ref_path):
    from repro_torch.core.tree_utils import tree_flatten, tree_norm
    from repro_torch.launch.mesh import P, make_debug_mesh
    from repro_torch.launch.train import held_norm, model_axis_of
    from repro_torch.models import tp
    from repro_torch.sharding.rules import held_specs
    from repro_torch.models import init_params

    torch.set_num_threads(1)
    ref = np.load(ref_path)
    mesh = make_debug_mesh(MESH[1], MESH[2], pod=MESH[0])
    out = {}
    for name in MODELS:
        tc = _config()
        rows, counts, drops, state = _replay(ref, name, mesh, tc)
        cfg = _model(name)
        held = tree_flatten(held_specs(mesh, cfg, init_params(
            0, cfg, device="meta"), tc.shard_mode),
            is_leaf=lambda x: isinstance(x, P))[0]
        axis = model_axis_of(mesh, cfg, tc.shard_mode, ("pod",))
        n = len(held)
        whole_g = [torch.from_numpy(ref[f"{name}_g_{STEPS - 1}_{i}"])
                   for i in range(n)]
        norms = (float(held_norm(tree_flatten(state.g)[0], axis, held)),
                 float(tree_norm(whole_g)))
        out[name] = (rows, counts, drops, norms,
                     (axis.data.worker, axis.data.size))
    # the planted fault: the cross-entropy's count left out of the sum
    # over "data" (the only sum of a value with no gradient and no shape)
    plain = tp.reduce_from_data

    def fault(x, data):
        if x.dim() == 0 and not x.requires_grad:
            return x
        return plain(x, data)

    tp.reduce_from_data = fault
    try:
        out["fault"] = _replay(ref, "tiny", mesh, _config(), 2)[0]
    finally:
        tp.reduce_from_data = plain
    return out


@pytest.fixture(scope="module")
def replay(reference):
    ref_path = reference()
    return np.load(ref_path), spawn(_replay_job, 8, (ref_path,),
                                    timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_trainer_follows_the_reference_on_pod_workers(replay, name):
    ref, results = replay
    assert [bool(ref[f"{name}_c_{k}"]) for k in range(STEPS)] == \
        [True, False, False, False]
    for rank, out in enumerate(results):
        rows, _, _, _, (worker, size) = out[name]
        assert not worker and size == 2, rank
        for k, (worst, _) in enumerate(rows):
            assert worst <= REL, (rank, name, k, worst)


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_ranks_hold_data_by_model_pieces(replay, name):
    _, results = replay
    for rank, out in enumerate(results):
        assert all(shaped for _, shaped in out[name][0]), (rank, name)


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_collectives_gather_over_data_and_reduce_scatter(replay, name):
    """A difference round gathers each layer over "data" and sums the
    gradients of the gathered leaves by a reduce-scatter; the MoE layers
    drop choices (the capacity the whole batch's)."""
    _, results = replay
    for rank, out in enumerate(results):
        counts, drops = out[name][1], out[name][2]
        assert counts["reduce_scatter"]["calls"] > 0, (rank, counts)
        assert counts["reduce_scatter"]["route"] == "cpu"
        assert counts["all_gather"]["calls"] > 0
        if name == "v3":
            assert drops > 0, rank


@pytest.mark.parametrize("name", list(MODELS))
def test_held_norm_equals_the_whole_norm(replay, name):
    _, results = replay
    for rank, out in enumerate(results):
        got, want = out[name][3]
        assert got == pytest.approx(want, rel=1e-6), (rank, name)


def test_count_left_out_of_the_sum_over_data_fails_the_limit(replay):
    _, results = replay
    for rank, out in enumerate(results):
        assert max(worst for worst, _ in out["fault"]) > 100 * REL, rank
