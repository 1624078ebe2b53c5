"""The port's mesh trainer (``repro_torch.launch.train``) on eight gloo
ranks of a (data=4, model=2) and a (data=2, model=4) mesh on the CPU,
against the reference's trainer on eight faked devices.

One reference subprocess runs the reference's ``make_train_step`` for 4
steps (p = 0.5: a full round, then three difference rounds) in three
configurations and writes its draws (the key chain of
``src/repro/launch/train.py:282-298``: coins, cohorts, Bucketing orders,
gauss noise folded per leaf, RandK uniforms per worker and leaf, each
only where a run reads it), the
batches, its starting state and every step's params and g to an npz
file: the default plan (sharded CM, alpha = 2) under bf; alie with
``CompressSpec("rand_fraction", 0.5)``, a cohort of 3 and the naive
placement; gauss with mean on the sharded placement and ``fsdp_tp``, at
gamma 1e-3 (at 0.3 the full round's unclipped mean of the 10-sigma noise
moves every weight by ~0.75, and from there the two packages' rounding
differences grow to 0.3 of a leaf in one step); the default plan under
``zero3``, which splits no model compute: each rank holds its pieces of
the "fsdp" slots over "model", gathers each leaf over "model" in the
pass, runs its share of the worker's rows (2 rows, split over "model")
and reduce-scatters the gathered leaves' gradients; and the default
plan again on (2, 4), two workers, where the "model"
axis of 4 cuts ``wk`` and ``wv`` into half kv heads and leaves the
stacked MLP leaves whole.  The
reference's state is placed per its ``state_specs`` and the step's
output shardings pinned to them, as examples/train_marina_pp.py places
it, so that its step compiles once.  One spawn of 8 ranks replays them
on a ``TrainTape``.  Each rank holds its ``param_specs`` pieces
(``held_specs``: the "model" entries, under fsdp_tp the "data" entries
too, under zero3 the "fsdp" slots over "model") and computes its
worker's gradient of them only (under fsdp_tp each layer's leaves
gathered over "data", the worker's gradient of them kept whole over
"data", "data" being the worker axis); its params and g must have
exactly ``param_specs``'s local shapes (every split run) and lie within
1e-5 of each leaf's max-abs of the matching slices of the reference's
after every step (the port's f32 arithmetic differs from XLA's by
reduction order), and outside fsdp_tp the ranks along "data" (the same
pieces) must equal each other bit for bit.

The port's own draws: the example module (``repro_torch.train_marina_pp
--smoke --steps 8 --device cpu``) prints OK, and the reference's
robustness job (tests/test_mesh_trainer.py:588-635: gauss, one byzantine
of 4 workers, gamma 0.3, p 0.125, 25 steps, batch 8 x 64 from seed 3)
keeps CM's loss below its start and below mean's minus 0.05, with the
thresholds of ``chip_smoke.py`` phase 10.

JAX runs only in the reference subprocess; the spawned ranks import this
module and never load it.
"""
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
W, STEPS = 4, 4
REL = 1e-5  # of each leaf's max-abs
CONFIGS = ("default-bf", "alie-randk-naive", "gauss-mean-fsdp",
           "default-zero3")
# (run, its configuration, its mesh): the four on (4, 2), and the default
# plan on (2, 4)
RUNS = (*((name, name, (4, 2)) for name in CONFIGS),
        ("default-bf-2x4", "default-bf", (2, 4)))
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=256, remat=False, dtype="float32")
# the robustness job's checks (chip_smoke.py phase 10 uses the same): the
# port's own CPU run gives CM 5.5637 -> 5.4504 and mean 11455 after 25
# steps
ROBUST_STEPS, ROBUST_MARGIN = 25, 0.05
SPAWN_TIMEOUT = 300
# a cross-attention model's gates, opened before g^0 (at their initial 0
# every cross-attention weight has a zero gradient)
GATE = 0.5

REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.api import (AggregatorSpec, ClipSpec, CompressSpec, ScheduleSpec,
                       ServerPlan)
from repro.data.pipeline import make_batch_iterator
from repro.launch.mesh import make_debug_mesh, set_mesh
from repro.launch.train import (ByzTrainConfig, MeshTrainState,
                                make_train_step, state_specs)
from repro.models import ModelConfig, apply_train, init_params

STEPS = 4
cfg = %(cfg)s
MESHES = {(4, 2): make_debug_mesh(4, 2), (2, 4): make_debug_mesh(2, 4)}
CONFIGS = {
    "default-bf": ByzTrainConfig(gamma=0.3, n_byz=1, attack="bf", p=0.5),
    "alie-randk-naive": ByzTrainConfig.from_plan(ServerPlan(
        aggregate=AggregatorSpec("cm", byz_bound=1), clip=ClipSpec(alpha=2.0),
        compress=CompressSpec("rand_fraction", frac=0.5),
        schedule=ScheduleSpec(placement="naive")),
        gamma=0.3, n_byz=1, attack="alie", p=0.5, C=3),
    "gauss-mean-fsdp": ByzTrainConfig.from_plan(ServerPlan(
        aggregate=AggregatorSpec("mean"), clip=ClipSpec(alpha=2.0),
        schedule=ScheduleSpec(placement="sharded")),
        gamma=1e-3, n_byz=1, attack="gauss", p=0.5,
            shard_mode="fsdp_tp"),
    "default-zero3": ByzTrainConfig(gamma=0.3, n_byz=1, attack="bf", p=0.5,
                                    shard_mode="zero3"),
}
it = make_batch_iterator(cfg, 8, 32, seed=3)
batches = [jax.tree_util.tree_map(np.asarray, next(it))
           for _ in range(STEPS + 1)]
out = {f"batch_{k}_{n}": v for k, b in enumerate(batches)
       for n, v in b.items()}
params = init_params(jax.random.PRNGKey(0), cfg)
if "cross" in cfg.mixer_pattern:  # the cross-attention gates, opened
    params = dict(params, body=tuple(
        dict(layer, mixer=dict(layer["mixer"], gate=jnp.full_like(
            layer["mixer"]["gate"], %(gate)r))) if mixer == "cross" else layer
        for layer, mixer in zip(params["body"], cfg.mixer_pattern)))
g0 = jax.jit(jax.grad(lambda p: apply_train(p, cfg, batches[0])[0]))(params)
leaves = jax.tree_util.tree_leaves(params)
for i, (x, g) in enumerate(zip(leaves, jax.tree_util.tree_leaves(g0))):
    out[f"params0_{i}"], out[f"g0_{i}"] = np.asarray(x), np.asarray(g)
for name, config, shape in %(runs)r:
    tc, mesh, W = CONFIGS[config], MESHES[shape], shape[0]
    with set_mesh(mesh):
        C = tc.C or W
        key = jax.random.PRNGKey(1)
        for k in range(STEPS):  # the step's key chain
            key, kb, kc, kq, ka, kg = jax.random.split(key, 6)
            c = bool(jax.random.bernoulli(kb, tc.p))
            perm = np.asarray(jax.random.permutation(kc, W))
            rank = np.zeros(W, int)
            rank[perm] = np.arange(W)
            out[f"{name}_c_{k}"] = np.array(c)
            out[f"{name}_sampled_{k}"] = rank < (W if c else C)
            out[f"{name}_order_{k}"] = np.asarray(
                jax.random.permutation(kg, W))
            if tc.attack == "gauss":  # the only runs that read the noise
                for i, x in enumerate(leaves):
                    out[f"{name}_noise_{k}_{i}"] = np.asarray(
                        jax.random.normal(jax.random.fold_in(ka, i),
                                          (W, x.size), jnp.float32))
            if tc.plan is not None and tc.plan.compress is not None:
                for w in range(W):  # a compressing plan's uniforms
                    ks = jax.random.split(jax.random.fold_in(kq, w),
                                          len(leaves))
                    for i, x in enumerate(leaves):
                        out[f"{name}_randk_{k}_{w}_{i}"] = np.asarray(
                            jax.random.uniform(ks[i], (x.size,)))
        state = MeshTrainState(params=params, g=g0, key=jax.random.PRNGKey(1),
                               step=jnp.int32(0))
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


def open_gates(params, cfg):
    """The port's ``params`` of ``cfg`` with every cross-attention gate
    set to ``GATE``, in place, as the reference script opens them."""
    for pos, mixer in enumerate(cfg.mixer_pattern):
        if mixer == "cross":
            params["body"][pos]["mixer"]["gate"].fill_(GATE)
    return params


def model_config(spec):
    """The port's ``ModelConfig`` of ``spec``: a dict of its fields, or
    (arch, overrides) for a smoke config."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ModelConfig

    if isinstance(spec, dict):
        return ModelConfig(**spec)
    return get_smoke_config(spec[0]).replace(**spec[1])


def _config_expr(spec) -> str:
    """The reference's expression for ``spec`` (``model_config``)."""
    if isinstance(spec, dict):
        return f"ModelConfig(**{spec!r})"
    return f"get_smoke_config({spec[0]!r}).replace(**{spec[1]!r})"


def start_reference(path, spec=TINY, runs=RUNS):
    """Start the reference subprocess for the model ``spec`` and ``runs``
    ((name, configuration, mesh shape)); returns a function that waits
    for it and returns the npz path, and the process."""
    script = REF_SCRIPT % {"cfg": _config_expr(spec), "runs": runs,
                           "gate": GATE}
    proc = subprocess.Popen([sys.executable, "-c", script, path],
                            env=ENV, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in out, err[-3000:]
        return path

    return wait, proc


def stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference subprocess, started before the module's first test
    (the port-only tests run meanwhile); yields a function that waits for
    it and returns the npz path."""
    wait, proc = start_reference(
        str(tmp_path_factory.mktemp("train_ref") / "ref.npz"))
    try:
        yield wait
    finally:
        stop(proc)


def _port_configs():
    from repro_torch.api import (AggregatorSpec, ClipSpec, CompressSpec,
                                 ScheduleSpec, ServerPlan)
    from repro_torch.launch.train import ByzTrainConfig

    return {
        "default-bf": ByzTrainConfig(gamma=0.3, n_byz=1, attack="bf", p=0.5),
        "alie-randk-naive": ByzTrainConfig.from_plan(ServerPlan(
            aggregate=AggregatorSpec("cm", byz_bound=1),
            clip=ClipSpec(alpha=2.0),
            compress=CompressSpec("rand_fraction", frac=0.5),
            schedule=ScheduleSpec(placement="naive")),
            gamma=0.3, n_byz=1, attack="alie", p=0.5, C=3),
        "gauss-mean-fsdp": ByzTrainConfig.from_plan(ServerPlan(
            aggregate=AggregatorSpec("mean"), clip=ClipSpec(alpha=2.0),
            schedule=ScheduleSpec(placement="sharded")),
            gamma=1e-3, n_byz=1, attack="gauss", p=0.5,
            shard_mode="fsdp_tp"),
        "default-zero3": ByzTrainConfig(gamma=0.3, n_byz=1, attack="bf",
                                        p=0.5, shard_mode="zero3"),
    }


def _batch(ref, k):
    """Batch ``k`` as the reference saved it: every leaf
    (``batch_{k}_{name}``: the tokens, and a VLM's vision tokens)."""
    head = f"batch_{k}_"
    return {key[len(head):]: torch.from_numpy(ref[key]) for key in ref.files
            if key.startswith(head)}


def _replay_job(rank, ref_path, spec=TINY, runs=RUNS, loose=()):
    """One rank's replay of the ``runs`` of the model ``spec`` on the
    reference's tape: per run and step, the worst leaf error (of the
    leaf's max-abs) of its pieces against the reference's slices, the raw
    bytes of params and g, and whether every leaf has ``param_specs``'s
    local shape; with the run's "model" coordinate, the collectives of
    its first difference round, whether its pass ran whole (no
    ``model_axis_of``) and the collectives of one worker gradient at the
    starting params.  Leaves named in ``loose`` (the last key on their
    path) are left out of a step's worst error, and their own worst error
    is appended to the step's row."""
    import hashlib

    from repro_torch.api.mesh_exec import collective_counts
    from repro_torch.api.mesh_exec import reset_collective_counts
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import P, make_debug_mesh
    from repro_torch.launch.train import (MeshTrainState, TrainTape,
                                          make_train_step, model_axis_of,
                                          train_key, worker_grads)
    from repro_torch.models import init_params
    from repro_torch.models.model import shard_params
    from repro_torch.sharding.rules import (_map_with_name, local_shape,
                                            param_specs)

    torch.set_num_threads(1)
    ref = np.load(ref_path)
    cfg = model_config(spec)
    whole = init_params(0, cfg, device="meta")
    treedef = tree_flatten(whole)[1]
    n = len(tree_flatten(whole)[0])
    names = tree_flatten(_map_with_name(lambda name, _: name, whole))[0]
    meshes = {shape: make_debug_mesh(*shape) for shape in ((4, 2), (2, 4))}
    configs = _port_configs()

    def tree(prefix):
        return tree_unflatten(treedef, [torch.from_numpy(ref[f"{prefix}_{i}"])
                                        for i in range(n)])

    out = {}
    for name, config, shape in runs:
        tc, mesh, W = configs[config], meshes[shape], shape[0]
        specs = tree_flatten(param_specs(mesh, cfg, whole, tc.shard_mode),
                             is_leaf=lambda x: isinstance(x, P))[0]
        want_shapes = [local_shape(mesh, x.shape, sp)
                       for x, sp in zip(tree_flatten(whole)[0], specs)]

        def pieces(prefix):
            return tree_flatten(shard_params(tree(prefix), mesh, cfg,
                                             tc.shard_mode))[0]

        tape = TrainTape(
            c=np.array([ref[f"{name}_c_{k}"] for k in range(STEPS)]),
            sampled=np.array([ref[f"{name}_sampled_{k}"]
                              for k in range(STEPS)]),
            order=np.array([ref[f"{name}_order_{k}"] for k in range(STEPS)]),
            attack_noise=[[ref[f"{name}_noise_{k}_{i}"] for i in range(n)]
                          for k in range(STEPS)]
            if f"{name}_noise_0_0" in ref.files else None,
            randk=[[[ref[f"{name}_randk_{k}_{w}_{i}"] for i in range(n)]
                    for w in range(W)] for k in range(STEPS)]
            if f"{name}_randk_0_0_0" in ref.files else None)
        held = [tree_unflatten(treedef, pieces(p)) for p in ("params0", "g0")]
        batch = _batch(ref, 1)  # a worker's rows: the gradient's
        b = next(iter(batch.values())).shape[0] // W
        batch = {key: v[:b] for key, v in batch.items()}
        reset_collective_counts()
        worker_grads(held[0], cfg, batch,
                     model_axis_of(mesh, cfg, tc.shard_mode))
        model_counts = collective_counts()
        state = MeshTrainState(*held, train_key(0),
                               torch.zeros((), dtype=torch.int32))
        step = make_train_step(cfg, mesh, tc)
        rows, counts = [], None
        for k in range(STEPS):
            reset_collective_counts()
            state = step(state, _batch(ref, k + 1), tape)
            if k == 1:  # the first difference round
                counts = collective_counts()
            worst, digest, shaped = [0.0, 0.0], hashlib.sha256(), True
            for what in ("params", "g"):
                wants = pieces(f"{name}_{what}_{k}")
                got_leaves = tree_flatten(getattr(state, what))[0]
                for got, want, shp, leaf in zip(got_leaves, wants,
                                                want_shapes, names):
                    want = want.numpy()
                    err = np.abs(got.numpy() - want).max()
                    at = int(leaf in loose)
                    worst[at] = max(worst[at], float(
                        err / max(np.abs(want).max(), 1e-30)))
                    digest.update(got.numpy().tobytes())
                    shaped &= tuple(got.shape) == shp
            row = (worst[0], digest.hexdigest(), shaped)
            rows.append(row + (worst[1],) if loose else row)
        out[name] = (mesh.get_local_rank("model"), rows, counts,
                     model_axis_of(mesh, cfg, tc.shard_mode) is None,
                     model_counts)
    return out


def _robust_job(rank, device):
    """The reference's robustness job on the port's own draws: the losses
    on batch 0 before and after 25 steps, per plan."""
    from repro_torch.api import AggregatorSpec, ScheduleSpec, ServerPlan
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (ByzTrainConfig, initial_state,
                                          make_train_step, train_loss)
    from repro_torch.models import ModelConfig, init_params

    torch.set_num_threads(1)
    cfg = ModelConfig(**TINY)
    mesh = make_debug_mesh(4, 2)
    out = {}
    for agg in ("cm", "mean"):
        if agg == "cm":  # the default plan: sharded CM, alpha = 2
            tc = ByzTrainConfig(gamma=0.3, n_byz=1, attack="gauss", p=0.125)
        else:
            tc = ByzTrainConfig.from_plan(
                ServerPlan(aggregate=AggregatorSpec("mean"),
                           schedule=ScheduleSpec(placement="naive")),
                gamma=0.3, n_byz=1, attack="gauss", p=0.125)
        step = make_train_step(cfg, mesh, tc)
        it = make_batch_iterator(cfg, 8, 64, seed=3, device=device)
        params = init_params(0, cfg, device=device)
        batch0 = next(it)
        state = initial_state(params, cfg, mesh, tc, batch0)
        start = train_loss(state.params, cfg, batch0, mesh)
        for _ in range(ROBUST_STEPS):
            state = step(state, next(it))
        out[agg] = (start, train_loss(state.params, cfg, batch0, mesh))
    return out


def test_robustness_cm_keeps_training_mean_is_disrupted():
    results = spawn(_robust_job, 8, ("cpu",), timeout=SPAWN_TIMEOUT)
    assert all(r == results[0] for r in results)
    (cm0, cm), (_, mean) = results[0]["cm"], results[0]["mean"]
    assert cm < cm0, results[0]
    assert cm < mean - ROBUST_MARGIN, results[0]


def test_example_prints_ok(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_marina_pp", "--smoke",
         "--steps", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        env=ENV, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.rstrip().endswith("OK"), r.stdout
    # the checkpoint restores to the final params
    from repro_torch.checkpoint import restore
    from repro_torch.models import init_params
    from repro_torch.train_marina_pp import build_config, params_digest

    template = init_params(0, build_config(True), device="cpu")
    got = params_digest(restore(str(tmp_path), 8, template))
    assert f"final params sha256 {got}" in r.stdout


@pytest.fixture(scope="module")
def replay(reference):
    """The 8-rank replay of every run, and the reference's npz."""
    ref_path = reference()
    return np.load(ref_path), spawn(_replay_job, 8, (ref_path,),
                                    timeout=SPAWN_TIMEOUT)


def test_trainer_follows_the_reference_on_eight_ranks(replay):
    ref, results = replay
    configs = _port_configs()
    for name, _, _ in RUNS:  # both branches: a full round, then differences
        assert [bool(ref[f"{name}_c_{k}"]) for k in range(STEPS)] == \
            [True, False, False, False]
    for rank, out in enumerate(results):
        for name, config, _ in RUNS:
            coord, rows, _, replicated, _ = out[name]
            for k, (worst, digest, _) in enumerate(rows):
                assert worst <= REL, (rank, name, k, worst)
                if configs[config].shard_mode == "fsdp_tp":
                    continue  # each rank its own "data" x "model" piece
                # the ranks along "data" hold the same pieces
                assert not replicated, (rank, name)
                same = [o[name][1][k][1] for o in results
                        if o[name][0] == coord]
                assert len(same) > 1 and set(same) == {digest}, \
                    (rank, name, k)


@pytest.mark.parametrize("run", ["default-bf", "alie-randk-naive",
                                 "default-bf-2x4", "gauss-mean-fsdp",
                                 "default-zero3"])
def test_trainer_ranks_hold_param_specs_pieces(replay, run):
    _, results = replay
    for rank, out in enumerate(results):
        assert all(shaped for _, _, shaped in out[run][1]), (rank, run)


def test_trainer_collectives_of_the_split(replay):
    """The sharded scatter, the gathers (alie's honest pieces among them)
    and the all-reduces (the norms, the split's), and no all-gather of the
    aggregate back to whole leaves: in a difference round of the default
    plan a rank all-gathers only the W clip factors and, per leaf, the
    sharded placement's aggregated chunks of its own piece (padded to a
    multiple of W), nothing else."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import local_shape, param_specs

    cfg = ModelConfig(**TINY)
    whole = tree_flatten(init_params(0, cfg, device="meta"))[0]
    mesh = AbstractMesh((4, 2), ("data", "model"))
    specs = tree_flatten(param_specs(mesh, cfg, init_params(
        0, cfg, device="meta")), is_leaf=lambda x: isinstance(x, P))[0]
    sizes = [int(np.prod(local_shape(mesh, x.shape, sp)))
             for x, sp in zip(whole, specs)]
    want = 4 * W + sum(4 * (-(-n // W)) * W for n in sizes)
    _, results = replay
    for rank, out in enumerate(results):
        counts = out["default-bf"][2]
        assert {"all_to_all", "all_gather", "all_reduce"} <= set(counts)
        assert counts["all_gather"]["bytes"] == want, (rank, counts)
        # the naive placement gathers the rows: no all_to_all
        assert {"all_gather", "all_reduce"} <= set(out["alie-randk-naive"][2])


def test_zero3_gathers_no_aggregate_and_reduce_scatters_gradients(replay):
    """zero3 splits no model compute: each rank holds its pieces of the
    "fsdp" slots over "model" (``param_specs`` under zero3), gathers each
    split leaf whole over "model" in the pass and, the worker's 2 rows
    split over "model", reduce-scatters the gathered leaves' gradients;
    the aggregate is the held piece, so nothing is gathered back.  Its
    replay against the reference is
    ``test_trainer_follows_the_reference_on_eight_ranks``.  In a
    difference round a rank all-gathers the W clip factors, per leaf the
    sharded placement's chunks of its piece, and each split leaf whole
    once a gradient (two: at x^{k+1} and at x^k), and reduce-scatters
    each split leaf's whole gradient once a gradient."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import local_shape, param_specs

    cfg = ModelConfig(**TINY)
    whole = tree_flatten(init_params(0, cfg, device="meta"))[0]
    mesh = AbstractMesh((4, 2), ("data", "model"))
    specs = tree_flatten(param_specs(mesh, cfg, init_params(
        0, cfg, device="meta"), "zero3"), is_leaf=lambda x: isinstance(x, P))[0]
    pieces = [int(np.prod(local_shape(mesh, x.shape, sp)))
              for x, sp in zip(whole, specs)]
    split = sum(4 * x.numel() for x, sp in zip(whole, specs) if any(sp))
    assert split > 0
    want = 4 * W + sum(4 * (-(-n // W)) * W for n in pieces) + 2 * split
    _, results = replay
    for rank, out in enumerate(results):
        assert not out["default-zero3"][3], rank
        counts, one = out["default-zero3"][2], out["default-zero3"][4]
        assert counts["all_gather"]["bytes"] == want, (rank, counts)
        assert counts["reduce_scatter"]["bytes"] == 2 * split, (rank, counts)
        # one worker gradient: each split leaf gathered and its gradient
        # reduce-scattered once, the whole leaves' gradients all-reduced
        assert one["all_gather"]["bytes"] == split, (rank, one)
        assert one["reduce_scatter"]["bytes"] == split, (rank, one)
        assert one["all_reduce"]["calls"] >= 1, (rank, one)
