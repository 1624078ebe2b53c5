"""The port's mesh trainer (``repro_torch.launch.train``) on eight gloo
ranks of a (data=4, model=2) mesh on the CPU, against the reference's
trainer on eight faked devices.

One reference subprocess runs the reference's ``make_train_step`` for 4
steps (p = 0.5: a full round, then three difference rounds) in three
configurations and writes its draws (the key chain of
``src/repro/launch/train.py:282-298``: coins, cohorts, Bucketing orders,
gauss noise folded per leaf, RandK uniforms per worker and leaf), the
batches, its starting state and every step's params and g to an npz
file: the default plan (sharded CM, alpha = 2) under bf; alie with
``CompressSpec("rand_fraction", 0.5)``, a cohort of 3 and the naive
placement; gauss with mean on the sharded placement and ``fsdp_tp``, at
gamma 1e-3 (at 0.3 the full round's unclipped mean of the 10-sigma noise
moves every weight by ~0.75, and from there the two packages' rounding
differences grow to 0.3 of a leaf in one step).  The
reference's state is placed per its ``state_specs`` and the step's
output shardings pinned to them, as examples/train_marina_pp.py places
it, so that its step compiles once.  One spawn of 8 ranks replays them
on a ``TrainTape``: every rank's params and g within 1e-5 of each
leaf's max-abs of the reference's after every step (the port's f32
arithmetic differs from XLA's by reduction order), and the ranks equal
to each other bit for bit.

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
CONFIGS = ("default-bf", "alie-randk-naive", "gauss-mean-fsdp")
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=256, remat=False, dtype="float32")
# the robustness job's checks (chip_smoke.py phase 10 uses the same): the
# port's own CPU run gives CM 5.5637 -> 5.4504 and mean 11455 after 25
# steps
ROBUST_STEPS, ROBUST_MARGIN = 25, 0.05
SPAWN_TIMEOUT = 300

REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.api import (AggregatorSpec, ClipSpec, CompressSpec, ScheduleSpec,
                       ServerPlan)
from repro.data.pipeline import make_batch_iterator
from repro.launch.mesh import make_debug_mesh, set_mesh
from repro.launch.train import (ByzTrainConfig, MeshTrainState,
                                make_train_step, state_specs)
from repro.models import ModelConfig, apply_train, init_params

W, STEPS = 4, 4
cfg = ModelConfig(**%(tiny)r)
mesh = make_debug_mesh(4, 2)
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
}
it = make_batch_iterator(cfg, 8, 32, seed=3)
batches = [jax.tree_util.tree_map(np.asarray, next(it))
           for _ in range(STEPS + 1)]
out = {f"batch_{k}_{n}": v for k, b in enumerate(batches)
       for n, v in b.items()}
with set_mesh(mesh):
    params = init_params(jax.random.PRNGKey(0), cfg)
    g0 = jax.jit(jax.grad(lambda p: apply_train(p, cfg, batches[0])[0]))(
        params)
    leaves = jax.tree_util.tree_leaves(params)
    for i, (x, g) in enumerate(zip(leaves, jax.tree_util.tree_leaves(g0))):
        out[f"params0_{i}"], out[f"g0_{i}"] = np.asarray(x), np.asarray(g)
    for name, tc in CONFIGS.items():
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
            for i, x in enumerate(leaves):
                out[f"{name}_noise_{k}_{i}"] = np.asarray(jax.random.normal(
                    jax.random.fold_in(ka, i), (W, x.size), jnp.float32))
            for w in range(W):
                ks = jax.random.split(jax.random.fold_in(kq, w), len(leaves))
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
""" % {"tiny": TINY}


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference subprocess, started before the module's first test
    (the port-only tests run meanwhile); yields a function that waits for
    it and returns the npz path."""
    path = str(tmp_path_factory.mktemp("train_ref") / "ref.npz")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, path],
                            env=ENV, cwd=REPO, stdout=subprocess.PIPE,
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
    }


def _replay_job(rank, ref_path):
    """One rank's replay of the three configurations on the reference's
    tape: per configuration and step, the worst leaf error (of the leaf's
    max-abs) and the raw bytes of params and g."""
    import hashlib

    from repro_torch.api.mesh_exec import collective_counts
    from repro_torch.api.mesh_exec import reset_collective_counts
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (MeshTrainState, TrainTape,
                                          make_train_step, train_key)
    from repro_torch.models import ModelConfig, init_params

    torch.set_num_threads(1)
    ref = np.load(ref_path)
    cfg = ModelConfig(**TINY)
    mesh = make_debug_mesh(4, 2)
    treedef = tree_flatten(init_params(0, cfg, device="meta"))[1]
    n = len(tree_flatten(init_params(0, cfg, device="meta"))[0])

    def tree(prefix):
        return tree_unflatten(treedef, [torch.from_numpy(ref[f"{prefix}_{i}"])
                                        for i in range(n)])

    out = {}
    reset_collective_counts()
    for name, tc in _port_configs().items():
        tape = TrainTape(
            c=np.array([ref[f"{name}_c_{k}"] for k in range(STEPS)]),
            sampled=np.array([ref[f"{name}_sampled_{k}"]
                              for k in range(STEPS)]),
            order=np.array([ref[f"{name}_order_{k}"] for k in range(STEPS)]),
            attack_noise=[[ref[f"{name}_noise_{k}_{i}"] for i in range(n)]
                          for k in range(STEPS)],
            randk=[[[ref[f"{name}_randk_{k}_{w}_{i}"] for i in range(n)]
                    for w in range(W)] for k in range(STEPS)])
        state = MeshTrainState(tree("params0"), tree("g0"), train_key(0),
                               torch.zeros((), dtype=torch.int32))
        step = make_train_step(cfg, mesh, tc)
        rows = []
        for k in range(STEPS):
            batch = {"tokens": torch.from_numpy(ref[f"batch_{k + 1}_tokens"])}
            state = step(state, batch, tape)
            worst, digest = 0.0, hashlib.sha256()
            for what in ("params", "g"):
                for i, got in enumerate(tree_flatten(getattr(state, what))[0]):
                    want = ref[f"{name}_{what}_{k}_{i}"]
                    err = np.abs(got.numpy() - want).max()
                    worst = max(worst, float(err / max(np.abs(want).max(),
                                                       1e-30)))
                    digest.update(got.numpy().tobytes())
            rows.append((worst, digest.hexdigest()))
        out[name] = rows
    return out, collective_counts()


def _robust_job(rank, device):
    """The reference's robustness job on the port's own draws: the losses
    on batch 0 before and after 25 steps, per plan."""
    from repro_torch.api import AggregatorSpec, ScheduleSpec, ServerPlan
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (ByzTrainConfig, MeshTrainState,
                                          make_train_step, train_key,
                                          worker_grads)
    from repro_torch.models import ModelConfig, apply_train, init_params

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
        g0 = tree_unflatten(tree_flatten(params)[1],
                            worker_grads(params, cfg, batch0))
        state = MeshTrainState(params, g0, train_key(tc.seed),
                               torch.zeros((), dtype=torch.int32))
        with torch.no_grad():
            start = float(apply_train(params, cfg, batch0)[0])
        for _ in range(ROBUST_STEPS):
            state = step(state, next(it))
        with torch.no_grad():
            out[agg] = (start, float(apply_train(state.params, cfg,
                                                 batch0)[0]))
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


def test_trainer_follows_the_reference_on_eight_ranks(reference):
    ref_path = reference()
    ref = np.load(ref_path)
    for name in CONFIGS:  # both branches: a full round, then differences
        assert [bool(ref[f"{name}_c_{k}"]) for k in range(STEPS)] == \
            [True, False, False, False]
    results = spawn(_replay_job, 8, (ref_path,), timeout=SPAWN_TIMEOUT)
    for rank, (out, counts) in enumerate(results):
        for name in CONFIGS:
            for k, (worst, digest) in enumerate(out[name]):
                assert worst <= REL, (rank, name, k, worst)
                assert digest == results[0][0][name][k][1], (rank, name, k)
        # the sharded scatter, the gathers (alie's honest pieces among
        # them) and the whole-tree norms' all-reduces
        assert {"all_to_all", "all_gather", "all_reduce"} <= set(counts)
