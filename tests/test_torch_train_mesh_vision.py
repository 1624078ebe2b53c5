"""The port's mesh trainer on the cross-attention decoder:
llama-3.2-vision-90b's smoke config in f32 (remat off, its gates opened
to 0.5 before g^0) on eight gloo ranks of a (data=4, model=2) mesh on the
CPU, under the tensor-parallel split (``sharding.rules.model_split``
"tp"), against the reference's trainer on eight faked devices.

The harness is ``tests/test_torch_train_mesh.py``'s (its reference
script, which opens the gates of a model with a "cross" mixer, its
replay job, which passes every batch leaf the reference saved, the vision
tokens too, and its tolerances), here for two of its runs: the default
plan (sharded CM, alpha = 2) under bf at gamma 0.3, and gauss with mean
under ``fsdp_tp`` at gamma 1e-3, p = 0.5: a full round, then three
difference rounds.  One reference subprocess runs both; one spawn of 8
ranks replays them on a ``TrainTape``.  Each rank holds exactly its
``param_specs`` pieces (under fsdp_tp its "data" x "model" pieces: the
cross-attention's ``wq``, ``wk``, ``wv`` and ``wo`` split over "data" on
``d_model``), and after every step its params and g lie within
``LIMITS[run]`` of each leaf's max-abs of the reference's slices; under
"tp" the ranks along "data" hold the same pieces bit for bit.

The limits: gauss-mean-fsdp (gamma 1e-3) is held at the harness's 1e-5.
default-bf (gamma 0.3) moves the weights far enough that f32 rounding in
another order grows to 1e-5 of a leaf's max-abs by the fourth step: the
reference's own trajectory on a (4, 1) mesh (its model compute whole)
differs from its (4, 2) one by 4.78e-6, 5.65e-6, 7.59e-6 and 1.029e-5
after steps 0-3 (at step 3 an attention layer's ``wk`` gradient); the
port's split reads 5.32e-6, 7.47e-6, 8.02e-6 and 1.055e-5 there (the
same leaf), and its unsplit branch (``model_split`` forced "replicated")
6.22e-6, 5.92e-6, 8.07e-6 and 9.90e-6.  So default-bf is held at 2e-5,
twice the reference's spread against itself.

No split leaf is gathered back: a difference round's all-gathers are the
aggregation's (the W clip factors and, per leaf, the sharded
placement's chunks of the aggregated piece) and those of its two worker
gradients (under fsdp_tp each layer's leaves over "data"), nothing else.

This file runs beside ``tests/test_torch_train_mesh.py`` under xdist
(``--dist loadfile``).
"""
import numpy as np
import pytest

from repro_torch.launch.mesh import spawn
from test_torch_train_mesh import (REL, SPAWN_TIMEOUT, STEPS, W,
                                   _port_configs, _replay_job, model_config,
                                   start_reference, stop)

SPEC = ("llama32_vision_90b", dict(dtype="float32", remat=False))
RUNS = (("default-bf", "default-bf", (4, 2)),
        ("gauss-mean-fsdp", "gauss-mean-fsdp", (4, 2)))
# of each leaf's max-abs, after every step (module docstring)
LIMITS = {"default-bf": 2e-5, "gauss-mean-fsdp": REL}


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """The reference's runs and the 8-rank replay of both: (the
    reference's npz, the ranks' results)."""
    wait, proc = start_reference(
        str(tmp_path_factory.mktemp("ref_vision") / "ref.npz"), SPEC, RUNS)
    try:
        path = wait()
    finally:
        stop(proc)
    return np.load(path), spawn(_replay_job, 8, (path, SPEC, RUNS),
                                timeout=SPAWN_TIMEOUT)


def test_reference_saved_the_vision_rows_and_opened_the_gates(replay):
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.models import init_params
    from repro_torch.sharding.rules import _map_with_name

    ref, _ = replay
    cfg = model_config(SPEC)
    assert ref["batch_1_vision"].shape == (8, cfg.n_vision_tokens,
                                           cfg.d_model)
    assert ref["batch_1_tokens"].shape[0] == 8
    names = tree_flatten(_map_with_name(
        lambda name, _: name, init_params(0, cfg, device="meta")))[0]
    gates = [i for i, name in enumerate(names) if name == "gate"]
    assert gates and all(np.all(ref[f"params0_{i}"] == 0.5) for i in gates)
    # open gates: every leaf's g^0, the cross-attention's weights', moves
    assert all(np.abs(ref[f"g0_{i}"]).max() > 0 for i in range(len(names)))


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_vision_trainer_follows_the_reference(replay, run):
    ref, results = replay
    fsdp = _port_configs()[run].shard_mode == "fsdp_tp"
    assert [bool(ref[f"{run}_c_{k}"]) for k in range(STEPS)] == \
        [True, False, False, False]
    for rank, out in enumerate(results):
        coord, rows, _, replicated, _ = out[run]
        assert not replicated, rank
        for k, (worst, digest, _) in enumerate(rows):
            assert worst <= LIMITS[run], (rank, run, k, worst)
            if fsdp:
                continue  # each rank its own "data" x "model" piece
            same = [o[run][1][k][1] for o in results if o[run][0] == coord]
            assert len(same) == 4 and set(same) == {digest}, (rank, k)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_vision_trainer_holds_param_specs_pieces(replay, run):
    _, results = replay
    for rank, out in enumerate(results):
        assert all(shaped for _, _, shaped in out[run][1]), (rank, run)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_vision_split_gathers_nothing_back(replay, run):
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import local_shape, only_axis
    from repro_torch.sharding.rules import param_specs

    cfg = model_config(SPEC)
    mode = _port_configs()[run].shard_mode
    whole = init_params(0, cfg, device="meta")
    mesh = AbstractMesh((4, 2), ("data", "model"))
    specs = tree_flatten(param_specs(mesh, cfg, whole, mode),
                         is_leaf=lambda x: isinstance(x, P))[0]
    # the aggregated piece: the held piece with the worker axis stripped
    sizes = [int(np.prod(local_shape(mesh, x.shape, only_axis(sp, "model"))))
             for x, sp in zip(tree_flatten(whole)[0], specs)]
    agg = 4 * W + sum(4 * (-(-n // W)) * W for n in sizes)
    _, results = replay
    for rank, out in enumerate(results):
        counts, model = out[run][2], out[run][4]
        assert "all_to_all" not in model, (rank, model)
        assert model["all_reduce"]["calls"] > 0, (rank, model)
        gathered = model.get("all_gather", {"bytes": 0})["bytes"]
        if mode == "fsdp_tp":  # every layer's split leaves over "data"
            assert gathered > 0, (rank, model)
        assert counts["all_gather"]["bytes"] == agg + 2 * gathered, \
            (rank, counts, model)
