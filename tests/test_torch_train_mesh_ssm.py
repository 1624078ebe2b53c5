"""The port's mesh trainer on the SSM and hybrid decoders: mamba2-780m's
and jamba-v0.1-52b's smoke configs in f32 (remat off) on eight gloo ranks
of a (data=4, model=2) mesh on the CPU, under the tensor-parallel split
(``sharding.rules.model_split`` "tp"), against the reference's trainer on
eight faked devices.

The harness is ``tests/test_torch_train_mesh.py``'s (its reference
script, its replay job and its tolerances), here for the default plan
(sharded CM, alpha = 2) under bf at gamma 0.3, p = 0.5: a full round,
then three difference rounds.  One reference subprocess per model runs
the reference's ``make_train_step``; one spawn of 8 ranks replays both
on a ``TrainTape``.  Each rank holds exactly its ``param_specs`` pieces
(the Mamba-2 mixer's ``in_proj`` by column, ``conv_w`` by channel,
``out_proj`` by row; jamba's attention heads, experts and vocabulary),
and after every step its params and g lie within 1e-5 of each leaf's
max-abs of the reference's slices; the ranks along "data" hold the same
pieces bit for bit.

Two leaves of each Mamba-2 layer are held at ``HEAD_REL`` instead: the
gradients of ``A_log`` and ``dt_bias``, one value a head, each a sum
over every token of terms that cancel to 1e-6..2e-5 of the other
leaves' scale, so that the last bits of f32 rounding move them by 1e-5
of their own max-abs.  The port's replicated branch (zero3: every rank
computes the whole model, no split) on the same tape reads up to
1.98e-5 on them against the same reference (jamba's A_log, step 3;
mamba2 7.1e-6), and the split up to 1.23e-5; in f64 the split mixer
equals the whole one to 1e-15 (``tests/test_torch_tp_ssm.py``).  A difference round's all-gathers are the
aggregation's (the W clip factors and, per leaf, the sharded placement's
chunks of the held piece) and the split's own (each SSM layer's
``in_proj`` and ``conv_w`` whole once) of its two gradients, nothing
else: no split leaf is gathered back; the split adds no all_to_all.

This file runs beside ``tests/test_torch_train_mesh.py`` under xdist
(``--dist loadfile``).
"""
import numpy as np
import pytest

from repro_torch.launch.mesh import spawn
from test_torch_train_mesh import (REL, SPAWN_TIMEOUT, STEPS, W,
                                   _replay_job, model_config,
                                   start_reference, stop)

MODELS = {arch: (arch, dict(dtype="float32", remat=False))
          for arch in ("mamba2_780m", "jamba_v01_52b")}
RUNS = (("default-bf", "default-bf", (4, 2)),)
# the per-head leaves of the Mamba-2 mixer (module docstring), of each
# leaf's max-abs
HEAD_LEAVES = ("A_log", "dt_bias")
HEAD_REL = 1e-4


def _job(rank, paths):
    return {arch: _replay_job(rank, paths[arch], spec, RUNS,
                              HEAD_LEAVES)["default-bf"]
            for arch, spec in MODELS.items()}


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """The reference's runs (one subprocess a model, side by side) and the
    8-rank replay of both: ({arch: the reference's npz}, the ranks'
    results)."""
    started = {arch: start_reference(
        str(tmp_path_factory.mktemp(f"ref_{arch}") / "ref.npz"), spec, RUNS)
        for arch, spec in MODELS.items()}
    try:
        paths = {arch: wait() for arch, (wait, _) in started.items()}
    finally:
        for _, proc in started.values():
            stop(proc)
    return ({arch: np.load(p) for arch, p in paths.items()},
            spawn(_job, 8, (paths,), timeout=SPAWN_TIMEOUT))


@pytest.mark.parametrize("arch", list(MODELS))
def test_split_trainer_follows_the_reference(replay, arch):
    refs, results = replay
    assert [bool(refs[arch][f"default-bf_c_{k}"]) for k in range(STEPS)] \
        == [True, False, False, False]
    for rank, out in enumerate(results):
        coord, rows, _, replicated, _ = out[arch]
        assert not replicated, rank
        for k, (worst, digest, _, head) in enumerate(rows):
            assert worst <= REL, (rank, arch, k, worst)
            assert head <= HEAD_REL, (rank, arch, k, head)
            same = [o[arch][1][k][1] for o in results if o[arch][0] == coord]
            assert len(same) == 4 and set(same) == {digest}, (rank, k)


@pytest.mark.parametrize("arch", list(MODELS))
def test_split_trainer_holds_param_specs_pieces(replay, arch):
    _, results = replay
    for rank, out in enumerate(results):
        assert all(shaped for _, _, shaped, _ in out[arch][1]), (rank,
                                                                 arch)


@pytest.mark.parametrize("arch", list(MODELS))
def test_split_gathers_nothing_back(replay, arch):
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import local_shape, param_specs

    cfg = model_config(MODELS[arch])
    whole = init_params(0, cfg, device="meta")
    mesh = AbstractMesh((4, 2), ("data", "model"))
    specs = tree_flatten(param_specs(mesh, cfg, whole),
                         is_leaf=lambda x: isinstance(x, P))[0]
    sizes = [int(np.prod(local_shape(mesh, x.shape, sp)))
             for x, sp in zip(tree_flatten(whole)[0], specs)]
    agg = 4 * W + sum(4 * (-(-n // W)) * W for n in sizes)
    # the split's own all-gathers of one gradient: each SSM layer's
    # in_proj and conv_w, whole, once (remat off)
    ssm_layers = sum(m == "ssm" for m in cfg.mixer_pattern) * cfg.n_periods
    d_inner = cfg.ssm_expand * cfg.d_model
    conv_dim = d_inner + 2 * cfg.ssm_state
    nh = d_inner // cfg.ssm_head_dim
    whole_leaves = 4 * ssm_layers * (cfg.d_model * (d_inner + conv_dim + nh)
                                     + cfg.ssm_conv * conv_dim)
    _, results = replay
    for rank, out in enumerate(results):
        counts, model = out[arch][2], out[arch][4]
        assert "all_to_all" not in model, (rank, model)
        assert model["all_reduce"]["calls"] > 0, (rank, model)
        gathered = model.get("all_gather", {"bytes": 0})["bytes"]
        assert gathered >= whole_leaves, (rank, gathered, whole_leaves)
        assert counts["all_gather"]["bytes"] == agg + 2 * gathered, \
            (rank, counts, model)
