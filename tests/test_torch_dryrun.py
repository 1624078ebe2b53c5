"""The dry run (``repro_torch.launch.dryrun``) and
``abstract_scoring_inputs`` on the CPU, with no card.

Two subprocesses run the CLI as the README gives it, ``--smoke --arch
all --shape all`` on the (2, 2) and on the (2, 2, 2) mesh (about two
minutes each; they start with the module and run side by side), and
must exit 0 with a JSON of the reference's keys for every combination
but hubert's decode, which is skipped.  A reference subprocess computes,
from the reference's own ``param_specs`` on a ``jax.sharding.
AbstractMesh`` and its ``init_params`` shapes, the bytes of a rank's
pieces of every leaf, under "tp" and under zero3, and from its own
``cache_specs`` the bytes of a rank's pieces of the decode cache of
decode_32k and long_500k; the dry run's held state must be twice the
"tp" pieces (params and g) plus the key and the step for every
architecture, which all split, a zero3 trace's twice the zero3 pieces,
and a serve record's held bytes exactly the "tp" pieces of params plus,
for decode, the cache's pieces.  The reference also gives
``abstract_scoring_inputs``'s shapes and dtypes.  At full size the
decode records of minitron-8b and deepseek-v3-671b on (16, 16) must
fall in the ranges predicted before the split was traced.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           JAX_PLATFORMS="cpu")
MESHES = ("2x2", "2x2x2")
KEYS = ("arch", "shape", "multi_pod", "mode", "smoke", "mesh", "n_chips",
        "shard_mode", "agg_schedule", "params", "memory", "cost",
        "collectives", "model_split", "rank")
DENSE = ("minitron_8b", "stablelm_12b", "deepseek_7b", "yi_34b",
         "arctic_480b", "deepseek_v3_671b", "mamba2_780m", "jamba_v01_52b",
         "llama32_vision_90b", "hubert_xlarge")
TIMEOUT = 900

REF_SCRIPT = r"""
import json, sys
from functools import partial
import jax, numpy as np
from repro.configs.registry import get_smoke_config, list_archs
from repro.configs.shapes import SHAPES, input_specs
from repro.launch.serve import abstract_scoring_inputs
from repro.models.model import init_params
from repro.sharding.rules import cache_specs, param_specs

out = {"pieces": {}, "whole": {}, "zero3": {}, "cache": {}}


def piece_bytes(tree, specs, shape):
    total = 0
    for leaf, sp in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(
                            specs, is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))):
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for entry in sp:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    n //= shape[ax]
        total += n
    return total


for mesh_name, sizes, names in (("2x2", (2, 2), ("data", "model")),
                                ("2x2x2", (2, 2, 2), ("pod", "data", "model"))):
    mesh = jax.sharding.AbstractMesh(sizes, names)
    shape = dict(zip(names, sizes))
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        shapes = jax.eval_shape(partial(init_params, cfg=cfg),
                                jax.random.PRNGKey(0))
        for mode, key in (("tp", "pieces"), ("zero3", "zero3")):
            specs = param_specs(mesh, cfg, shapes, mode=mode)
            piece = whole = 0
            for leaf, sp in zip(jax.tree_util.tree_leaves(shapes),
                                jax.tree_util.tree_leaves(
                                    specs, is_leaf=lambda x: isinstance(
                                        x, jax.sharding.PartitionSpec))):
                n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                whole += n
                for entry in sp:
                    for ax in (entry if isinstance(entry, tuple)
                               else (entry,)):
                        if ax is not None:
                            n //= shape[ax]
                piece += n
            out[key][f"{arch}@{mesh_name}"] = piece
        out["whole"][f"{arch}@{mesh_name}"] = whole
        if not cfg.causal:
            continue
        for sname in ("decode_32k", "long_500k"):
            cache = input_specs(cfg, SHAPES[sname])["cache"]
            out["cache"][f"{arch}@{mesh_name}@{sname}"] = piece_bytes(
                cache, cache_specs(mesh, cfg, cache), shape)
out["scoring"] = [[list(s.shape), str(s.dtype)]
                  for s in abstract_scoring_inputs(3, 5, 7)]
print(json.dumps(out))
"""


def _start(args, cwd):
    return subprocess.Popen([sys.executable, *args], env=ENV, cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two CLI runs and the reference subprocess, started together;
    yields a function that waits for them: ({mesh: (rc, stdout, stderr,
    out dir)}, the reference's JSON)."""
    procs = {}
    for mesh in MESHES:
        out = str(tmp_path_factory.mktemp(f"dryrun_{mesh}"))
        procs[mesh] = (_start(["-m", "repro_torch.launch.dryrun", "--smoke",
                               "--arch", "all", "--shape", "all", "--mesh",
                               mesh, "--out-dir", out], REPO), out)
    ref = _start(["-c", REF_SCRIPT], REPO)
    done = {}

    def wait():
        if not done:
            for mesh, (p, out) in procs.items():
                so, se = p.communicate(timeout=TIMEOUT)
                done[mesh] = (p.returncode, so, se, out)
            so, se = ref.communicate(timeout=TIMEOUT)
            assert ref.returncode == 0, se[-3000:]
            done["ref"] = json.loads(so.strip().splitlines()[-1])
        return {m: done[m] for m in MESHES}, done["ref"]

    try:
        yield wait
    finally:
        for p in [p for p, _ in procs.values()] + [ref]:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _records(out_dir):
    recs = {}
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        recs[(rec["arch"], rec["shape"])] = rec
    return recs


def test_hubert_decode_is_skipped():
    from repro_torch.launch.dryrun import run_one

    for shape in ("decode_32k", "long_500k"):
        rec = run_one("hubert_xlarge", shape, multi_pod=False, smoke=True,
                      mesh="2x2", out_dir="", verbose=False)
        assert rec["mode"] is None and "skipped" in rec


def test_scoring_inputs_match_the_reference(runs):
    from repro_torch.launch.serve import abstract_scoring_inputs

    _, ref = runs()
    got = [[list(t.shape), str(t.dtype).replace("torch.", "")]
           for t in abstract_scoring_inputs(3, 5, 7)]
    assert got == ref["scoring"]
    assert all(t.device.type == "meta"
               for t in abstract_scoring_inputs(3, 5, 7))


@pytest.mark.parametrize("mesh", MESHES)
def test_smoke_sweep_writes_every_combination(runs, mesh):
    from repro_torch.configs.registry import list_archs
    from repro_torch.configs.shapes import SHAPES

    results, _ = runs()
    rc, so, se, out = results[mesh]
    assert rc == 0, (so[-3000:], se[-3000:])
    assert "every combination traced" in so
    recs = _records(out)
    for arch in list_archs():
        for shape in SHAPES:
            if arch == "hubert_xlarge" and SHAPES[shape].kind == "decode":
                assert (arch, shape) not in recs
                continue
            rec = recs[(arch, shape)]
            assert set(KEYS) <= set(rec), (arch, shape)
            assert "not_traced" not in rec, rec
            assert rec["mesh"] == mesh and rec["rank"] == 0
            assert rec["n_chips"] == (4 if mesh == "2x2" else 8)
            assert rec["cost"]["flops"] > 0, (arch, shape)
            assert rec["memory"]["temp_size_in_bytes"] > 0, (arch, shape)
            # every family splits, its prefill and decode steps too
            assert rec["model_split"] == "tp", (arch, shape)


@pytest.mark.parametrize("mesh", MESHES)
def test_held_state_bytes_follow_the_reference_specs(runs, mesh):
    from repro_torch.launch.train import train_key

    results, ref = runs()
    recs = _records(results[mesh][3])
    extra = train_key(0).numel() + 4  # the generator's state, the step
    for (arch, shape), rec in recs.items():
        if rec["mode"] != "train":
            continue
        key = f"{arch}@{mesh}"
        assert arch in DENSE
        assert rec["state_bytes"] == 2 * ref["pieces"][key] + extra, \
            (arch, rec)
        assert ref["pieces"][key] < ref["whole"][key], arch
        # the split's collectives ran
        assert rec["collectives"]["bytes"]["all-reduce"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_serve_held_bytes_are_the_param_and_cache_pieces(runs, mesh):
    """Every prefill and decode record of the smoke sweep: the rank's
    params are exactly the reference's "tp" ``param_specs`` pieces, its
    cache exactly the reference's ``cache_specs`` pieces, and its
    arguments those plus its rows of the batch; the split's collectives
    ran."""
    import math

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import SHAPES, input_specs

    results, ref = runs()
    recs = _records(results[mesh][3])
    data = 2  # both meshes' "data" axis: the rows split over it alone
    seen = 0
    for (arch, shape), rec in recs.items():
        if rec["mode"] == "train":
            continue
        seen += 1
        assert rec["state_bytes"] == ref["pieces"][f"{arch}@{mesh}"], \
            (arch, shape, rec["state_bytes"])
        cache = rec.get("cache_bytes", 0)
        if rec["mode"] == "decode":
            assert cache == ref["cache"][f"{arch}@{mesh}@{shape}"], \
                (arch, shape, cache)
        batch = input_specs(get_smoke_config(arch), SHAPES[shape])
        batch = batch.get("batch", batch)
        rows = sum(t.numel() * t.element_size() // (
            data if t.shape[0] % data == 0 else 1) for t in batch.values())
        assert rec["memory"]["argument_size_in_bytes"] == \
            rec["state_bytes"] + cache + rows, (arch, shape)
        assert rec["collectives"]["bytes"]["all-reduce"] > 0, (arch, shape)
        assert rec["collectives"]["bytes"]["all-gather"] > 0, (arch, shape)
        assert math.isfinite(rec["memory"]["temp_size_in_bytes"])
    assert seen == 3 * 9 + 1  # hubert has no decode step


# the full-size decode_32k records on (16, 16), predicted before the split
# was traced: (arguments, temp) GB ranges and the parent's arguments
DECODE_PREDICTED = {"minitron_8b": ((3.3, 3.5), (0.1, 0.6), 54.12),
                    "deepseek_v3_671b": ((7.2, 7.4), (1.0, 4.0), 1361.0)}


@pytest.mark.parametrize("arch", list(DECODE_PREDICTED))
def test_full_size_decode_holds_its_pieces(arch):
    """minitron-8b (under "tp") and deepseek-v3-671b (under fsdp_tp, the
    dry run's choice past 60 G params) decoding at decode_32k on (16,
    16): the held params are the ``param_specs`` pieces, the cache the
    ``cache_specs`` pieces (8 rows, 2,048 positions a rank), the
    arguments a few GB where the unsplit step held 54.12 and 1,361 GB."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, input_specs
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.mesh import P
    from repro_torch.models import init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import (cache_specs, held_specs,
                                            local_shape, needs_fsdp)
    import math

    cfg = get_config(arch)
    mode = "fsdp_tp" if needs_fsdp(cfg) else "tp"
    rec = run_one(arch, "decode_32k", multi_pod=False, out_dir="",
                  verbose=False)
    assert rec["model_split"] == "tp" and rec["shard_mode"] == mode
    mesh = AbstractMesh((16, 16), ("data", "model"))

    def pieces(tree, specs):
        sps = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
        return sum(math.prod(local_shape(mesh, x.shape, sp)) *
                   x.element_size()
                   for x, sp in zip(tree_flatten(tree)[0], sps))

    params = init_params(0, cfg, device="meta")
    cache = input_specs(cfg, SHAPES["decode_32k"])["cache"]
    assert rec["state_bytes"] == pieces(params, held_specs(mesh, cfg, params,
                                                           mode))
    assert rec["cache_bytes"] == pieces(cache, cache_specs(mesh, cfg, cache))
    (lo, hi), (tlo, thi), parent = DECODE_PREDICTED[arch]
    args = rec["memory"]["argument_size_in_bytes"] / 1e9
    temp = rec["memory"]["temp_size_in_bytes"] / 1e9
    assert lo <= args <= hi and args < parent / 10, args
    assert tlo <= temp <= thi, temp


def test_full_size_minitron_holds_a_sixteenth_of_the_split_leaves():
    """minitron-8b's train state on (16, 16), from ``abstract_state``
    (the dry run's held state): each split leaf 1/16 of its whole, every
    other leaf whole."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.train import ByzTrainConfig, abstract_state
    from repro_torch.sharding.constraints import AbstractMesh

    cfg = get_config("minitron_8b")
    tc = ByzTrainConfig()
    whole = tree_flatten(abstract_state(cfg, tc).params)[0]
    held = tree_flatten(abstract_state(
        cfg, tc, AbstractMesh((16, 16), ("data", "model"))).params)[0]
    split = kept = 0
    for w, h in zip(whole, held):
        n_w, n_h = math.prod(w.shape), math.prod(h.shape)
        assert n_h in (n_w, n_w // 16), (w.shape, h.shape)
        if n_h != n_w:
            split += n_w
        else:
            kept += n_w
    held_n = sum(math.prod(h.shape) for h in held)
    assert held_n == split // 16 + kept
    # the norms alone stay whole: 65 vectors of 4,096
    assert kept == 65 * 4096


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "arctic_480b"])
def test_full_size_moe_decoders_hold_their_param_specs_pieces(arch):
    """deepseek-v3-671b's and arctic-480b's train state on (16, 16), from
    ``abstract_state`` (the dry run's held state): every leaf is exactly
    its ``param_specs`` piece along "model" (the experts, MLA's and the
    attention's heads, the vocabulary; the stacks "model" does not divide
    stay whole), the count computed from the specs."""
    got, want, total = _held_against_specs(arch)
    assert got == want and got < total / 10, (got, total)


# a rank's held param values on (16, 16), and the whole model's
SSM_HELD = {"mamba2_780m": (198_757_632, 857_379_072),
            "jamba_v01_52b": (5_860_335_200, 51_460_000_640)}


@pytest.mark.parametrize("arch", list(SSM_HELD))
def test_full_size_ssm_decoders_hold_their_param_specs_pieces(arch):
    """mamba2-780m's and jamba-v0.1-52b's train state on (16, 16), from
    ``abstract_state``: every leaf is exactly its ``param_specs`` piece
    along "model" (``in_proj`` by column, ``conv_w`` by channel,
    ``out_proj`` by row; jamba's attention, experts and vocabulary; its
    stacked dense MLP, 4 periods on 16 ranks, whole), the count computed
    from the specs and equal to the values the specs give by hand."""
    got, want, total = _held_against_specs(arch)
    assert (got, total) == SSM_HELD[arch], (got, total)
    assert got == want


def _held_against_specs(arch):
    """(a rank's held param values of ``arch`` on (16, 16) from
    ``abstract_state``, the values its ``param_specs`` pieces give, the
    whole model's), each leaf's held shape checked against its piece's."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import ByzTrainConfig, abstract_state
    from repro_torch.models import init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import model_split, param_specs

    cfg = get_config(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    assert model_split(cfg) == model_split(cfg, "fsdp_tp") == "tp"
    whole = tree_flatten(init_params(0, cfg, device="meta"))[0]
    specs = tree_flatten(param_specs(mesh, cfg, init_params(
        0, cfg, device="meta")), is_leaf=lambda x: isinstance(x, P))[0]
    held = tree_flatten(abstract_state(cfg, ByzTrainConfig(), mesh).params)[0]
    want = 0
    for w, sp, h in zip(whole, specs, held):
        shape = [n // 16 if e == "model" else n
                 for n, e in zip(w.shape, tuple(sp) + (None,) * w.dim())]
        assert tuple(h.shape) == tuple(shape), (w.shape, sp, h.shape)
        want += math.prod(shape)
    got = sum(math.prod(h.shape) for h in held)
    total = sum(math.prod(w.shape) for w in whole)
    return got, want, total


@pytest.mark.parametrize("mesh", ["", "2x8"], ids=["16x16", "2x8"])
@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_v3_671b"])
def test_smoke_moe_decoders_trace_with_more_ranks_than_experts(arch, mesh):
    """The smoke MoE decoders (4 experts) traced by the CLI's ``run_one``
    on the default (16, 16) mesh and on (2, 8): the "model" axis has more
    ranks than experts, so ``param_specs`` leaves the expert stacks whole
    and rank 0 takes an empty ``split_range`` of them.  The step traces
    (no ``not_traced``), splits, runs its collectives, and holds exactly
    the ``held_specs`` pieces of params and g."""
    import math

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.dryrun import mesh_shape, run_one
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import train_key
    from repro_torch.models import init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import held_specs, local_shape

    cfg = get_smoke_config(arch)
    dims, names = mesh_shape(False, mesh)
    assert cfg.n_experts < dims[-1]
    rec = run_one(arch, "train_4k", multi_pod=False, smoke=True, mesh=mesh,
                  out_dir="", verbose=False)
    assert "not_traced" not in rec, rec
    assert rec["model_split"] == "tp"
    assert rec["collectives"]["bytes"]["all-reduce"] > 0
    params = init_params(0, cfg, device="meta")
    specs = tree_flatten(held_specs(AbstractMesh(dims, names), cfg, params),
                         is_leaf=lambda x: isinstance(x, P))[0]
    amesh = AbstractMesh(dims, names)
    pieces = sum(math.prod(local_shape(amesh, w.shape, sp)) * w.element_size()
                 for w, sp in zip(tree_flatten(params)[0], specs))
    extra = train_key(0).numel() + 4  # the generator's state, the step
    assert rec["state_bytes"] == 2 * pieces + extra, (rec["state_bytes"],
                                                       pieces)


# a rank's held params and g under fsdp_tp on (16, 16) and (2, 16, 16):
# the reference's state pieces ("data" x "model")
FSDP_HELD = {"deepseek_v3_671b": 12_221_253_632, "arctic_480b": 8_567_222_272}


@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model")),
                                  ((2, 16, 16), ("pod", "data", "model"))],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(FSDP_HELD))
def test_full_size_fsdp_decoders_hold_data_by_model_pieces(arch, mesh):
    """deepseek-v3-671b's and arctic-480b's train state under fsdp_tp,
    from ``abstract_state`` (the dry run's held state): every leaf exactly
    its ``param_specs`` piece over "data" and "model", params and g
    12,221,253,632 B (v3) and 8,567,222,272 B (arctic) a rank."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import ByzTrainConfig, abstract_state
    from repro_torch.models import init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import local_shape, param_specs

    cfg = get_config(arch)
    amesh = AbstractMesh(*mesh)
    state = abstract_state(cfg, ByzTrainConfig(shard_mode="fsdp_tp"), amesh)
    whole = tree_flatten(init_params(0, cfg, device="meta"))[0]
    specs = tree_flatten(param_specs(amesh, cfg, init_params(
        0, cfg, device="meta"), "fsdp_tp"), is_leaf=lambda x: isinstance(
            x, P))[0]
    want = 0
    for w, sp, h in zip(whole, specs, tree_flatten(state.params)[0]):
        assert tuple(h.shape) == local_shape(amesh, w.shape, sp), (sp,)
        want += math.prod(h.shape) * h.element_size()
    got = sum(x.numel() * x.element_size()
              for x in tree_flatten((state.params, state.g))[0])
    assert got == 2 * want == FSDP_HELD[arch], got


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
def test_smoke_fsdp_held_bytes_are_the_param_specs_pieces(mesh):
    """deepseek-v3's smoke config traced under fsdp_tp (on (2, 2, 2) with
    the pods the workers, the dry run's multi-pod choice, so that the
    rows split over "data"): the held state is the sum of its fsdp_tp
    ``param_specs`` pieces, params and g; the layers are gathered over
    "data" and, where the rows split, the gradients reduce-scattered."""
    import math

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.dryrun import mesh_shape, run_one
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import ByzTrainConfig, train_key
    from repro_torch.models import init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import local_shape, param_specs

    arch = "deepseek_v3_671b"
    pods = mesh == "2x2x2"
    tc = ByzTrainConfig(shard_mode="fsdp_tp", n_byz=1,
                        worker_axes_override=("pod",) if pods else ())
    rec = run_one(arch, "train_4k", multi_pod=False, smoke=True, mesh=mesh,
                  train_cfg=tc, out_dir="", verbose=False)
    assert "not_traced" not in rec, rec
    cfg = get_smoke_config(arch)
    amesh = AbstractMesh(*mesh_shape(False, mesh))
    params = init_params(0, cfg, device="meta")
    specs = tree_flatten(param_specs(amesh, cfg, params, "fsdp_tp"),
                         is_leaf=lambda x: isinstance(x, P))[0]
    pieces = sum(math.prod(local_shape(amesh, w.shape, sp)) * w.element_size()
                 for w, sp in zip(tree_flatten(params)[0], specs))
    extra = train_key(0).numel() + 4  # the generator's state, the step
    assert rec["state_bytes"] == 2 * pieces + extra
    kinds = rec["collectives"]["bytes"]
    assert kinds["all-gather"] > 0
    assert ("reduce-scatter" in kinds) == pods, kinds


@pytest.mark.parametrize("mesh", MESHES)
def test_smoke_zero3_held_bytes_are_the_reference_zero3_pieces(runs, mesh):
    """deepseek-v3's smoke config traced under zero3 by ``run_one``: the
    held state is twice the reference's zero3 pieces (the "fsdp" slots
    over "model", computed in ``REF_SCRIPT``) plus the key and the step;
    each layer is gathered over "model" and, the worker's rows split over
    it, the gathered leaves' gradients reduce-scattered."""
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.train import ByzTrainConfig, train_key

    arch = "deepseek_v3_671b"
    _, ref = runs()
    tc = ByzTrainConfig(shard_mode="zero3", n_byz=1)
    rec = run_one(arch, "train_4k", multi_pod=False, smoke=True, mesh=mesh,
                  train_cfg=tc, out_dir="", verbose=False)
    assert "not_traced" not in rec, rec
    assert rec["model_split"] == "zero3"
    key = f"{arch}@{mesh}"
    extra = train_key(0).numel() + 4  # the generator's state, the step
    assert rec["state_bytes"] == 2 * ref["zero3"][key] + extra, \
        (rec["state_bytes"], ref["zero3"][key])
    assert ref["zero3"][key] < ref["whole"][key]
    kinds = rec["collectives"]["bytes"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0, kinds
