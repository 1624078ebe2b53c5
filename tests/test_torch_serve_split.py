"""The serving steps' tensor-parallel split (``launch.serve.make_prefill_step``
and ``make_serve_step`` with a mesh) on gloo ranks of the CPU, against the
reference's ``apply_prefill`` and ``apply_decode``.

The inputs are made here from seeds, as numpy arrays: every family's
smoke config in f32 (minitron-8b: GQA with 2 kv heads; deepseek-v3-671b:
MLA and MoE; arctic-480b; mamba2-780m; jamba-v0.1-52b; llama-3.2-vision-
90b with its cross-attention gates opened to 0.5; hubert-xlarge, prefill
only; and minitron-8b with a sliding window of 8, whose writes past the
window clamp to its last slot), its ``init_params`` weights, a batch of
``B`` rows of ``S`` positions, a decode cache of ``L`` positions filled
with normal values at every position, and the tokens of ``IDX``'s decode
steps.  One reference subprocess computes the prefill's logits and the
decode steps' logits, next tokens and caches; meanwhile one spawn of 4
gloo ranks runs the port's split steps on the rank's ``param_specs``
pieces and ``cache_specs`` pieces on four meshes: (1, 2) and (1, 4) under
"tp", (2, 2) under fsdp_tp (each layer gathered over "data", the rows
split over it) and the pod mesh (1, 2, 2) under "tp" (the rows split over
"data", both pods running them).  The decode steps' write positions 6-9
cross the boundary of the cache's blocks at 8 on every mesh.

Held, in f32: the prefill's and each step's logits within ``REL`` of
their max-abs, each rank's cache pieces within ``REL`` of the max-abs of
the same slices of the reference's new cache (and the whole cache
``gather_cache`` puts back together), the next tokens equal; the held
params exactly their ``param_specs`` pieces and the cache exactly
its ``cache_specs`` pieces, no attention cache whole in length.  Planted
faults in the ranks: the merge of the softmax over "model" left out
(``models.layers._merge_sums``), the write at the wrong rank
(``layers._cache_owner``) and the SSM norm's sum over "model" left out;
each must fail those checks.

JAX runs only in the reference subprocess; the spawned ranks import this
module and never load it.
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
           JAX_PLATFORMS="cpu")
ARCHS = ("minitron_8b", "deepseek_v3_671b", "arctic_480b", "mamba2_780m",
         "jamba_v01_52b", "llama32_vision_90b", "hubert_xlarge", "window")
MESHES = (((1, 2), "tp"), ((1, 4), "tp"), ((2, 2), "fsdp_tp"),
          ((1, 2, 2), "tp"))
MESH_IDS = ["1x2", "1x4", "2x2-fsdp_tp", "1x2x2"]
B, S, L = 4, 12, 16
IDX = (6, 7, 8, 9)  # across the blocks' boundary at 8 on every mesh
WINDOW = 8
GATE = 0.5
# f32, of each tensor's max-abs: the split sums the row-split products,
# the softmax's partial sums and the gathered pieces in another order
# than the whole pass, and the port's f32 arithmetic differs from XLA's
REL = 1e-5
# (arch, mesh, fault): the planted faults, each on a mesh that shows it
FAULTS = (("minitron_8b", (1, 4), "merge"), ("minitron_8b", (1, 2), "write"),
          ("deepseek_v3_671b", (1, 2), "merge"),
          ("deepseek_v3_671b", (1, 4), "write"),
          ("mamba2_780m", (1, 2), "norm"))
TIMEOUT = 600

REF_SCRIPT = r"""
import sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models.model import apply_decode, apply_prefill, init_cache, init_params

src = np.load(sys.argv[1])
out = {}
for arch in %(archs)r:
    name = "minitron_8b" if arch == "window" else arch
    cfg = get_smoke_config(name).replace(dtype="float32")
    if arch == "window":
        cfg = cfg.replace(sliding_window=%(window)d)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(
        partial(init_params, cfg=cfg), jax.random.PRNGKey(0)))
    n = treedef.num_leaves
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(src[f"{arch}_p{i}"]) for i in range(n)])
    batch = {k[len(arch) + 3:]: jnp.asarray(src[k]) for k in src.files
             if k.startswith(f"{arch}_b_")}
    out[f"{arch}_prefill"] = np.asarray(
        jax.jit(partial(apply_prefill, cfg=cfg))(params, batch=batch))
    if not cfg.causal:
        continue
    cdef = jax.tree_util.tree_structure(init_cache(cfg, 1, 1))
    cache = jax.tree_util.tree_unflatten(cdef, [
        jnp.asarray(src[f"{arch}_c{i}"]) for i in range(cdef.num_leaves)])
    step = jax.jit(partial(apply_decode, cfg=cfg))
    for t, idx in enumerate(%(idx)r):
        db = {"tokens": jnp.asarray(src[f"{arch}_t{t}"])}
        if "vision" in batch:
            db["vision"] = batch["vision"]
        logits, cache = step(params, batch=db, caches=cache,
                             cache_index=jnp.int32(idx))
        out[f"{arch}_logits{t}"] = np.asarray(logits)
        out[f"{arch}_next{t}"] = np.asarray(jnp.argmax(logits, axis=-1))
        for i, x in enumerate(jax.tree_util.tree_leaves(cache)):
            out[f"{arch}_cache{t}_{i}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def config(arch):
    """The f32 smoke config of ``arch`` ("window": minitron-8b's with a
    sliding window of ``WINDOW``)."""
    from repro_torch.configs import get_smoke_config

    if arch == "window":
        return get_smoke_config("minitron_8b").replace(
            dtype="float32", sliding_window=WINDOW)
    return get_smoke_config(arch).replace(dtype="float32")


def make_inputs(path):
    """The numpy inputs of every arch, from seeds, into the npz ``path``:
    params ``{arch}_p{i}`` (the port's ``init_params(0)``, the
    cross-attention gates opened), the prefill batch ``{arch}_b_{key}``,
    the decode cache ``{arch}_c{i}`` (normal values everywhere) and step
    t's tokens ``{arch}_t{t}``, leaves in flatten order."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.model import params_to_numpy

    out = {}
    for k, arch in enumerate(ARCHS):
        cfg = config(arch)
        rs = np.random.RandomState(k)
        params = init_params(0, cfg, device="cpu")
        for pos, mixer in enumerate(cfg.mixer_pattern):
            if mixer == "cross":
                params["body"][pos]["mixer"]["gate"].fill_(GATE)
        for i, x in enumerate(tree_flatten(params_to_numpy(params))[0]):
            out[f"{arch}_p{i}"] = x
        if cfg.input_kind == "frames":
            out[f"{arch}_b_frames"] = rs.randn(
                B, S, cfg.frame_dim).astype(np.float32)
        else:
            out[f"{arch}_b_tokens"] = rs.randint(
                0, cfg.vocab, (B, S)).astype(np.int32)
        if cfg.input_kind == "tokens+vision":
            out[f"{arch}_b_vision"] = rs.randn(
                B, cfg.n_vision_tokens, cfg.d_model).astype(np.float32)
        if not cfg.causal:
            continue
        for i, x in enumerate(tree_flatten(init_cache(cfg, B, L,
                                                      device="meta"))[0]):
            out[f"{arch}_c{i}"] = rs.randn(*x.shape).astype(np.float32)
        for t in range(len(IDX)):
            out[f"{arch}_t{t}"] = rs.randint(0, cfg.vocab,
                                             (B, 1)).astype(np.int32)
    np.savez(path, **out)


def _mesh(shape):
    """A ``DeviceMesh`` of ``shape`` on the world's first ranks (the
    others take no part in it), or None on a rank outside it."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    n = math.prod(shape)
    mesh = DeviceMesh("cpu", torch.arange(n).view(*shape),
                      mesh_dim_names=names)
    return mesh if dist.get_rank() < n else None


@contextlib.contextmanager
def fault(name):
    """The planted fault ``name`` in this process: "merge" leaves out the
    sums of the softmax's partials over "model" (each rank's softmax over
    its own positions), "write" sends each write to the next rank's block
    (the position's slot there), "norm" leaves out the SSM gated norm's
    sum over "model"; None: none."""
    from repro_torch.models import layers, tp

    sound = (layers._merge_sums, layers._cache_owner, tp.sum_over_model)
    if name == "merge":
        layers._merge_sums = lambda l, o, axis: (l, o)
    elif name == "write":
        layers._cache_owner = lambda start, width, axis: (
            start // width + 1) % axis.size
    elif name == "norm":
        tp.sum_over_model = lambda x, axis: x
    try:
        yield
    finally:
        layers._merge_sums, layers._cache_owner, tp.sum_over_model = sound


def run_split(mesh, mode, arch, src):
    """The split prefill and decode steps of ``arch`` on ``mesh``: {the
    prefill's logits, each step's logits, next tokens and cache pieces,
    the held params' and cache's shapes, this rank's coordinates}."""
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.model import (cache_from_numpy, cache_to_numpy,
                                          gather_cache, params_from_numpy,
                                          shard_cache, shard_params)

    cfg = config(arch)
    treedef = tree_flatten(init_params(0, cfg, device="meta"))[1]
    n = len(tree_flatten(init_params(0, cfg, device="meta"))[0])
    params = params_from_numpy(tree_unflatten(
        treedef, [src[f"{arch}_p{i}"] for i in range(n)]), "cpu")
    held = shard_params(params, mesh, cfg, mode)
    batch = {k[len(arch) + 3:]: torch.from_numpy(src[k]) for k in src.files
             if k.startswith(f"{arch}_b_")}
    out = {"prefill": make_prefill_step(cfg, mesh, mode)(held, batch).numpy(),
           "held": [tuple(x.shape) for x in tree_flatten(held)[0]],
           "coords": {a: mesh.get_local_rank(a)
                      for a in mesh.mesh_dim_names}}
    if not cfg.causal:
        return out
    nc = len(tree_flatten(init_cache(cfg, 1, 1, device="meta"))[0])
    cache = shard_cache(cache_from_numpy(
        [src[f"{arch}_c{i}"] for i in range(nc)], cfg, "cpu"), mesh, cfg)
    step = make_serve_step(cfg, mesh, mode)
    for t, idx in enumerate(IDX):
        db = {"tokens": torch.from_numpy(src[f"{arch}_t{t}"])}
        if "vision" in batch:
            db["vision"] = batch["vision"]
        nxt, logits, cache = step(held, db, cache, idx)
        out[f"logits{t}"], out[f"next{t}"] = logits.numpy(), nxt.numpy()
        out[f"cache{t}"] = tree_flatten(cache_to_numpy(cache))[0]
    # the whole cache back from every rank's pieces
    out["whole"] = tree_flatten(cache_to_numpy(gather_cache(
        cache, mesh, cfg, B, L)))[0]
    return out


def _job(rank, path):
    torch.set_num_threads(1)
    src = np.load(path)
    out = {}
    for shape, mode in MESHES:
        mesh = _mesh(shape)
        if mesh is None:
            continue
        for arch in ARCHS:
            out[(shape, arch, None)] = run_split(mesh, mode, arch, src)
        for arch, fshape, name in FAULTS:
            if fshape == shape:
                with fault(name):
                    out[(shape, arch, name)] = run_split(mesh, mode, arch,
                                                         src)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, each rank's runs): the reference subprocess
    and the spawn of 4 ranks side by side."""
    tmp = tmp_path_factory.mktemp("serve_split")
    src, ref = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    make_inputs(src)
    script = REF_SCRIPT % {"archs": ARCHS, "window": WINDOW, "idx": IDX}
    proc = subprocess.Popen([sys.executable, "-c", script, src, ref],
                            env=ENV, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn(_job, 4, (src,), timeout=TIMEOUT)
        so, se = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return np.load(ref), ranks


def _piece(whole, spec, coords, sizes):
    """This rank's piece of ``whole`` under ``spec`` at ``coords`` (the
    first axis of an entry major, as ``api.mesh_exec._local_piece``)."""
    for j, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = [a for a in axes if a is not None]
        if not axes:
            continue
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * sizes[a] + coords[a], parts * sizes[a]
        width = whole.shape[j] // parts
        whole = whole.take(range(idx * width, (idx + 1) * width), axis=j)
    return whole


def _cache_specs(shape, arch):
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import init_cache
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import cache_specs

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = AbstractMesh(shape, names)
    cfg = config(arch)
    whole = init_cache(cfg, B, L, device="meta")
    return (tree_flatten(cache_specs(mesh, cfg, whole),
                         is_leaf=lambda x: isinstance(x, P))[0],
            [tuple(x.shape) for x in tree_flatten(whole)[0]],
            dict(zip(names, shape)), mesh)


def _cache_names(arch):
    """The name of each cache leaf, in flatten order."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.models import init_cache
    from repro_torch.sharding.rules import _map_with_name

    return tree_flatten(_map_with_name(
        lambda name, x: name, init_cache(config(arch), 1, 1,
                                         device="meta")))[0]


def _rel(got, want):
    """max |got - want| of max |want| (NaN reads as inf)."""
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    return float("inf") if np.isnan(err) else float(err)


def _errors(ref, rep, shape, arch):
    """(the worst logits error of max-abs, the worst cache piece's (and
    of the whole cache gathered back from the pieces), the next tokens
    all equal) of one rank's run."""
    worst = _rel(rep["prefill"], ref[f"{arch}_prefill"])
    cache_worst, same = 0.0, True
    if config(arch).causal:
        specs, _, sizes, _ = _cache_specs(shape, arch)
        for t in range(len(IDX)):
            worst = max(worst, _rel(rep[f"logits{t}"], ref[f"{arch}_logits{t}"]))
            same &= bool(np.array_equal(rep[f"next{t}"], ref[f"{arch}_next{t}"]))
            for i, (got, sp) in enumerate(zip(rep[f"cache{t}"], specs)):
                if got.size:
                    want = _piece(ref[f"{arch}_cache{t}_{i}"], sp,
                                  rep["coords"], sizes)
                    cache_worst = max(cache_worst, _rel(got, want))
        last = len(IDX) - 1
        for i, got in enumerate(rep["whole"]):
            if got.size:
                cache_worst = max(cache_worst, _rel(
                    got, ref[f"{arch}_cache{last}_{i}"]))
    return worst, cache_worst, same


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_split_serving_matches_the_reference(runs, mesh, arch):
    ref, ranks = runs
    shape = mesh[0]
    for rank, out in enumerate(ranks):
        rep = out.get((shape, arch, None))
        if rep is None:  # a rank outside the mesh
            continue
        worst, cache_worst, same = _errors(ref, rep, shape, arch)
        assert worst <= REL, (rank, worst)
        assert cache_worst <= REL, (rank, cache_worst)
        assert same, rank


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_split_serving_holds_only_its_pieces(runs, mesh, arch):
    """The rank's params are exactly its ``param_specs`` pieces and its
    cache exactly its ``cache_specs`` pieces: every attention cache's
    length (the latents' too) is 1/M of the whole, every SSM state's
    heads 1/M, the rows 1/|data| where it divides them."""
    import math

    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import init_params
    from repro_torch.sharding.rules import local_shape, param_specs

    _, ranks = runs
    shape, mode = mesh
    cfg = config(arch)
    specs, whole, sizes, amesh = _cache_specs(shape, arch)
    names = _cache_names(arch)
    params = init_params(0, cfg, device="meta")
    pspecs = tree_flatten(param_specs(amesh, cfg, params, mode),
                          is_leaf=lambda x: isinstance(x, P))[0]
    want = [local_shape(amesh, x.shape, sp)
            for x, sp in zip(tree_flatten(params)[0], pspecs)]
    split = sum(math.prod(w) for w, x in zip(want, tree_flatten(params)[0])
                if w != tuple(x.shape))
    assert split > 0
    for rank, out in enumerate(ranks):
        rep = out.get((shape, arch, None))
        if rep is None:
            continue
        assert rep["held"] == want, rank
        if not cfg.causal:
            continue
        got = [x.shape for x in rep["cache3"]]
        assert got == [local_shape(amesh, w, sp)
                       for w, sp in zip(whole, specs)], rank
        # every attention cache (k, v, ckv, krope) is 1/M of the whole
        # length, every SSM state 1/M of the heads
        split = [(w, g) for w, g, name in zip(whole, got, names)
                 if name in ("k", "v", "ckv", "krope", "h")]
        assert split, arch
        for w, g in split:
            assert g[2] * sizes["model"] == w[2], (rank, w, g)


@pytest.mark.parametrize("arch,shape,name", FAULTS,
                         ids=[f"{a}-{n}" for a, _, n in FAULTS])
def test_planted_faults_fail_the_checks(runs, arch, shape, name):
    ref, ranks = runs
    failed = False
    for out in ranks:
        rep = out.get((shape, arch, name))
        if rep is None:
            continue
        worst, cache_worst, same = _errors(ref, rep, shape, arch)
        failed |= worst > REL or cache_worst > REL or not same
    assert failed
