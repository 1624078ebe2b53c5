"""The tensor-parallel split of the SSM and hybrid decoders (the Mamba-2
mixer of ``repro_torch.models.ssm`` over "model"; mamba2-780m and
jamba-v0.1-52b) on gloo ranks of the CPU.

One spawn of 4 ranks does all the work, in a module-scoped fixture:

* ``torch.autograd.gradcheck`` in f64, over the 2-rank "model" groups of
  a (2, 2) mesh, of ``tp.sum_over_model`` (an all-reduce forward and
  backward) and of the split gated norm that uses it (``ssm.
  _gated_rmsnorm`` over each rank's channels, then a row-split product)
  and of the split Mamba-2 mixer (its f32 casts made f64 for the check),
  as a gradient of the whole computation, each against its plain whole
  twin (every rank perturbs the same entry of the replicated inputs in
  lockstep, the pieces cut through ``copy_to_model``, as
  ``tests/test_torch_tp.py`` does);
* one Mamba-2 layer (``models.model._apply_layer``: the norm, the mixer,
  the residual) split against the whole layer in f32, on "model" groups
  of (1, 2), (1, 3), (1, 4) and (2, 2) made from the 4 ranks: the output
  and the gradients of x and of every leaf's piece within ``LAYER_REL``
  of each tensor's max-abs.  Two layers: the mamba2 smoke config's (8
  heads: 2 a rank on 4 ranks, 2, 3 and 3 on 3, where ``out_proj``'s 256
  rows are held whole) and a ragged one (8 heads of 8, a state of 10,
  chunks of 8 over 20 positions: ``in_proj``'s 156 columns cut its parts
  at other places on every mesh);
* mamba2-780m's and jamba-v0.1-52b's smoke configs in f32 (remat on, a
  logit chunk of 8) split against the whole model on (2, 2) and (1, 4),
  as TINY is in ``tests/test_torch_tp.py`` (its ``_split_vs_whole``):
  the loss and every gradient piece, the pieces' ``param_specs`` shapes,
  the held bytes counted from the specs, and ``gather_params`` back bit
  for bit; jamba composes the SSM split with the attention's (its kv
  heads gathered on 4 ranks), the experts' and its dense MLP held whole;
* a planted fault, the gated norm's reduction over the axis left out
  (each rank's norm reads its own channels' sum of squares only), on the
  smoke layer on (1, 2) and the mamba2 smoke model on (2, 2): it must
  exceed those limits.
"""
import math

import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_tp import LOSS_RTOL, _split_vs_whole

# f32, the layer's output and gradients against the whole layer, of each
# tensor's max-abs: the split sums the norm's squares, the row-split
# products and the gathered leaves' gradients in another order; they read
# 4.3e-7 to 5.4e-7 on the CPU, the planted fault 0.81 to 0.92
LAYER_REL = 1e-6
SSM = dict(n_layers=1, n_heads=1, n_kv_heads=1, d_ff=0, vocab=64,
           mixer_pattern=("ssm",), mlp_pattern=("none",), dtype="float32")
LAYERS = {
    "smoke": dict(name="ssm-smoke", d_model=128, ssm_state=16,
                  ssm_head_dim=32, ssm_chunk=32),
    "ragged": dict(name="ssm-ragged", d_model=32, ssm_state=10,
                   ssm_head_dim=8, ssm_chunk=8),
}
LAYER_SEQ = {"smoke": 40, "ragged": 20}
LAYER_MESHES = ((1, 2), (1, 3), (1, 4), (2, 2))
LAYER_IDS = ["1x2", "1x3", "1x4", "2x2"]
MODELS = ("mamba2_780m", "jamba_v01_52b")
MODEL_MESHES = ((2, 2), (1, 4))
# f32, the smoke models' gradient pieces against the whole model's, of
# each leaf's max-abs (as the MoE decoders'): they read 0.8e-6 to 3.9e-6
# on the CPU; a leaf counted twice or left out reads O(1)
MODEL_REL = 1e-5
SPAWN_TIMEOUT = 300


def _groups(shape):
    """This rank's "model" group of a (data, model) ``shape`` laid on
    ranks [0, data * model) of the world in coordinate order, and its
    coordinate on it, or (None, None) off the mesh; every rank creates
    every group, as ``new_group`` asks."""
    import torch.distributed as dist

    data, model = shape
    rank, mine = dist.get_rank(), (None, None)
    for d in range(data):
        ranks = list(range(d * model, (d + 1) * model))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = (group, rank - d * model)
    return mine


def _cut(axis, tree, held, through_copy=False):
    """Each leaf of the whole ``tree`` cut to this rank's piece under
    ``held`` (through ``copy_to_model`` where asked, so that the piece's
    gradient is the whole leaf's, summed over the ranks)."""
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import tp

    leaves, treedef = tree_flatten(tree)
    specs = tree_flatten(held, is_leaf=lambda x: isinstance(x, P))[0]
    out = []
    for leaf, sp in zip(leaves, specs):
        for j, entry in enumerate(sp):
            if entry == "model":
                k = leaf.shape[j] // axis.size
                if through_copy:
                    leaf = tp.copy_to_model(leaf, axis)
                leaf = leaf.narrow(j, axis.rank * k, k)
        out.append(leaf)
    return tree_unflatten(treedef, out)


def _gradchecks(mesh):
    """{name: (gradcheck passed, max |split - plain|)} in f64."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import axis_size, model_group
    from repro_torch.models import ModelConfig, ssm, tp
    from repro_torch.models.layers import Draw
    from repro_torch.sharding.constraints import ModelAxis
    from repro_torch.sharding.rules import held_specs

    gen = torch.Generator().manual_seed(7)
    f64 = dict(dtype=torch.float64)
    out = {}

    def check(name, fn, plain, *inputs):
        inputs = [x.detach().requires_grad_(True) for x in inputs]
        ok = torch.autograd.gradcheck(
            fn, inputs, eps=1e-6, atol=1e-8, rtol=1e-6)
        with torch.no_grad():
            err = float((fn(*inputs) - plain(*inputs)).abs().max())
        out[name] = (bool(ok), err)

    axis = ModelAxis(model_group(mesh), mesh.get_local_rank("model"),
                     axis_size(mesh, "model"), None)
    r, m = axis.rank, axis.size

    # each rank's partial sum, used by each rank with its own factor
    c = torch.arange(1, m + 1, **f64)
    c2 = torch.arange(m + 1, 2 * m + 1, **f64)
    x = torch.randn(3, 4, generator=gen, **f64)
    check("sum_over_model",
          lambda x: tp.reduce_from_model(tp.sum_over_model(
              tp.copy_to_model(x, axis) * c[r], axis) * c2[r], axis),
          lambda x: tp.reduce_from_model_plain([tp.reduce_from_model_plain(
              [x * ci for ci in c]) * cj for cj in c2]), x)

    # the gated norm over the inner width from each rank's channels, as a
    # gradient of the whole, against the whole norm: the gradient of the
    # sum of squares left on each rank (``reduce_from_model`` alone)
    # would miss the other ranks' parts (the mixer itself computes in f32
    # whatever its operands, so it is held in f32 below)
    width, k = 6 * m, 6
    y = torch.randn(2, 3, width, generator=gen, **f64)
    z = torch.randn(2, 3, width, generator=gen, **f64)
    scale = torch.randn(width, generator=gen, **f64)

    proj = torch.randn(width, 5, generator=gen, **f64)  # row-split after

    def piece(t):
        return tp.copy_to_model(t, axis).narrow(-1, r * k, k)

    def split_norm(y, z, scale):
        normed = ssm._gated_rmsnorm(piece(scale), piece(y), piece(z), width,
                                    axis)
        return tp.reduce_from_model(normed @ proj[r * k:(r + 1) * k], axis)

    def plain_norm(y, z, scale):
        g = y * torch.nn.functional.silu(z)
        g = g * torch.rsqrt(torch.mean(g * g, -1, keepdim=True) + 1e-6)
        return (g * scale) @ proj

    check("gated_rmsnorm", split_norm, plain_norm, y, z, scale)

    # the split mixer as a gradient of the whole, against the whole mixer,
    # with its f32 casts made f64: a gradient summed over the ranks once
    # too often or not at all (B's and C's, the norm's) reads 2x or 1/2
    cfg = ModelConfig(**dict(SSM, name="ssm-f64", d_model=4, ssm_state=2,
                             ssm_head_dim=2, ssm_chunk=4, dtype="float64"))
    params = ssm.init_mamba2(Draw.from_seed(1, "cpu"), cfg, torch.float64)
    held = held_specs(mesh, cfg, params)
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.double() for leaf in leaves]  # A_log, D, dt_bias: f32
    x = torch.randn(1, 6, cfg.d_model, generator=gen, **f64)

    def split(x, *ls):
        tree = _cut(axis, _unflatten(treedef, ls), held, True)
        return ssm.mamba2_forward(tree, cfg, x, tp=axis, held=held)[0]

    def whole(x, *ls):
        return ssm.mamba2_forward(_unflatten(treedef, ls), cfg, x)[0]

    f32, ssm.F32 = ssm.F32, torch.float64
    try:
        check("ssm_split", split, whole, x, *leaves)
    finally:
        ssm.F32 = f32
    return out


def _layer_vs_whole(shape, case):
    """One Mamba-2 layer split against the whole on the "model" groups of
    ``shape``: (worst error of max-abs over the output and every
    gradient, the worst tensor's name, this rank's heads), or None off
    the mesh."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.models import ModelConfig
    from repro_torch.models.layers import Draw
    from repro_torch.models.model import _apply_layer, _init_layer
    from repro_torch.models.ssm import _dims
    from repro_torch.models.tp import split_range
    from repro_torch.sharding.constraints import AbstractMesh, ModelAxis
    from repro_torch.sharding.rules import held_specs

    group, coord = _groups(shape)
    if group is None:
        return None
    cfg = ModelConfig(**dict(SSM, **LAYERS[case]))
    layer = _init_layer(Draw.from_seed(3, "cpu"), cfg, "ssm", "none")
    seq = LAYER_SEQ[case]
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, seq, cfg.d_model, generator=gen)
    ct = torch.randn(2, seq, cfg.d_model, generator=gen)
    pos = torch.arange(seq)[None].expand(2, seq)
    held = held_specs(AbstractMesh(shape, ("data", "model")), cfg, layer)
    axis = ModelAxis(group, coord, shape[1], held)
    names = [".".join(k) for k in _paths(layer)]

    def run(params, tp):
        leaves, treedef = tree_flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        xx = x.detach().requires_grad_(True)
        out, _, _ = _apply_layer(
            _unflatten(treedef, leaves), cfg, "ssm", "none", xx,
            positions=pos, tp=tp, held=held if tp else None)
        grads = torch.autograd.grad((out * ct).sum(), [xx, *leaves])
        return [out.detach(), *grads]

    whole = run(layer, None)
    got = run(_cut(axis, layer, held), axis)
    want = whole[:2] + tree_flatten(_cut(axis, _unflatten(
        tree_flatten(layer)[1], whole[2:]), held))[0]
    worst, where = 0.0, ""
    for name, a, b in zip(["out", "x", *names], got, want):
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if err >= worst:
            worst, where = err, name
    return worst, where, split_range(_dims(cfg)[1], axis)


def _unflatten(treedef, leaves):
    from repro_torch.core.tree_utils import tree_unflatten

    return tree_unflatten(treedef, list(leaves))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix


def _held_bytes(mesh, cfg):
    """(the bytes of this rank's ``shard_params`` pieces, those its
    ``param_specs`` local shapes give)."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import init_params
    from repro_torch.models.model import shard_params
    from repro_torch.sharding.rules import local_shape, param_specs

    params = init_params(0, cfg, device="cpu")
    got = sum(x.numel() * x.element_size()
              for x in tree_flatten(shard_params(params, mesh, cfg))[0])
    specs = tree_flatten(param_specs(mesh, cfg, params),
                         is_leaf=lambda x: isinstance(x, P))[0]
    want = sum(math.prod(local_shape(mesh, x.shape, sp)) * x.element_size()
               for x, sp in zip(tree_flatten(params)[0], specs))
    return got, want


def _job(rank):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import tp

    torch.set_num_threads(1)
    out = {"gradcheck": _gradchecks(make_debug_mesh(2, 2))}
    for shape in LAYER_MESHES:
        for case in LAYERS:
            out[(shape, case)] = _layer_vs_whole(shape, case)
    for shape in MODEL_MESHES:
        mesh = make_debug_mesh(*shape)
        for arch in MODELS:
            cfg = get_smoke_config(arch).replace(dtype="float32",
                                                 logit_chunk=8)
            out[(shape, arch)] = (*_split_vs_whole(mesh, cfg),
                                  _held_bytes(mesh, cfg))
    # the planted fault: each rank's gated norm reads its own channels'
    # sum of squares only
    sound = tp.sum_over_model
    tp.sum_over_model = lambda x, axis: x
    try:
        out["fault-layer"] = _layer_vs_whole((1, 2), "smoke")
        cfg = get_smoke_config("mamba2_780m").replace(dtype="float32",
                                                      logit_chunk=8)
        out["fault-model"] = _split_vs_whole(make_debug_mesh(2, 2), cfg)
    finally:
        tp.sum_over_model = sound
    return out


@pytest.fixture(scope="module")
def results():
    return spawn(_job, 4, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", ["sum_over_model", "gated_rmsnorm",
                                  "ssm_split"])
def test_function_gradcheck_against_plain_twin(results, name):
    for rank, out in enumerate(results):
        ok, err = out["gradcheck"][name]
        assert ok, (rank, name)
        assert err <= 1e-12, (rank, name, err)


@pytest.mark.parametrize("case", list(LAYERS))
@pytest.mark.parametrize("shape", LAYER_MESHES, ids=LAYER_IDS)
def test_ssm_layer_split_matches_whole(results, shape, case):
    ranks = [out[(shape, case)] for out in results
             if out[(shape, case)] is not None]
    assert len(ranks) == shape[0] * shape[1]
    for rank, (worst, where, _) in enumerate(ranks):
        assert worst <= LAYER_REL, (rank, where, worst)
    if shape == (1, 3):  # 8 heads: 2, 3 and 3 a rank
        assert [heads for _, _, heads in ranks] == [(0, 2), (2, 5), (5, 8)]


@pytest.mark.parametrize("arch", MODELS)
@pytest.mark.parametrize("shape", MODEL_MESHES, ids=["2x2", "1x4"])
def test_smoke_model_split_matches_whole(results, shape, arch):
    for rank, out in enumerate(results):
        loss, whole_loss, worst, shapes, want, same, held = out[(shape,
                                                                 arch)]
        assert loss == pytest.approx(whole_loss, rel=LOSS_RTOL), rank
        assert worst <= MODEL_REL, (rank, worst)
        assert shapes == want, rank
        assert held[0] == held[1], (rank, held)
        assert same, rank
    assert len({out[(shape, arch)][0] for out in results}) == 1


def test_planted_norm_fault_exceeds_the_limits(results):
    for rank, out in enumerate(results):
        if out["fault-layer"] is not None:
            assert out["fault-layer"][0] > 100 * LAYER_REL, (rank,
                                                             out["fault-layer"])
        assert out["fault-model"][2] > 100 * MODEL_REL, (rank,
                                                         out["fault-model"][2])


def test_pinned_routing_cycles_over_the_moe_layers():
    """``moe.record_routing`` on jamba's smoke config, whose period holds
    two MoE layers: a pass over the model records one routing a layer
    (recomputed under remat: the two again, in the same order); pinned to
    those, in turn, the loss and its gradient are the unpinned pass's bit
    for bit; pinned to the two swapped, the loss moves."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.models import apply_train, init_params, moe

    cfg = get_smoke_config("jamba_v01_52b").replace(dtype="float32")
    params = init_params(0, cfg, device="cpu")
    batch = next(make_batch_iterator(cfg, 2, 32, seed=3, device="cpu"))
    leaves = tree_flatten(params)[0]

    def run(pin=None):
        with moe.record_routing(pin) as seen:
            loss = apply_train(params, cfg, batch)[0]
            grads = torch.autograd.grad(loss, leaves)
        return seen, loss, grads

    for x in leaves:
        x.requires_grad_(True)
    seen, loss, grads = run()
    assert len(seen) == 4  # two layers, recomputed once
    assert all(torch.equal(a, b) for a, b in zip(seen[:2], seen[2:]))
    assert not torch.equal(seen[0], seen[1])
    again, pinned, pinned_grads = run(seen[:2])
    assert all(torch.equal(a, b) for a, b in zip(again, seen))
    assert torch.equal(pinned, loss)
    assert all(torch.equal(a, b) for a, b in zip(pinned_grads, grads))
    _, swapped, _ = run(seen[1::-1])
    assert not torch.equal(swapped, loss)
