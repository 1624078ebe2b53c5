"""The tensor-parallel split of cross-attention (``models.layers.
cross_attn_forward`` over "model": the heads of ``_gqa_split`` with the
vision tokens as the keys' and values' source; llama-3.2-vision-90b) on
gloo ranks of the CPU.

One spawn of 4 ranks does all the work, in a module-scoped fixture:

* one cross-attention layer (``models.model._apply_layer``: the norm, the
  gated cross-attention, the residual) split against the whole layer,
  with its gate opened to 0.5 (at its initial 0 every weight of the
  layer has a zero gradient, and a wrong split would pass), on "model"
  groups of (1, 2) and (1, 4) made from the 4 ranks, in f32: the output
  and the gradients of x, of the vision tokens and of every leaf's piece,
  the gate's included, within ``LAYER_REL`` of each tensor's max-abs.
  Two layers: the llama-3.2-vision smoke config's (4 heads, 2 kv heads
  of 32: on 4 ranks a rank's ``wk``/``wv`` piece is half a kv head, which
  ``take`` gathers) and a ragged one (6 heads and 3 kv heads of 8: on 4
  ranks a rank's columns straddle its heads, on 2 ranks its heads read
  kv heads of two groups); the smoke layer once more in f64 (the
  layers' f32 casts made f64 inside the ranks), within ``F64_REL``;
* two planted faults on the smoke layer on (1, 4): the gate applied to
  each rank's partial before the sum, whose gradient is then each rank's
  part, not summed; and ``wo``'s row-split product left unsummed (the
  all-reduce left out).  Each must exceed the limit;
* the llama-3.2-vision smoke config in f32 (remat on, a logit chunk of
  8, gates open) split against the whole model on (2, 2) and (1, 4), as
  TINY is in ``tests/test_torch_tp.py`` (its ``_split_vs_whole``): the
  loss and every gradient piece, the pieces' ``param_specs`` shapes, and
  ``gather_params`` back bit for bit.
"""
import contextlib

import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_tp import LOSS_RTOL, _split_vs_whole
from test_torch_tp_ssm import _cut, _groups, _paths, _unflatten
from test_torch_train_mesh import GATE, open_gates
# f32, the layer's output and gradients against the whole layer, of each
# tensor's max-abs: the split sums the row-split products and the
# gathered leaves' gradients in another order
LAYER_REL = 1e-5
F64_REL = 1e-12
CROSS = dict(n_layers=1, vocab=64, d_ff=0, mixer_pattern=("cross",),
             mlp_pattern=("none",), input_kind="tokens+vision",
             dtype="float32")
LAYERS = {
    "smoke": dict(name="cross-smoke", d_model=128, n_heads=4, n_kv_heads=2,
                  n_vision_tokens=17),
    "ragged": dict(name="cross-ragged", d_model=32, n_heads=6, n_kv_heads=3,
                   head_dim=8, n_vision_tokens=5),
}
LAYER_MESHES = ((1, 2), (1, 4))
LAYER_IDS = ["1x2", "1x4"]
MODEL_MESHES = ((2, 2), (1, 4))
# f32, the smoke model's gradient pieces against the whole model's, of
# each leaf's max-abs (as the other decoders')
MODEL_REL = 1e-5
SEQ = 12
SPAWN_TIMEOUT = 300


def _layer_vs_whole(shape, case, dtype=torch.float32):
    """One cross-attention layer split against the whole on the "model"
    groups of ``shape``: (worst error of max-abs over the output and every
    gradient, the worst tensor's name, this rank's held ``wk`` columns),
    or None off the mesh."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.models import ModelConfig
    from repro_torch.models.layers import Draw
    from repro_torch.models.model import _apply_layer, _init_layer
    from repro_torch.sharding.constraints import AbstractMesh, ModelAxis
    from repro_torch.sharding.rules import held_specs

    group, coord = _groups(shape)
    if group is None:
        return None
    cfg = ModelConfig(**dict(CROSS, **LAYERS[case]))
    layer = _init_layer(Draw.from_seed(3, "cpu"), cfg, "cross", "none")
    layer["mixer"]["gate"].fill_(GATE)
    layer = _unflatten(tree_flatten(layer)[1], [
        x.to(dtype) for x in tree_flatten(layer)[0]])
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, SEQ, cfg.d_model, generator=gen, dtype=dtype)
    vision = torch.randn(2, cfg.n_vision_tokens, cfg.d_model, generator=gen,
                         dtype=dtype)
    ct = torch.randn(2, SEQ, cfg.d_model, generator=gen, dtype=dtype)
    pos = torch.arange(SEQ)[None].expand(2, SEQ)
    held = held_specs(AbstractMesh(shape, ("data", "model")), cfg, layer)
    axis = ModelAxis(group, coord, shape[1], held)
    names = [".".join(k) for k in _paths(layer)]

    def run(params, tp):
        leaves, treedef = tree_flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        xx = x.detach().requires_grad_(True)
        vv = vision.detach().requires_grad_(True)
        out, _, _ = _apply_layer(
            _unflatten(treedef, leaves), cfg, "cross", "none", xx,
            positions=pos, vision=vv, tp=tp, held=held if tp else None)
        grads = torch.autograd.grad((out * ct).sum(), [xx, vv, *leaves])
        return [out.detach(), *grads]

    whole = run(layer, None)
    mine = _cut(axis, layer, held)
    got = run(mine, axis)
    want = whole[:3] + tree_flatten(_cut(axis, _unflatten(
        tree_flatten(layer)[1], whole[3:]), held))[0]
    worst, where = 0.0, ""
    for name, a, b in zip(["out", "x", "vision", *names], got, want):
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if err >= worst:
            worst, where = err, name
    return worst, where, tuple(mine["mixer"]["wk"].shape)


def _gate_before_the_sum(params, cfg, x, vision, tp=None, held=None):
    """The planted fault: the gate applied to each rank's partial product
    before the sum, so that the gate's gradient on each rank is its own
    part."""
    from repro_torch.models import layers, tp as tp_mod

    sound = tp_mod.reduce_from_model
    tp_mod.reduce_from_model = lambda y, axis: y
    try:
        part = layers._gqa_split(params, held, cfg, x, None, False, 0, tp,
                                 kv=vision)
    finally:
        tp_mod.reduce_from_model = sound
    gate = torch.tanh(params["gate"].to(layers.F32)).to(x.dtype)
    return tp_mod.reduce_from_model(gate * part, tp)


@contextlib.contextmanager
def cross_wo_unsummed():
    """The planted fault: the cross-attention's row-split ``wo`` product
    left unsummed (``reduce_from_model`` the identity inside
    ``cross_attn_forward``, each rank keeping its own heads' partial; the
    reduce's gradient is the identity, so the backward pass reads as
    before).  ``tools/vision_split_fault.py`` plants it too."""
    from repro_torch.models import model, tp as tp_mod

    sound = model.cross_attn_forward

    def unsummed(*args, **kw):
        reduce = tp_mod.reduce_from_model
        tp_mod.reduce_from_model = lambda y, axis: y
        try:
            return sound(*args, **kw)
        finally:
            tp_mod.reduce_from_model = reduce

    model.cross_attn_forward = unsummed
    try:
        yield
    finally:
        model.cross_attn_forward = sound


def _faults():
    """The smoke layer on (1, 4) under each planted fault."""
    from repro_torch.models import model

    out = {}
    sound = model.cross_attn_forward
    model.cross_attn_forward = (
        lambda p, c, x, v, tp=None, held=None:
        _gate_before_the_sum(p, c, x, v, tp, held) if tp is not None
        else sound(p, c, x, v))
    try:
        out["gate-before-sum"] = _layer_vs_whole((1, 4), "smoke")
    finally:
        model.cross_attn_forward = sound
    with cross_wo_unsummed():
        out["wo-unsummed"] = _layer_vs_whole((1, 4), "smoke")
    return out


def _job(rank):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_params, layers

    torch.set_num_threads(1)
    out = {}
    for shape in LAYER_MESHES:
        for case in LAYERS:
            out[(shape, case)] = _layer_vs_whole(shape, case)
    f32, layers.F32 = layers.F32, torch.float64
    try:
        out["f64"] = _layer_vs_whole((1, 4), "smoke", torch.float64)
    finally:
        layers.F32 = f32
    out.update(_faults())
    cfg = get_smoke_config("llama32_vision_90b").replace(dtype="float32",
                                                         logit_chunk=8)
    for shape in MODEL_MESHES:
        out[shape] = _split_vs_whole(make_debug_mesh(*shape), cfg, open_gates(
            init_params(0, cfg, device="cpu"), cfg))
    return out


@pytest.fixture(scope="module")
def results():
    return spawn(_job, 4, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("case", list(LAYERS))
@pytest.mark.parametrize("shape", LAYER_MESHES, ids=LAYER_IDS)
def test_cross_layer_split_matches_whole(results, shape, case):
    ranks = [out[(shape, case)] for out in results
             if out[(shape, case)] is not None]
    assert len(ranks) == shape[0] * shape[1]
    for rank, (worst, where, _) in enumerate(ranks):
        assert worst <= LAYER_REL, (rank, where, worst)
    if (shape, case) == ((1, 4), "smoke"):  # half a kv head a rank
        assert {wk for _, _, wk in ranks} == {(128, 16)}


def test_cross_layer_split_matches_whole_in_f64(results):
    for rank, out in enumerate(results):
        worst, where, _ = out["f64"]
        assert worst <= F64_REL, (rank, where, worst)


@pytest.mark.parametrize("fault", ["gate-before-sum", "wo-unsummed"])
def test_planted_faults_exceed_the_limit(results, fault):
    for rank, out in enumerate(results):
        worst, where, _ = out[fault]
        assert worst > 100 * LAYER_REL, (rank, fault, where, worst)
        if fault == "gate-before-sum":  # only the gate's gradient is off
            assert where == "mixer.gate", (rank, where)


@pytest.mark.parametrize("shape", MODEL_MESHES, ids=["2x2", "1x4"])
def test_vision_smoke_model_split_matches_whole(results, shape):
    for rank, out in enumerate(results):
        loss, whole_loss, worst, shapes, want, same = out[shape]
        assert loss == pytest.approx(whole_loss, rel=LOSS_RTOL), rank
        assert worst <= MODEL_REL, (rank, worst)
        assert shapes == want, rank
        assert same, rank
    assert len({out[shape][0] for out in results}) == 1
