"""The tensor-parallel split (``repro_torch.models.tp``) on gloo ranks of
the CPU.

One spawn of 4 ranks does all the work, in a module-scoped fixture:

* ``torch.autograd.gradcheck`` in f64 of each autograd Function over the
  2-rank "model" groups of a (2, 2) mesh.  A Function's gradient is a
  gradient of the whole computation, so each check feeds a replicated
  input through ``copy_to_model`` (identity forward, the gradient summed
  over the axis backward), as the model does; every rank perturbs the
  same entry in lockstep, and the result must equal the plain
  one-process twin's on the same input;
* ``TINY`` (the mesh trainer's test model) with the split on that (2, 2)
  mesh (two copies of a (1, 2) split side by side) and on a (1, 4) mesh,
  whose ``wk``/``wv`` pieces are half a kv head (2 kv heads over 4 ranks)
  and whose MLP is held whole (``param_specs`` splits a stacked MLP
  leaf's layers, and 4 does not divide its 2): the loss and every piece
  of the gradient against the unsplit one-process model, with remat and
  a logit chunk of 8 so that the cross-entropy runs over chunks;
* the held pieces' shapes, which must be ``param_specs``'s local ones,
  and ``gather_params`` of the pieces, which must give the whole params
  back bit for bit;
* frame inputs (hubert-xlarge's smoke config) on the same meshes: the
  front end and one encoder layer (the frame projection column-split and
  gathered back to the residual, the non-causal attention and the MLP)
  against the whole in f32 and f64 (the layers' f32 casts made f64), and
  the whole smoke model as TINY is, with its vocabulary of 64 split and
  with one of 63, which no "model" axis here divides (the unembedding
  whole beside a split frame projection; the masked cross-entropy's sums
  over the kept positions);
* the decode layers (GQA, MLA's absorbed step, the Mamba-2 step) on the
  rank's pieces and its ``cache_specs`` piece of a cache filled with
  normal values (the attention caches' length, the SSM state's heads
  split over "model"), against the whole layer on the whole cache, in
  f64 (the layers' f32 casts made f64): four steps at write positions
  6-9 of 16, across the blocks' boundary at 8; the output and every
  cache piece within ``DECODE_REL`` of max-abs, and a planted fault a
  layer, which must exceed it: the softmax's merge over "model" left
  out (GQA, MLA), the write at the wrong rank (MLA) and the gated norm's
  sum over "model" left out (Mamba-2).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=256, remat=True, dtype="float32", logit_chunk=8)
# f32: the split sums the row-split products and the vocabulary's
# exponentials in another order; measured 1.06e-6 of max-abs at worst
# (a norm scale's gradient, a sum over every position)
GRAD_REL = 2e-6
LOSS_RTOL = 1e-6
MESHES = ((2, 2), (1, 4))
SPAWN_TIMEOUT = 300
# frame inputs: the smoke config's vocabulary, and one "model" does not
# divide; the front end and layer of max-abs in f32 and in f64
FRAMES_VOCABS = (64, 63)
FRAMES_REL = {"f32": 1e-5, "f64": 1e-12}
# the decode layers in f64, of max-abs, and their planted faults
DECODE_REL = 1e-12
DECODE_LAYERS = {"gqa": ("minitron_8b", ("merge",)),
                 "mla": ("deepseek_v3_671b", ("merge", "write")),
                 "ssm": ("mamba2_780m", ("norm",))}
DECODE_LEN, DECODE_IDX = 16, (6, 7, 8, 9)


def _gradchecks(axis):
    """Each Function of ``models.tp`` as a gradient of the whole
    computation: {name: (gradcheck passed, max |split - plain|)}."""
    from repro_torch.models import tp

    r, m = axis.rank, axis.size
    gen = torch.Generator().manual_seed(5)
    f64 = dict(dtype=torch.float64)
    out = {}

    def check(name, fn, plain, *inputs):
        inputs = [x.detach().requires_grad_(x.is_floating_point())
                  for x in inputs]
        ok = torch.autograd.gradcheck(
            fn, inputs, eps=1e-6, atol=1e-8, rtol=1e-6)
        with torch.no_grad():
            err = float((fn(*inputs) - plain(*inputs)).abs().max())
        out[name] = (bool(ok), err)

    c = torch.arange(1, m + 1, **f64)  # each rank's own factor
    x = torch.randn(3, 4, generator=gen, **f64)
    check("copy_reduce",
          lambda x: tp.reduce_from_model(tp.copy_to_model(x, axis) * c[r],
                                         axis),
          lambda x: tp.reduce_from_model_plain([x * ci for ci in c]), x)
    w = torch.randn(3, 4 * m, generator=gen, **f64)
    check("gather",
          lambda w: tp.reduce_from_model(tp.gather_from_model(
              tp.copy_to_model(w, axis).narrow(1, 4 * r, 4), axis, 1) * c[r],
              axis),
          lambda w: tp.reduce_from_model_plain([tp.gather_from_model_plain(
              w.split(4, dim=1), 1) * ci for ci in c]), w)
    emb = torch.randn(4 * m, 3, generator=gen, **f64)
    tok = torch.randint(0, 4 * m, (2, 5), generator=gen)
    check("vocab_parallel_embed",
          lambda e, t: tp.vocab_parallel_embed(
              tp.copy_to_model(e, axis).narrow(0, 4 * r, 4), t, axis),
          tp.vocab_parallel_embed_plain, emb, tok)
    logits = torch.randn(2, 3, 4 * m, generator=gen, **f64)
    tgt = torch.randint(0, 4 * m, (2, 3), generator=gen)
    check("vocab_parallel_ce",
          lambda z, t: tp.vocab_parallel_ce(
              tp.copy_to_model(z, axis).narrow(-1, 4 * r, 4), t, axis),
          tp.vocab_parallel_ce_plain, logits, tgt)
    stack = torch.randn(2 * m, 3, 2, generator=gen, **f64)

    def from_owner(s):  # layer 2m - 1, held by the last rank
        piece = tp.copy_to_model(s, axis).narrow(0, 2 * r, 2)
        views = piece.unbind(0)
        owner = m - 1
        sl = tp.LayerSlice(views[1] if r == owner else views[0], owner)
        return tp.reduce_from_model(sl.whole(axis) * c[r], axis)

    check("layer_from_owner", from_owner,
          lambda s: tp.reduce_from_model_plain([s[2 * m - 1] * ci
                                                for ci in c]), stack)
    return out


def _split_vs_whole(mesh, cfg=None, params=None):
    """(split loss, whole loss, worst piece error of max-abs, pieces'
    shapes, their param_specs local shapes, gather_params bitwise) of
    ``cfg`` (TINY by default) at ``params`` (by default
    ``init_params(0, cfg)``)."""
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch.train import model_axis_of, train_loss
    from repro_torch.launch.train import worker_grads
    from repro_torch.launch.mesh import P
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.model import gather_params, shard_params
    from repro_torch.sharding.rules import local_shape, param_specs

    cfg = cfg or ModelConfig(**TINY)
    if params is None:
        params = init_params(0, cfg, device="cpu")
    batch = next(make_batch_iterator(cfg, 2, 32, seed=3, device="cpu"))
    treedef = tree_flatten(params)[1]
    whole_g = tree_unflatten(treedef, worker_grads(params, cfg, batch))
    whole_loss = train_loss(params, cfg, batch)
    held = shard_params(params, mesh, cfg)
    got = worker_grads(held, cfg, batch, model_axis_of(mesh, cfg))
    loss = train_loss(held, cfg, batch, mesh)
    worst = 0.0
    for a, b in zip(got, tree_flatten(shard_params(whole_g, mesh, cfg))[0]):
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    specs = tree_flatten(param_specs(mesh, cfg, params),
                         is_leaf=lambda x: isinstance(x, P))[0]
    want = [local_shape(mesh, x.shape, sp)
            for x, sp in zip(tree_flatten(params)[0], specs)]
    shapes = [tuple(a.shape) for a in got]
    back = gather_params(held, mesh, cfg)
    same = all(torch.equal(a, b) for a, b in zip(tree_flatten(back)[0],
                                                 tree_flatten(params)[0]))
    return loss, whole_loss, worst, shapes, want, same


def _frames_layer_vs_whole(mesh, cfg, dtype):
    """The frame front end and one encoder layer of ``cfg`` split on
    ``mesh`` against the whole, in ``dtype`` (the layers' f32 casts made
    ``dtype``): the worst error of max-abs over the output and every
    gradient piece, and whether the frame projection was split."""
    from repro_torch.core.tree_utils import (tree_flatten, tree_map,
                                             tree_unflatten)
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch.train import model_axis_of
    from repro_torch.models import init_params, layers, model
    from repro_torch.models.model import shard_params
    from repro_torch.models.tp import split_on

    cfg = cfg.replace(n_layers=1)
    params = tree_map(lambda x: x.to(dtype), init_params(0, cfg,
                                                         device="cpu"))
    frames = next(make_batch_iterator(cfg, 2, 32, seed=3, device="cpu"))[
        "frames"].to(dtype)
    ct = torch.randn(2, 32, cfg.d_model, dtype=dtype,
                     generator=torch.Generator().manual_seed(4))
    axis = model_axis_of(mesh, cfg)
    split = bool(split_on(axis.held["frontend"], 1))

    def run(p, tp):
        leaves, treedef = tree_flatten(p)
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        tree = tree_unflatten(treedef, leaves)
        x = model._embed_inputs(tree, cfg, {"frames": frames},
                                tp if split else None)
        x, _, _ = model._run_stack(tree, cfg, x, positions=model._positions(
            2, 32, "cpu"), tp=tp)
        return [x.detach(), *torch.autograd.grad((x * ct).sum(), leaves,
                                                 allow_unused=True)]

    f32 = layers.F32
    layers.F32 = model.F32 = dtype
    try:
        whole = run(params, None)
        got = run(shard_params(params, mesh, cfg), axis)
    finally:
        layers.F32 = model.F32 = f32
    treedef = tree_flatten(params)[1]
    want = [whole[0], *tree_flatten(shard_params(tree_unflatten(
        treedef, [torch.zeros(()) if g is None else g for g in whole[1:]]),
        mesh, cfg), is_leaf=lambda x: x is None)[0]]
    worst = 0.0
    for a, b in zip(got, want):
        if a is not None:  # the final norm and the unembedding are unused
            worst = max(worst, float((a - b).abs().max() /
                                     b.abs().max().clamp(min=1e-300)))
    return worst, split


def _decode_layer_vs_whole(mesh, kind, fault=None):
    """The decode layer ``kind`` of ``DECODE_LAYERS`` on this rank's pieces
    and cache piece against the whole layer, in f64, under the planted
    ``fault`` (``test_torch_serve_split.fault``) or none: the worst error
    of max-abs over the steps' outputs and cache pieces."""
    from test_torch_serve_split import fault as planted

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tree_utils import tree_flatten, tree_map
    from repro_torch.launch.train import model_axis_of
    from repro_torch.models import init_cache, init_params, layers, model
    from repro_torch.models import ssm
    from repro_torch.models.model import shard_cache, shard_params

    arch, _ = DECODE_LAYERS[kind]
    cfg = get_smoke_config(arch).replace(
        n_layers=1, first_dense_layers=0, mtp_depth=0,
        mixer_pattern=(("ssm",) if kind == "ssm" else ("attn",)),
        mlp_pattern=("none",))
    f64 = torch.float64
    gen = torch.Generator().manual_seed(6)
    params = tree_map(lambda x: x.to(f64), init_params(0, cfg, device="cpu"))
    cache = tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                           dtype=f64),
                     init_cache(cfg, 2, DECODE_LEN, device="meta"))
    xs = torch.randn(len(DECODE_IDX), 2, 1, cfg.d_model, generator=gen,
                     dtype=f64)
    axis = model_axis_of(mesh, cfg)
    held = model._layer_held(axis.held["body"][0])["mixer"]
    pieces = shard_params(params, mesh, cfg)
    mine = shard_cache(tree_map(lambda x: x.clone(), cache), mesh, cfg)

    n = 2 // mesh.size(0)  # this rank's rows: the cache's over "data"
    rows = slice(mesh.get_local_rank("data") * n, (mesh.get_local_rank(
        "data") + 1) * n)

    def one(tree):  # the layer's mixer, its layer dimension dropped
        return tree_map(lambda x: x[0], tree["body"][0]["mixer"])

    def step(p, c, x, idx, tp):
        c = tree_map(lambda x: x[0], c["body"][0])
        pos = torch.full((x.shape[0], 1), idx)
        if kind == "ssm":
            return ssm.mamba2_decode_step(p, cfg, x, ssm.SSMState(*c), tp=tp,
                                          held=tp and held)
        fn = layers.mla_forward if kind == "mla" else layers.gqa_forward
        return fn(p, cfg, x, positions=pos, cache=c, cache_index=idx, tp=tp,
                  held=tp and held)

    f32 = layers.F32
    layers.F32 = model.F32 = ssm.F32 = f64
    worst = 0.0
    try:
        with torch.no_grad(), planted(fault):
            for x, idx in zip(xs, DECODE_IDX):
                want, _ = step(one(params), cache, x, idx, None)
                got, _ = step(one(pieces), mine, x[rows], idx, axis)
                errs = [(got, want[rows], want)] + [
                    (a, b, b) for a, b in zip(tree_flatten(mine)[0],
                                              tree_flatten(shard_cache(
                                                  cache, mesh, cfg))[0])
                    if a.numel()]
                for a, b, scale in errs:  # NaN reads as inf
                    worst = max(worst, float(torch.nan_to_num(
                        (a - b).abs().max() / scale.abs().max(),
                        nan=float("inf"))))
    finally:
        layers.F32 = model.F32 = ssm.F32 = f32
    return worst


def _tp_job(rank):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import model_axis_of
    from repro_torch.models import ModelConfig

    torch.set_num_threads(1)
    out = {}
    hubert = get_smoke_config("hubert_xlarge").replace(dtype="float32",
                                                       logit_chunk=8)
    for shape in MESHES:
        mesh = make_debug_mesh(*shape)
        if shape == (2, 2):
            out["gradcheck"] = _gradchecks(
                model_axis_of(mesh, ModelConfig(**TINY)))
        out[shape] = _split_vs_whole(mesh)
        for vocab in FRAMES_VOCABS:
            out[("frames", shape, vocab)] = _split_vs_whole(
                mesh, hubert.replace(vocab=vocab))
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            out[("frames-layer", shape, name)] = _frames_layer_vs_whole(
                mesh, hubert, dtype)
        for kind, (_, faults) in DECODE_LAYERS.items():
            for fault in (None, *faults):
                out[("decode", shape, kind, fault)] = _decode_layer_vs_whole(
                    mesh, kind, fault)
    return out


@pytest.fixture(scope="module")
def results():
    return spawn(_tp_job, 4, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", ["copy_reduce", "gather",
                                  "vocab_parallel_embed",
                                  "vocab_parallel_ce", "layer_from_owner"])
def test_function_gradcheck_against_plain_twin(results, name):
    for rank, out in enumerate(results):
        ok, err = out["gradcheck"][name]
        assert ok, (rank, name)
        assert err <= 1e-12, (rank, name, err)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_split_loss_and_gradient_pieces_match_whole(results, shape):
    for rank, out in enumerate(results):
        loss, whole_loss, worst, _, _, _ = out[shape]
        assert loss == pytest.approx(whole_loss, rel=LOSS_RTOL), rank
        assert worst <= GRAD_REL, (rank, worst)
    # every rank of the axis reports the same loss, bit for bit
    assert len({out[shape][0] for out in results}) == 1


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_held_pieces_have_param_specs_local_shapes(results, shape):
    for rank, out in enumerate(results):
        _, _, _, shapes, want, same = out[shape]
        assert shapes == want, rank
        assert same, rank


@pytest.mark.parametrize("vocab", FRAMES_VOCABS)
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_frames_split_matches_whole(results, shape, vocab):
    for rank, out in enumerate(results):
        loss, whole_loss, worst, shapes, want, same = out[("frames", shape,
                                                           vocab)]
        assert loss == pytest.approx(whole_loss, rel=LOSS_RTOL), rank
        assert worst <= FRAMES_REL["f32"], (rank, worst)
        assert shapes == want, rank
        assert same, rank
    assert len({out[("frames", shape, vocab)][0] for out in results}) == 1


@pytest.mark.parametrize("dtype", list(FRAMES_REL))
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_frames_layer_split_matches_whole(results, shape, dtype):
    for rank, out in enumerate(results):
        worst, split = out[("frames-layer", shape, dtype)]
        assert split, rank  # the frame projection column-split
        assert worst <= FRAMES_REL[dtype], (rank, worst)


@pytest.mark.parametrize("kind", list(DECODE_LAYERS))
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_decode_layer_split_matches_whole(results, shape, kind):
    for rank, out in enumerate(results):
        worst = out[("decode", shape, kind, None)]
        assert worst <= DECODE_REL, (rank, kind, worst)


@pytest.mark.parametrize("kind,fault", [
    (kind, fault) for kind, (_, faults) in DECODE_LAYERS.items()
    for fault in faults])
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_decode_layer_planted_fault_fails(results, shape, kind, fault):
    assert max(out[("decode", shape, kind, fault)]
               for out in results) > DECODE_REL


def test_model_split_names_the_dense_family():
    """Every family splits over "model" under "tp" and fsdp_tp, the audio
    encoder on frame inputs too; zero3 splits no model compute (its pass
    runs whole on the rank's rows, each layer gathered over "model")."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.registry import list_archs
    from repro_torch.sharding.rules import model_split

    dense = {"minitron_8b", "yi_34b", "stablelm_12b", "deepseek_7b",
             "arctic_480b", "deepseek_v3_671b", "mamba2_780m",
             "jamba_v01_52b", "llama32_vision_90b", "hubert_xlarge"}
    assert dense == set(list_archs())
    for arch in list_archs():
        assert model_split(get_config(arch)) == "tp", arch
        assert model_split(get_smoke_config(arch)) == "tp", arch
        assert model_split(get_config(arch), "zero3") == "zero3"
    assert np.all([model_split(get_config(a), "fsdp_tp") == "tp"
                   for a in dense])
