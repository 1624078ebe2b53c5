"""The tensor-parallel split of the MoE and MLA decoders
(``repro_torch.models.moe``, ``models.layers._mla_split``, the dense
prefix and the MTP head of ``models.model``) on gloo ranks of the CPU.

One spawn of 4 ranks does all the work, in a module-scoped fixture, on
the 2-rank "model" groups of a (2, 2) mesh and on a (1, 4) mesh:

* ``torch.autograd.gradcheck`` in f64 of the new autograd Functions
  (``tp.gather_replicated``; the experts' grouped SwiGLU ``moe.
  _ExpertFFN``, with groups of 2 over 3 experts) and of the split MoE
  layer as a gradient of the whole computation, each against its plain
  whole twin (over the 2-rank groups; every rank perturbs the same entry
  of the replicated inputs in lockstep, the pieces cut through
  ``copy_to_model``, as ``tests/test_torch_tp.py`` does).  MLA, the
  shared expert and the dense residual compute in f32 whatever their
  operands, so they are held in f32 below;
* one MoE layer (``models.model._apply_layer``: attention, then the MoE
  MLP) split against the whole layer in f32: the output and the
  gradients of x, the router, the expert pieces, the shared expert and
  Arctic's dense residual, within ``LAYER_REL`` of max-abs; E = 4 and 8,
  E = 6 on 4 ranks (ragged: ``param_specs`` leaves the stacks whole and
  each rank narrows its ``split_range``), E = 2 on 4 ranks (two ranks
  hold no expert and add a zero partial), a capacity factor of 0.5 that
  drops choices, and MLA with 2 and 1 heads a rank (H = 4) and with 3 and
  1.5 (H = 6, whose heads straddle the ranks);
* arctic-480b's and deepseek-v3-671b's smoke configs in f32 (remat on, a
  logit chunk of 8) split against the whole model, as TINY is in
  ``tests/test_torch_tp.py`` (its ``_split_vs_whole``): the loss and
  every gradient piece, the pieces' ``param_specs`` shapes and
  ``gather_params`` back bit for bit; v3 runs its dense prefix, MLA and
  the MTP head split.

In the test process: the grouped experts' SwiGLU against the whole
stacks' in f32 and bf16, a routing recorded and pinned
(``moe.record_routing``), one full-width deepseek-v3 MoE layer's f32
transient on "meta" tensors, and the chunked attention's recomputed
backward pass.
"""
import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_tp import LOSS_RTOL, _split_vs_whole

MESHES = ((2, 2), (1, 4))
MESH_IDS = ["2x2", "1x4"]
# f32, the layer's output and gradients against the whole layer, of each
# tensor's max-abs: the split sums the experts' and the row-split
# products in another order
LAYER_REL = 1e-6
BASE = dict(name="moe-layer", n_layers=1, d_model=32, n_heads=4,
            n_kv_heads=2, head_dim=8, d_ff=16, vocab=64,
            mixer_pattern=("attn",), mlp_pattern=("moe",),
            experts_per_token=2, dtype="float32")
MLA = dict(attn_kind="mla", n_kv_heads=4, q_lora_rank=24, kv_lora_rank=16,
           qk_rope_dim=8)
LAYER_CASES = {
    "e4-shared-dense": dict(n_experts=4, n_shared_experts=1,
                            moe_dense_residual=True),
    "e8": dict(n_experts=8, n_shared_experts=1),
    "e6-ragged": dict(n_experts=6, moe_dense_residual=True),
    "e2-empty": dict(n_experts=2, n_shared_experts=1,
                     moe_dense_residual=True),
    "e4-drops": dict(n_experts=4, n_shared_experts=1, capacity_factor=0.5),
    "mla-h4": dict(n_experts=4, n_shared_experts=1, **MLA),
    "mla-h6": dict(n_experts=4, **dict(MLA, n_heads=6, n_kv_heads=6)),
}
MODELS = ("arctic_480b", "deepseek_v3_671b")
# f32, the smoke models' gradient pieces against the whole model's, of
# each leaf's max-abs: deeper than TINY (MLA's norms of gathered latents,
# the experts' partial combines, the MTP head), they read 2.8e-6 at
# worst; a leaf counted twice or left out reads O(1)
MODEL_REL = 1e-5
SPAWN_TIMEOUT = 300


def _axis(mesh, held):
    from repro_torch.launch.mesh import axis_size, model_group
    from repro_torch.sharding.constraints import ModelAxis

    return ModelAxis(model_group(mesh), mesh.get_local_rank("model"),
                     axis_size(mesh, "model"), held)


def _pieces(axis, tree, held):
    """Each leaf of the replicated ``tree`` cut to this rank's piece under
    ``held`` through ``copy_to_model`` (so that its gradient is the whole
    leaf's, summed over the ranks), the whole leaves as they are."""
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
                leaf = tp.copy_to_model(leaf, axis).narrow(j, axis.rank * k,
                                                           k)
        out.append(leaf)
    return tree_unflatten(treedef, out)


def _gradchecks(mesh):
    """{name: (gradcheck passed, max |split - plain|)} in f64."""
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.models import ModelConfig, moe, tp
    from repro_torch.models.layers import Draw
    from repro_torch.sharding.rules import held_specs

    gen = torch.Generator().manual_seed(7)
    f64 = dict(dtype=torch.float64)
    out = {}

    def check(name, fn, plain, *inputs):
        inputs = [x.detach().requires_grad_(x.is_floating_point())
                  for x in inputs]
        ok = torch.autograd.gradcheck(
            fn, inputs, eps=1e-6, atol=1e-8, rtol=1e-6)
        with torch.no_grad():
            got, want = fn(*inputs), plain(*inputs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        out[name] = (bool(ok), max(float((a - b).abs().max())
                                   for a, b in zip(got, want)))

    axis = _axis(mesh, None)
    r, m = axis.rank, axis.size
    w = torch.randn(3, 4 * m, generator=gen, **f64)
    check("gather_replicated",
          lambda w: torch.sin(tp.gather_replicated(
              tp.copy_to_model(w, axis).narrow(1, 4 * r, 4), axis, 1)),
          lambda w: torch.sin(tp.gather_from_model_plain(w.split(4, dim=1),
                                                         1)), w)

    # the grouped SwiGLU: 3 experts in groups of 2, 2 slots each, and the
    # trash row, against the experts' SwiGLU at once
    n, cap, D, F = 3, 2, 4, 3
    buf = torch.randn(n * cap + 1, D, generator=gen, **f64)
    ws = [torch.randn(n, D, F, generator=gen, **f64),
          torch.randn(n, D, F, generator=gen, **f64),
          torch.randn(n, F, D, generator=gen, **f64)]

    def grouped(b, wg, wu, wd):
        return moe._ExpertFFN.apply(b, wg, wu, wd, cap, 2)

    def at_once(b, wg, wu, wd):
        y = moe._ffn(b[:-1].view(n, cap, D), wg, wu, wd).flatten(0, 1)
        return torch.cat([y, torch.zeros_like(b[-1:])])

    check("expert_ffn_grouped", grouped, at_once, buf, *ws)

    # the split MoE layer (the experts, the gates, the aux losses) as a
    # gradient of the whole, against the whole layer: a gradient counted
    # on every rank (the routing's) would be 2x here
    cfg = ModelConfig(**dict(BASE, d_model=8, d_ff=3, n_experts=4,
                             dtype="float64"))
    params = moe.init_moe(Draw.from_seed(1, "cpu"), cfg, torch.float64)
    held = held_specs(mesh, cfg, params)
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.double() for leaf in leaves]  # the router is made f32

    def split(x, *ls):
        tree = _pieces(axis, tree_unflatten(treedef, list(ls)), held)
        return tuple(moe.moe_forward(tree, cfg, x, tp=axis, held=held))

    def whole(x, *ls):
        return tuple(moe.moe_forward(tree_unflatten(treedef, list(ls)), cfg,
                                     x))

    x = torch.randn(1, 6, 8, generator=gen, **f64)
    check("moe_split", split, whole, x, *leaves)
    return out


def _layer_vs_whole(mesh, case):
    """One MoE layer split against the whole: (worst error of max-abs over
    the output and every gradient, the worst tensor's name, the choices
    dropped in the split run, the number of experts this rank ran)."""
    from repro_torch.api.mesh_exec import _local_piece
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import ModelConfig, moe
    from repro_torch.models.layers import Draw
    from repro_torch.models.model import _apply_layer, _init_layer
    from repro_torch.models.tp import split_range
    from repro_torch.sharding.rules import held_specs

    cfg = ModelConfig(**dict(BASE, **LAYER_CASES[case]))
    layer = _init_layer(Draw.from_seed(3, "cpu"), cfg, "attn", "moe")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 12, cfg.d_model, generator=gen)
    ct = torch.randn(2, 12, cfg.d_model, generator=gen)
    pos = torch.arange(12)[None].expand(2, 12)
    held = held_specs(mesh, cfg, layer)
    specs = tree_flatten(held, is_leaf=lambda s: isinstance(s, P))[0]
    names = [".".join(map(str, k)) for k in _paths(layer)]

    def run(params, tp):
        leaves, treedef = tree_flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        xx = x.detach().requires_grad_(True)
        out, _, (lb, zl) = _apply_layer(
            tree_unflatten(treedef, leaves), cfg, "attn", "moe", xx,
            positions=pos, tp=tp, held=held if tp else None)
        loss = (out * ct).sum() + lb + zl
        grads = torch.autograd.grad(loss, [xx, *leaves])
        return [out.detach(), *grads]

    whole = run(layer, None)
    pieces = tree_unflatten(tree_flatten(layer)[1], [
        _local_piece(w, sp, mesh) if any(sp) else w
        for w, sp in zip(tree_flatten(layer)[0], specs)])
    with moe.count_drops() as drops:
        got = run(pieces, _axis(mesh, held))
    want = whole[:2] + [_local_piece(g, sp, mesh) if any(sp) else g
                        for g, sp in zip(whole[2:], specs)]
    worst, where = 0.0, ""
    for name, a, b in zip(["out", "x", *names], got, want):
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if err >= worst:
            worst, where = err, name
    lo, hi = split_range(cfg.n_experts, _axis(mesh, held))
    return worst, where, int(drops[0]), hi - lo


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix


def _job(rank):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    out = {}
    for shape in MESHES:
        mesh = make_debug_mesh(*shape)
        if shape == (2, 2):
            out["gradcheck"] = _gradchecks(mesh)
        for case in LAYER_CASES:
            out[(shape, case)] = _layer_vs_whole(mesh, case)
        for arch in MODELS:
            cfg = get_smoke_config(arch).replace(dtype="float32",
                                                 logit_chunk=8)
            out[(shape, arch)] = _split_vs_whole(mesh, cfg)
    return out


@pytest.fixture(scope="module")
def results():
    return spawn(_job, 4, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", ["gather_replicated", "expert_ffn_grouped",
                                  "moe_split"])
def test_function_gradcheck_against_plain_twin(results, name):
    for rank, out in enumerate(results):
        ok, err = out["gradcheck"][name]
        assert ok, (rank, name)
        assert err <= 1e-12, (rank, name, err)


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_moe_layer_split_matches_whole(results, shape, case):
    for rank, out in enumerate(results):
        worst, where, drops, n = out[(shape, case)]
        assert worst <= LAYER_REL, (rank, where, worst)
        if case == "e4-drops":  # the drop path ran
            assert drops > 0, rank
    if (shape, case) == ((1, 4), "e2-empty"):  # ranks 0 and 2 hold none
        assert [out[(shape, case)][3] for out in results] == [0, 1, 0, 1]


@pytest.mark.parametrize("arch", MODELS)
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_smoke_model_split_matches_whole(results, shape, arch):
    for rank, out in enumerate(results):
        loss, whole_loss, worst, shapes, want, same = out[(shape, arch)]
        assert loss == pytest.approx(whole_loss, rel=LOSS_RTOL), rank
        assert worst <= MODEL_REL, (rank, worst)
        assert shapes == want, rank
        assert same, rank
    assert len({out[(shape, arch)][0] for out in results}) == 1


def test_expert_groups_bound_the_f32_copies():
    """The grouped form against the whole-stack form on one process, in
    f32 and bf16: the output and the gradients of the buffer and the
    weights, bit for bit in f32 and within 1e-2 of max-abs in bf16 (the
    same products per expert, batched over another number of experts);
    and the groups' sizes."""
    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(9)
    n, cap, D, F = 5, 3, 16, 8
    for dtype, rel in ((torch.float32, 0.0), (torch.bfloat16, 1e-2)):
        buf = torch.randn(n * cap + 1, D, generator=gen).to(dtype)
        ws = [torch.randn(n, D, F, generator=gen).to(dtype),
              torch.randn(n, D, F, generator=gen).to(dtype),
              torch.randn(n, F, D, generator=gen).to(dtype)]
        ct = torch.randn(n * cap + 1, D, generator=gen).to(dtype)

        def grads(fn):
            ins = [t.detach().requires_grad_(True) for t in (buf, *ws)]
            y = fn(*ins)
            return [y.detach(), *torch.autograd.grad(y, ins, ct)]

        grouped = grads(lambda b, *w: moe._ExpertFFN.apply(b, *w, cap, 2))
        at_once = grads(lambda b, *w: torch.cat([moe._ffn(
            b[:-1].view(n, cap, D), *w).flatten(0, 1), b[-1:] * 0]))
        for a, b in zip(grouped, at_once):
            err = float((a.float() - b.float()).abs().max()
                        / b.float().abs().max())
            assert err <= rel, (dtype, err)
    assert moe._groups(5, 2) == [(0, 2), (2, 4), (4, 5)]


def test_pinned_routing_replays_a_recorded_one():
    """``moe.record_routing``: a pass records its (T, K) expert ids; a
    pass pinned to them gives the unpinned pass's output and gradients
    (of x and the router) bit for bit, the gates being the same
    probabilities; a pass pinned to other ids routes by them; a pin of
    another shape raises."""
    from repro_torch.models import ModelConfig, moe
    from repro_torch.models.layers import Draw

    cfg = ModelConfig(**dict(BASE, n_experts=4, n_shared_experts=1))
    params = moe.init_moe(Draw.from_seed(5, "cpu"), cfg, torch.float32)
    x = torch.randn(2, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))

    def run(pin=None):
        router = params["router"].detach().requires_grad_(True)
        xx = x.detach().requires_grad_(True)
        with moe.record_routing(pin) as seen:
            mo = moe.moe_forward(dict(params, router=router), cfg, xx)
        grads = torch.autograd.grad(mo.out.sum() + mo.lb_loss + mo.z_loss,
                                    [xx, router])
        return seen, [mo.out.detach(), *grads]

    seen, own = run()
    assert len(seen) == 1 and tuple(seen[0].shape) == (12, 2)
    again, pinned = run(seen[0])
    assert torch.equal(again[0], seen[0])
    for a, b in zip(pinned, own):
        assert torch.equal(a, b)
    other = (seen[0] + 1) % cfg.n_experts
    moved, changed = run(other)
    assert torch.equal(moved[0], other)
    assert not torch.allclose(changed[0], own[0])
    with pytest.raises(ValueError):
        run(seen[0][:, :1])


def test_full_width_moe_layer_f32_transient_is_bounded():
    """One deepseek-v3-671b MoE layer at full width (256 experts of 7,168
    x 2,048, top-8, one shared expert) in bf16, its forward and backward
    pass at 4,096 tokens on "meta" tensors: the peak of the bytes the pass
    allocates (the dry run's tally, with the views of the weights and of
    x not counted as new) stays under 5 GB above its gradients (the
    weights exist before it).  The f32 copies of the whole stacks alone
    would take 45.1 GB (42.4 GB above the gradients measured so)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _traced
    from repro_torch.models import moe
    from repro_torch.models.layers import Draw

    cfg = get_config("deepseek_v3_671b")
    params = moe.init_moe(Draw.from_seed(0, "meta"), cfg, torch.bfloat16)
    x = torch.empty(1, 4096, cfg.d_model, dtype=torch.bfloat16,
                    device="meta")
    leaves = [params[k] for k in ("router", "w_gate", "w_up", "w_down")]
    leaves += list(params["shared"].values())
    for t in (*leaves, x):
        t.requires_grad_(True)

    def fwd_bwd():
        mo = moe.moe_forward(params, cfg, x,
                             capacity_factor=cfg.capacity_factor)
        return torch.autograd.grad(
            mo.out.float().sum() + mo.lb_loss + mo.z_loss, [*leaves, x])

    # the weights and x exist before the pass: not allocated by it
    grads, _, peak = _traced(fwd_bwd, (leaves, x))
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    assert grad_bytes > 22e9
    assert peak - grad_bytes < 5e9, (peak, grad_bytes)


def test_chunked_attention_recomputes_each_chunk_in_backward(monkeypatch):
    """Where the scores its backward pass would keep exceed
    ``_KEEP_SCORES_BYTES``, the chunked attention recomputes each chunk's
    scores there (``torch.utils.checkpoint``), so that it keeps O(chunk)
    of them: its gradients equal those of the same loop with every
    chunk's scores kept, bit for bit, and those of one pass over every key
    within 2e-6 of max-abs (f32, the log-sum-exp merge sums in another
    order)."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(11)
    q = torch.randn(2, 32, 4, 8, generator=gen)
    k = torch.randn(2, 32, 2, 8, generator=gen)
    v = torch.randn(2, 32, 2, 8, generator=gen)
    ct = torch.randn(2, 32, 4, 8, generator=gen)
    calls = []

    def counted(fn, *a, **kw):
        calls.append(fn)
        return torch.utils.checkpoint.checkpoint(fn, *a, **kw)

    def grads(chunk, keep):
        monkeypatch.setattr(layers, "_KEEP_SCORES_BYTES", keep)
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = layers.attention(*ins, causal=True, chunk=chunk)
        return [out.detach(), *torch.autograd.grad(out, ins, ct)]

    monkeypatch.setattr(layers, "checkpoint", counted)
    kept = grads(8, 1 << 40)
    assert not calls
    recomputed = grads(8, 0)
    assert len(calls) == 4  # one checkpoint a chunk
    one_pass = grads(64, 0)
    for a, b, c in zip(recomputed, kept, one_pass):
        assert torch.equal(a, b)
        assert float((a - c).abs().max() / c.abs().max()) <= 2e-6
