"""The port's model-zoo structure and substrates against the reference's:
configs and their registry, ``param_count`` (on "meta", nothing
allocated), ``input_specs`` and the decode variants, the params tree's
keys, shapes, dtypes and order, checkpoints of a params tree read across
the packages bit for bit, the optimisers, schedules, token stream,
synthetic batches, federated splits and the sharding rules.

Tolerances: counts, shapes, dtypes, keys, splits and specs exactly;
schedules exactly, as f32 values; an optimiser step on the
reference's values within rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro.checkpoint.checkpoint import _flatten_with_paths as r_paths
from repro.configs import registry as r_registry
from repro.configs import shapes as r_shapes
from repro.data import federated as r_fed
from repro.data import pipeline as r_pipe
from repro.models import model as r_model
from repro import optim as r_optim
from repro.sharding import constraints as r_cons
from repro_torch import checkpoint as t_ckpt
from repro_torch import configs as t_configs
from repro_torch import optim as t_optim
from repro_torch.checkpoint.checkpoint import _flatten_with_paths as t_paths
from repro_torch.configs import registry as t_registry
from repro_torch.configs import shapes as t_shapes
from repro_torch.core.tree_utils import tree_flatten
from repro_torch.data import federated as t_fed
from repro_torch.data import pipeline as t_pipe
from repro_torch.models import model as t_model
from repro_torch.sharding import constraints as t_cons

ARCHS = t_registry.list_archs()
_JNP_TO_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32, "bool": torch.bool}


def _torch_dtype(dtype):
    return _JNP_TO_TORCH[np.dtype(dtype).name]


def _fields(cfg):
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# configs, registry, param counts
# ---------------------------------------------------------------------------

def test_registry_lists_the_same_archs():
    assert ARCHS == r_registry.list_archs()
    assert t_configs.ARCHS == r_registry.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_smoke_configs_equal_the_references(arch):
    assert _fields(t_registry.get_config(arch)) == \
        _fields(r_registry.get_config(arch))
    assert _fields(t_registry.get_smoke_config(arch)) == \
        _fields(r_registry.get_smoke_config(arch))
    over = dict(dtype="float32", n_layers=t_registry.get_config(arch).period
                + t_registry.get_config(arch).first_dense_layers)
    assert _fields(t_registry.get_config(arch, **over)) == \
        _fields(r_registry.get_config(arch, **over))


def test_aliases_resolve_as_the_references():
    for alias in sorted(r_registry._ALIASES):
        assert t_registry._ALIASES[alias] == r_registry._ALIASES[alias]
        assert t_registry.get_config(alias).name == \
            r_registry.get_config(alias).name
    assert set(t_registry._ALIASES) == set(r_registry._ALIASES)
    assert t_registry.get_config("deepseek-v3-671b").name == "deepseek-v3-671b"
    assert t_registry.get_config("llama-3.2-vision-90b").n_layers == 100
    with pytest.raises(ValueError):
        t_registry.get_config("gpt-5")


def test_config_checks_as_the_reference():
    with pytest.raises(ValueError, match="share a period"):
        t_model.ModelConfig(name="x", n_layers=2, d_model=8, n_heads=2,
                            n_kv_heads=2, d_ff=8, vocab=8,
                            mixer_pattern=("attn", "ssm"))
    with pytest.raises(ValueError, match="not divisible"):
        t_model.ModelConfig(name="x", n_layers=3, d_model=8, n_heads=2,
                            n_kv_heads=2, d_ff=8, vocab=8,
                            mixer_pattern=("attn", "ssm"),
                            mlp_pattern=("dense", "none"))
    cfg = t_model.ModelConfig(name="x", n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=8, vocab=8)
    assert cfg.head_dim == 16 and cfg.period == 1 and cfg.n_periods == 2
    assert cfg.jdtype == torch.bfloat16
    assert cfg.replace(dtype="float32").jdtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_the_full_config_equals_the_references(arch):
    cfg = t_registry.get_config(arch)
    tree = t_model.init_params(0, cfg, device="meta")
    leaves, _ = tree_flatten(tree)
    assert all(leaf.device.type == "meta" for leaf in leaves)
    assert t_model.param_count(cfg) == \
        r_model.param_count(r_registry.get_config(arch))


def test_minitron_full_param_count():
    cfg = t_registry.get_config("minitron_8b")
    assert t_model.param_count(cfg) == 9_882_046_464
    assert t_model.param_count(cfg.replace(n_layers=2)) == 2_583_711_744


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def _spec_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", list(t_shapes.SHAPES))
def test_input_specs_are_the_references(arch, shape_name):
    tcfg = t_registry.get_smoke_config(arch)
    rcfg = r_registry.get_smoke_config(arch)
    shape, rshape = t_shapes.SHAPES[shape_name], r_shapes.SHAPES[shape_name]
    assert dataclasses.asdict(shape) == dataclasses.asdict(rshape)
    mode = t_shapes.mode_for(tcfg, shape)
    assert mode == r_shapes.mode_for(rcfg, rshape)
    assert _fields(t_shapes.decode_variant(tcfg, shape)) == \
        _fields(r_shapes.decode_variant(rcfg, rshape))
    if mode is None:
        assert arch == "hubert_xlarge" and shape.kind == "decode"
        return
    got = t_shapes.input_specs(tcfg, shape)
    want = r_shapes.input_specs(rcfg, rshape)
    got_leaves, _ = tree_flatten(got)
    want_leaves = _spec_leaves(want)
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == _torch_dtype(w.dtype)
    assert list(t_paths(got)) == list(r_paths(want))


def test_long_500k_cache_is_bounded():
    long = t_shapes.SHAPES["long_500k"]
    cfg = t_shapes.decode_variant(t_registry.get_config("minitron_8b"), long)
    assert cfg.sliding_window == t_shapes.LONG_CONTEXT_WINDOW
    cache = t_model.init_cache(cfg, 1, long.seq_len, device="meta")
    assert cache["body"][0]["k"].shape[2] == t_shapes.LONG_CONTEXT_WINDOW
    assert t_shapes.decode_variant(
        t_registry.get_config("mamba2_780m"), long).sliding_window == 0
    assert t_shapes.decode_variant(
        t_registry.get_config("yi_34b"), t_shapes.SHAPES["decode_32k"]
    ).sliding_window == 0
    assert t_shapes.shape_for("train_4k") is t_shapes.SHAPES["train_4k"]
    with pytest.raises(ValueError):
        t_shapes.shape_for("train_8k")


# ---------------------------------------------------------------------------
# params trees and checkpoints across the packages
# ---------------------------------------------------------------------------

def _ref_params(arch, **kw):
    cfg = r_registry.get_smoke_config(arch, **kw)
    return cfg, jax.jit(lambda k: r_model.init_params(k, cfg))(
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_has_the_references_keys_shapes_dtypes_and_order(arch):
    cfg = r_registry.get_smoke_config(arch)
    ref = jax.eval_shape(lambda k: r_model.init_params(k, cfg),
                         jax.random.PRNGKey(0))
    port = t_model.init_params(7, t_registry.get_smoke_config(arch),
                               device="cpu")
    ref_paths = r_paths(ref)
    port_paths = t_paths(port)
    assert list(port_paths) == list(ref_paths)
    leaves, _ = tree_flatten(port)
    ref_leaves = [leaf for _, leaf in
                  jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert len(leaves) == len(ref_leaves)
    for (path, t), r in zip(port_paths.items(), ref_leaves):
        assert tuple(t.shape) == tuple(r.shape), path
        assert t.dtype == _torch_dtype(r.dtype), path
    assert isinstance(port["body"], tuple)


def _bits(x):
    x = np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("arch", ["minitron_8b", "jamba_v01_52b",
                                  "deepseek_v3_671b"])
def test_checkpoint_of_a_params_tree_reads_across_bit_for_bit(arch, tmp_path):
    """bf16 weights (and the SSM's f32 leaves, MoE's f32 router): a port
    save restores into the reference's template, and a reference save
    into the port's, every leaf's bits equal."""
    rcfg, ref = _ref_params(arch)
    port = t_model.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                     device="cpu")
    port_template = t_model.init_params(1, t_registry.get_smoke_config(arch),
                                        device="cpu")
    ref_template = jax.tree_util.tree_map(jnp.zeros_like, ref)
    t_ckpt.save(str(tmp_path / "port"), 3, port)
    back_ref = r_ckpt.restore(str(tmp_path / "port"), 3, ref_template)
    r_ckpt.save(str(tmp_path / "ref"), 4, ref)
    back_port = t_ckpt.restore(str(tmp_path / "ref"), 4, port_template)
    want = jax.tree_util.tree_leaves(ref)
    got_ref = jax.tree_util.tree_leaves(back_ref)
    got_port = t_model.params_to_numpy(back_port)
    got_port = jax.tree_util.tree_leaves(got_port)
    assert len(got_ref) == len(got_port) == len(want)
    for w, a, b in zip(want, got_ref, got_port):
        assert a.dtype == w.dtype and b.dtype == w.dtype
        np.testing.assert_array_equal(_bits(a), _bits(w))
        np.testing.assert_array_equal(_bits(b), _bits(w))


def test_params_numpy_round_trip_keeps_bits_and_structure():
    _, ref = _ref_params("jamba_v01_52b")
    np_tree = jax.tree_util.tree_map(np.asarray, ref)
    port = t_model.params_from_numpy(np_tree, device="cpu")
    back = t_model.params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(np_tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # a tensor that crossed is the port's own copy, not the reference's buffer
    leaf = port["final_norm"]["scale"]
    leaf += 1
    assert np.all(np.asarray(ref["final_norm"]["scale"], np.float32) == 1.0)


def test_entry_points_run_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = t_registry.get_smoke_config("minitron_8b")
    from repro_torch.models import ssm as t_ssm

    for call in (lambda: t_model.init_params(0, cfg),
                 lambda: t_model.init_cache(cfg, 1, 4),
                 lambda: t_ssm.init_ssm_state(
                     t_registry.get_smoke_config("mamba2_780m"), 1),
                 lambda: t_model.params_from_numpy({"w": np.zeros(2)}),
                 lambda: t_pipe.synthetic_batch(0, cfg, 1, 4),
                 lambda: next(t_pipe.make_batch_iterator(cfg, 1, 4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# optimisers and schedules
# ---------------------------------------------------------------------------

_OPTS = [("sgd", {}), ("momentum", {"beta": 0.9}),
         ("momentum", {"beta": 0.9, "nesterov": True}),
         ("adamw", {}), ("adamw", {"weight_decay": 0.1})]


@pytest.mark.parametrize("name,kw", _OPTS, ids=lambda v: str(v))
def test_optimizer_reduces_the_quadratic_as_the_reference(name, kw):
    """100 steps on sum(w^2): the port's loss falls below 1e-2 (the
    reference test's bar) and every iterate equals the reference's
    optimiser on the same gradients within rtol 1e-6."""
    t_opt, r_opt = getattr(t_optim, name)(**kw), getattr(r_optim, name)(**kw)
    w0 = np.array([3.0, -2.0, 1.0], np.float32)
    tp, rp = {"w": torch.from_numpy(w0.copy())}, {"w": jnp.asarray(w0)}
    ts, rs = t_opt.init(tp), r_opt.init(rp)
    for _ in range(100):
        leaf = tp["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(leaf ** 2), [leaf])
        tp, ts = t_opt.apply(tp, {"w": g}, ts, 0.05)
        rg = jax.grad(lambda p: jnp.sum(p["w"] ** 2))(rp)
        rp, rs = r_opt.apply(rp, rg, rs, 0.05)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(rp["w"]),
                                   rtol=1e-6, atol=1e-7)
    assert float(torch.sum(tp["w"] ** 2)) < 1e-2
    assert not tp["w"].requires_grad


def test_optimizer_keeps_bf16_params_and_f32_state():
    params = {"a": torch.ones(4, dtype=torch.bfloat16), "b": (torch.ones(2),)}
    grads = {"a": torch.full((4,), 0.5, dtype=torch.bfloat16),
             "b": (torch.full((2,), 0.5),)}
    opt = t_optim.adamw()
    state = opt.init(params)
    assert state.mu["a"].dtype == torch.float32
    new, state = opt.apply(params, grads, state, 0.1)
    assert new["a"].dtype == torch.bfloat16 and isinstance(new["b"], tuple)
    assert int(state.count) == 1


def _same_f32(got, want):
    assert float(got) == float(want)


def test_schedules_equal_the_references_at_every_step():
    pairs = [(t_optim.constant(0.1), r_optim.constant(0.1)),
             (t_optim.cosine_decay(1.0, 100, final_frac=0.1),
              r_optim.cosine_decay(1.0, 100, final_frac=0.1)),
             (t_optim.warmup_cosine(1.0, warmup=10, total_steps=110),
              r_optim.warmup_cosine(1.0, warmup=10, total_steps=110)),
             (t_optim.warmup_cosine(3e-4, warmup=7, total_steps=50,
                                    final_frac=0.0),
              r_optim.warmup_cosine(3e-4, warmup=7, total_steps=50,
                                    final_frac=0.0))]
    for t_fn, r_fn in pairs:
        for step in range(0, 130):
            got = t_fn(step)
            assert got.dtype == torch.float32
            _same_f32(got, r_fn(step))
    wc = t_optim.warmup_cosine(1.0, warmup=10, total_steps=110)
    assert float(wc(0)) == 0.0 and float(wc(10)) == 1.0
    assert float(wc(5)) == pytest.approx(0.5)
    _same_f32(t_optim.cosine_decay(1.0, 100)(torch.tensor(37)),
              r_optim.cosine_decay(1.0, 100)(37))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _tiny_cfg(**kw):
    base = dict(name="t", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                d_ff=128, vocab=100)
    base.update(kw)
    return t_model.ModelConfig(**base), r_model.ModelConfig(**base)


def test_token_stream_deterministic_and_sharded():
    """Two streams of one seed give the same steps; steps differ from one
    another, and so do the shards of one step."""
    cfg, _ = _tiny_cfg()

    def steps(n, **kw):
        it = iter(t_pipe.TokenStream(cfg, batch=2, seq=8, seed=3,
                                     device="cpu", **kw))
        return [next(it)["tokens"] for _ in range(n)]

    first, again = steps(2), steps(2)
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(first[0], first[1])
    shards = [steps(1, shard_id=s, num_shards=4)[0] for s in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(shards[i], shards[j])
    assert not torch.equal(first[0], shards[1])
    assert int(first[0].max()) < 100 and int(first[0].min()) >= 0
    assert first[0].dtype == torch.int32
    it = t_pipe.make_batch_iterator(cfg, 2, 8, seed=3, device="cpu")
    torch.testing.assert_close(next(it)["tokens"], first[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["tokens", "frames", "tokens+vision"])
def test_synthetic_batch_kinds_match_the_references(kind):
    cfg, rcfg = _tiny_cfg(vocab=50, input_kind=kind, frame_dim=16,
                          n_vision_tokens=5)
    got = t_pipe.synthetic_batch(0, cfg, 2, 8, device="cpu")
    want = r_pipe.synthetic_batch(jax.random.PRNGKey(0), rcfg, 2, 8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == _torch_dtype(want[k].dtype), k
    if kind == "frames":
        assert 0 <= int(got["targets"].min()) and int(got["targets"].max()) < 50
        assert 0.3 < float(got["mask"].float().mean()) < 0.95
    g = torch.Generator().manual_seed(0)
    again = t_pipe.synthetic_batch(g, cfg, 2, 8)
    for k in got:
        torch.testing.assert_close(again[k], got[k], rtol=0, atol=0)


def test_federated_splits_equal_the_references():
    rng = np.random.RandomState(0)
    f = rng.randn(103, 7).astype(np.float32)
    l = (rng.rand(103) > 0.5).astype(np.float32)
    for a, b in zip(t_fed.federated_shards(f, l, 10),
                    r_fed.federated_shards(f, l, 10)):
        np.testing.assert_array_equal(a, b)
    assert t_fed.federated_shards(f, l, 10)[0].shape == (10, 10, 7)
    f = rng.randn(1000, 3).astype(np.float32)
    l = rng.randint(0, 10, 1000)
    fs, ls = t_fed.dirichlet_split(f, l, n_clients=10, alpha=0.1, seed=0)
    rfs, rls = r_fed.dirichlet_split(f, l, n_clients=10, alpha=0.1, seed=0)
    np.testing.assert_array_equal(fs, rfs)
    np.testing.assert_array_equal(ls, rls)
    hists = np.stack([np.bincount(ls[i].astype(int), minlength=10)
                      for i in range(10)])
    assert fs.shape == (10, 100, 3) and hists.std(axis=0).mean() > 2.0


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _ref_mesh(sizes, names):
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:  # jax < 0.5: AbstractMesh takes ((name, size), ...)
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


_LOGICAL = [
    (("data", None, "heads", None), (32, 4096, 32, 128)),
    (("data", None, "kv", None), (32, 4096, 8, 128)),
    (("data", None, "kv", None), (32, 4096, 4, 128)),
    (("data", None, "model"), (8, 4096, 16384)),
    (("data", None, "model"), (3, 4096, 16384)),
    (("expert", None, None), (16, 64, 4096)),
    (("expert", None, None), (6, 64, 4096)),
    (("data", None, None), (64, 10, 10)),
    (("model", "data"), (32, 32)),
    ((None, None), (7, 7)),
]


@pytest.mark.parametrize("sizes,names", [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((4, 4), ("data", "model")),
    ((8,), ("data",)),
], ids=str)
@pytest.mark.parametrize("ctx", ["plain", "override_model", "override_pod",
                                 "suspend_all", "suspend_pod"])
def test_logical_to_spec_equals_the_references(sizes, names, ctx):
    rmesh = _ref_mesh(sizes, names)
    tmesh = t_cons.AbstractMesh(sizes, names)

    def within(mod):
        return {"plain": lambda: _Null(),
                "override_model": lambda: mod.override_data_axes(("model",)),
                "override_pod": lambda: mod.override_data_axes(("pod", "data")),
                "suspend_all": lambda: mod.suspend_data_axis(),
                "suspend_pod": lambda: mod.suspend_data_axis(("pod",)),
                }[ctx]()

    for axes, shape in _LOGICAL:
        with within(r_cons):
            want = tuple(r_cons.logical_to_spec(rmesh, axes, shape))
        with within(t_cons):
            got = tuple(t_cons.logical_to_spec(tmesh, axes, shape))
        want = want + (None,) * (len(axes) - len(want))  # P drops no entry
        assert got == want, (axes, shape)
    for name in ("pod", "data", "model", "other"):
        assert t_cons.axis_size(tmesh, name) == r_cons.axis_size(rmesh, name)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_context_managers_nest_and_restore():
    mesh = t_cons.AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    spec = lambda: t_cons.logical_to_spec(mesh, ("data",), (64,))  # noqa: E731
    assert tuple(spec()) == (("pod", "data"),)
    with t_cons.suspend_data_axis(("pod",)):
        assert tuple(spec()) == ("data",)
        with t_cons.override_data_axes(("model",)):
            assert tuple(spec()) == ("model",)
        assert tuple(spec()) == ("data",)
    assert tuple(spec()) == (("pod", "data"),)
    with pytest.raises(ValueError):
        t_cons.logical_to_spec(mesh, ("rows",), (4,))


def test_maybe_constrain_returns_its_input():
    x = torch.ones(2, 3)
    assert t_cons.maybe_constrain(x, "data", None) is x
