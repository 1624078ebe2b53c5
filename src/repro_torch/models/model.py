"""Unified model assembly for all 10 architectures, the counterpart of
``repro.models.model``.

A model is described by a ``ModelConfig``: a *period* of layer specs
(mixer/mlp kind per position) cycled over the depth, plus embedding /
modality-frontend configuration.  Parameters are stored **stacked over
periods**, as in the reference: ``params["body"]`` is a tuple with one
dict a period position whose leaves have a leading ``n_periods`` axis,
and ``params["prefix"]`` is stacked too.  The forward pass is a Python
loop over periods that takes each period's slices of the stacked leaves,
under ``torch.utils.checkpoint`` where the reference applies
``jax.checkpoint``.

Entry points:
  init_params(seed, cfg, device=None)        -> params tree (on the card by default)
  param_count(cfg)                           -> int, on "meta": nothing allocated
  apply_train(params, cfg, batch)            -> (loss, aux) for the train_4k shape
  apply_prefill(params, cfg, batch)          -> last-position logits (prefill_32k)
  init_cache(cfg, batch, cache_len, device, mesh=None)
                                             -> decode cache tree (with a mesh: this rank's pieces)
  apply_decode(params, cfg, batch, cache, i) -> (logits, cache)  (decode; cache updated in place)
  params_from_numpy(tree, device)            -> the reference's weights as a params tree
  params_to_numpy(tree)                      -> and back
  cache_from_numpy(tree, cfg, device)        -> the reference's decode cache as a cache tree
  cache_to_numpy(tree)                       -> and back
  shard_params(params, mesh, cfg, mode)      -> this rank's held pieces of whole params
  gather_params(pieces, mesh, cfg, mode)     -> and the whole tree back
  shard_cache(cache, mesh, cfg)              -> this rank's cache_specs pieces of a whole cache
  gather_cache(pieces, mesh, cfg, batch, cache_len)
                                             -> and the whole cache back

Inside a ``sharding.constraints.model_axis`` block on a "model" axis of
more than one rank, ``apply_train`` runs the tensor-parallel split
(``models.tp``; ``sharding.rules.model_split``) on this rank's pieces
(``shard_params``): the embedding and unembedding split on the
vocabulary, frame inputs' ``frontend`` column-split and gathered back to
the whole residual, the attention heads (GQA, MLA or the cross-attention
to the vision tokens), the Mamba-2 mixer's heads and the MLP's hidden
dimension column- then row-split, the MoE layer's experts split over the
axis, the dense prefix and the MTP head split alike.  It reads the axis
once and hands it to every layer, so that a layer recomputed under
``torch.utils.checkpoint`` splits as its forward pass did.  Where the
pieces are split over another axis too (``ModelAxis.data``: "data" under
fsdp_tp; under zero3, whose pass is not split otherwise, "model"
itself), each layer's leaves are gathered over it at the start of its
step in the period loop (``tp.gather_from_data``), so that under remat
they are gathered again in the recompute; the leaves outside the loop
once a step, where ``apply_train`` uses them.  With the worker's rows
split over that axis, the cross-entropy's sums over rows (and the MoE
routing's, ``models.moe.route``) add up the axis's ranks, so that every
rank's loss is the worker's.

``apply_prefill`` and ``apply_decode`` split alike inside such a block,
forward only (``launch.serve.make_prefill_step`` / ``make_serve_step``
enter it): this rank's rows of the batch, the last position's logits
through the vocabulary-split unembedding, gathered whole over the
vocabulary.  A decode step holds this rank's ``cache_specs`` pieces of
the cache (``init_cache(..., mesh=)``, ``shard_cache``): the attention
caches' and the MLA latents' length split over "model" (``models.layers``
writes and attends on its block), the SSM state's heads split over it
(``models.ssm``), the rows over "data" where it divides them.

Gradients are taken with ``torch.autograd.grad`` over the tree's leaves.
Modality stubs: hubert consumes precomputed frame embeddings, the VLM
consumes precomputed projected vision tokens.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.core.tree_utils import tree_flatten, tree_map, tree_unflatten
from repro_torch.launch.mesh import P
from repro_torch.sharding.constraints import current_model_axis, maybe_constrain
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import tp as tp_mod
from .layers import (
    F32,
    Draw,
    cross_attn_forward,
    dense_init,
    gqa_forward,
    init_cross_attn,
    init_gqa,
    init_mla,
    init_rmsnorm,
    init_swiglu,
    mla_forward,
    rmsnorm,
    swiglu_forward,
)

__all__ = [
    "ModelConfig",
    "init_params",
    "apply_train",
    "apply_prefill",
    "apply_decode",
    "init_cache",
    "param_count",
    "params_from_numpy",
    "params_to_numpy",
    "cache_from_numpy",
    "cache_to_numpy",
    "shard_params",
    "gather_params",
    "shard_cache",
    "gather_cache",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    # layer pattern (cycled); both tuples must share one period length
    mixer_pattern: Tuple[str, ...] = ("attn",)  # "attn"|"ssm"|"cross"
    mlp_pattern: Tuple[str, ...] = ("dense",)  # "dense"|"moe"|"none"
    first_dense_layers: int = 0  # prefix of attn+dense layers (deepseek-v3)
    first_dense_ff: int = 0  # FFN width of the prefix layers (0 -> d_ff)
    causal: bool = True
    attn_kind: str = "gqa"  # "gqa"|"mla"
    sliding_window: int = 0  # >0: sliding-window attention (long_500k variant)
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # IO / modality
    input_kind: str = "tokens"  # "tokens"|"frames"|"tokens+vision"
    n_vision_tokens: int = 0
    frame_dim: int = 0
    mtp_depth: int = 0  # deepseek-v3 multi-token-prediction aux head
    dtype: str = "bfloat16"
    logit_chunk: int = 512  # chunked cross-entropy block
    remat: bool = True  # activation-checkpoint each layer group

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if len(self.mixer_pattern) != len(self.mlp_pattern):
            raise ValueError("mixer_pattern and mlp_pattern must share a period")
        if (self.n_layers - self.first_dense_layers) % len(self.mixer_pattern):
            raise ValueError(
                f"{self.name}: n_layers-{self.first_dense_layers} not divisible "
                f"by period {len(self.mixer_pattern)}"
            )

    @property
    def period(self) -> int:
        return len(self.mixer_pattern)

    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.first_dense_layers) // self.period

    @property
    def jdtype(self) -> torch.dtype:
        """The parameter dtype (the reference's name for it)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# per-layer init/apply
# ---------------------------------------------------------------------------

def _init_layer(rng: Draw, cfg: ModelConfig, mixer: str, mlp: str, ff: int = 0):
    dt = cfg.jdtype
    ff = ff or cfg.d_ff
    layer: Dict[str, Any] = {"norm1": init_rmsnorm(rng, cfg.d_model, dt)}
    if mixer == "attn":
        layer["mixer"] = (
            init_mla(rng, cfg, dt) if cfg.attn_kind == "mla" else init_gqa(rng, cfg, dt)
        )
    elif mixer == "cross":
        layer["mixer"] = init_cross_attn(rng, cfg, dt)
    elif mixer == "ssm":
        layer["mixer"] = ssm_mod.init_mamba2(rng, cfg, dt)
    else:
        raise ValueError(mixer)
    if mlp == "none":  # mixer-only block (Mamba-2)
        return layer
    layer["norm2"] = init_rmsnorm(rng, cfg.d_model, dt)
    if mlp == "dense":
        layer["mlp"] = init_swiglu(rng, cfg.d_model, ff, dt)
    elif mlp == "moe":
        layer["mlp"] = moe_mod.init_moe(rng, cfg, dt)
        if cfg.moe_dense_residual:
            layer["mlp_dense"] = init_swiglu(rng, cfg.d_model, cfg.d_ff, dt)
    else:
        raise ValueError(mlp)
    return layer


def _apply_layer(
    layer,
    cfg: ModelConfig,
    mixer: str,
    mlp: str,
    x,
    *,
    positions,
    vision=None,
    cache=None,
    cache_index=None,
    window=0,
    tp=None,
    held=None,
    ff=0,
    rows=None,
):
    """Returns (x, new_cache, aux) where aux = (lb_loss, z_loss).  ``tp``:
    the ``ModelAxis`` of the split, or None; ``held``: the layer's held
    specs under it; ``ff``: a dense MLP's hidden width (0: ``d_ff``);
    ``rows``: the axis the worker's rows are split over, or None."""
    h = rmsnorm(layer["norm1"], x)
    new_cache = cache
    if mixer == "attn":
        if cfg.attn_kind == "mla":
            out, new_cache = mla_forward(
                layer["mixer"], cfg, h, positions=positions, cache=cache,
                cache_index=cache_index, window=window, tp=tp,
                held=held and held["mixer"],
            )
        else:
            out, new_cache = gqa_forward(
                layer["mixer"], cfg, h, positions=positions, causal=cfg.causal,
                window=window, cache=cache, cache_index=cache_index, tp=tp,
                held=held and held["mixer"],
            )
    elif mixer == "cross":
        out = cross_attn_forward(layer["mixer"], cfg, h, vision, tp=tp,
                                 held=held and held["mixer"])
        new_cache = cache  # cross-attn kv are static vision tokens: no cache
    elif mixer == "ssm":
        if x.shape[1] == 1 and cache is not None:
            out, new_cache = ssm_mod.mamba2_decode_step(
                layer["mixer"], cfg, h, cache, tp=tp,
                held=held and held["mixer"])
        else:
            out, new_cache = ssm_mod.mamba2_forward(
                layer["mixer"], cfg, h, state=cache, tp=tp,
                held=held and held["mixer"])
    else:
        raise ValueError(mixer)
    x = x + out
    zero = torch.zeros((), dtype=F32, device=x.device)
    aux = (zero, zero)
    if mlp == "none":
        return x, new_cache, aux
    h = rmsnorm(layer["norm2"], x)
    if mlp == "dense":
        x = x + swiglu_forward(layer["mlp"], h, tp=tp, d_ff=ff or cfg.d_ff,
                               held=held and held["mlp"])
    else:
        mo = moe_mod.moe_forward(layer["mlp"], cfg, h,
                                 capacity_factor=cfg.capacity_factor, tp=tp,
                                 held=held and held["mlp"], rows=rows)
        x = x + mo.out
        if "mlp_dense" in layer:
            x = x + swiglu_forward(layer["mlp_dense"], h, tp=tp,
                                   d_ff=cfg.d_ff,
                                   held=held and held["mlp_dense"])
        aux = (mo.lb_loss, mo.z_loss)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# whole-model init
# ---------------------------------------------------------------------------

def init_params(seed, cfg: ModelConfig, *, device=None):
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    in the reference's tree: the same keys, shapes, dtypes and stacking.
    ``device="meta"`` allocates nothing."""
    rng = Draw.from_seed(seed, resolve_device(device))
    dt = cfg.jdtype
    params: Dict[str, Any] = {}
    if cfg.input_kind == "frames":
        params["frontend"] = dense_init(rng, cfg.frame_dim, cfg.d_model, dt)
    else:
        params["embed"] = rng.normal((cfg.vocab, cfg.d_model), dt, 0.02)

    # prefix (plain attn+dense) layers, stacked
    if cfg.first_dense_layers:
        params["prefix"] = _init_layer(
            rng.stacked(cfg.first_dense_layers), cfg, "attn", "dense",
            ff=cfg.first_dense_ff)

    # main body: one stacked tree per period position
    params["body"] = tuple(
        _init_layer(rng.stacked(cfg.n_periods), cfg, cfg.mixer_pattern[pos],
                    cfg.mlp_pattern[pos])
        for pos in range(cfg.period))

    params["final_norm"] = init_rmsnorm(rng, cfg.d_model, dt)
    params["unembed"] = dense_init(rng, cfg.d_model, cfg.vocab, dt, scale=0.02)
    if cfg.mtp_depth:
        params["mtp"] = {
            "layer": _init_layer(rng, cfg, "attn", "dense"),
            "norm": init_rmsnorm(rng, cfg.d_model, dt),
            "proj": dense_init(rng, 2 * cfg.d_model, cfg.d_model, dt),
        }
    return params


def param_count(cfg: ModelConfig) -> int:
    """The number of parameters, from the shapes on "meta"."""
    leaves, _ = tree_flatten(init_params(0, cfg, device="meta"))
    return sum(int(math.prod(leaf.shape)) for leaf in leaves)


# ---------------------------------------------------------------------------
# weights across the packages
# ---------------------------------------------------------------------------

def _leaf_to_torch(a, device):
    if a is None:
        return None
    a = np.array(a, order="C")  # a copy: JAX's host arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes, as JAX gives it
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf_to_numpy(t):
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (the reference's ``init_params`` output via
    ``np.asarray``; bf16 arrives as ``ml_dtypes.bfloat16`` and crosses as
    its bits) as the port's tree on ``device``: the same nesting,
    NamedTuples included, every leaf a tensor of the same dtype."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(a, dev), tree)


def params_to_numpy(tree):
    """The port's tree as numpy arrays on the host, bf16 as
    ``ml_dtypes.bfloat16`` (what ``jnp.asarray`` reads as bf16)."""
    return tree_map(_leaf_to_numpy, tree)


def shard_params(params, mesh, cfg: ModelConfig, mode: str = "tp"):
    """This rank's pieces of the whole tree ``params`` on ``mesh``, per
    ``sharding.rules.held_specs`` (under the "tp" split on a "model" axis
    of more than one rank, each split leaf's "model" piece, under fsdp_tp
    its "data" x "model" piece; otherwise the leaves themselves)."""
    from repro_torch.api.mesh_exec import _local_piece
    from repro_torch.sharding.rules import held_specs

    specs = _specs(held_specs(mesh, cfg, params, mode))[0]
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        leaf if not any(sp) else _local_piece(leaf, sp, mesh)
        for leaf, sp in zip(leaves, specs)])


def gather_params(pieces, mesh, cfg: ModelConfig, mode: str = "tp"):
    """The whole tree from every rank's ``shard_params`` pieces: each
    split leaf all-gathered over the axes that split it (a collective:
    every rank of the mesh calls it)."""
    from repro_torch.api.mesh_exec import _gather_leaf
    from repro_torch.sharding.rules import held_specs

    whole = init_params(0, cfg, device="meta")
    specs = _specs(held_specs(mesh, cfg, whole, mode))[0]
    leaves, treedef = tree_flatten(pieces)
    return tree_unflatten(treedef, [
        leaf if not any(sp) else _gather_leaf(leaf[None], sp, mesh, ())[0]
        for leaf, sp in zip(leaves, specs)])


# ---------------------------------------------------------------------------
# embedding / stack runner
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ModelConfig, batch, tp=None):
    """The input embedding; ``tp``: the axis it is split over (the
    vocabulary's rows of ``embed``, or the output columns of frame
    inputs' ``frontend``), or None."""
    if cfg.input_kind == "frames":
        x = batch["frames"].to(params["frontend"].dtype) @ params["frontend"]
        if tp is not None:
            # a column split, gathered back to the whole residual: its
            # backward keeps this rank's columns of a gradient that is the
            # same on every rank (the layers' copy_to_model summed it)
            x = tp_mod.gather_replicated(x, tp, -1)
    elif tp is not None:
        x = tp_mod.vocab_parallel_embed(params["embed"], batch["tokens"], tp)
    else:
        x = params["embed"][batch["tokens"].long()]
    return maybe_constrain(x, "data", None, None)


def _unstack(tree, n: int, tp=None, held=None, data=None) -> list:
    """The ``n`` slices along the leading axis of a stacked tree, as
    views (``unbind``: one backward node a leaf, which stacks the
    slices' gradients once; one slice: ``squeeze``).  Under the split
    (``tp``, ``held`` the tree's held specs) a leaf whose layer dimension
    is split (this rank holds n / M layers) gives a ``tp.LayerSlice`` a
    layer, fetched from its owner where it is used.  With ``data`` (the
    tree's "data" specs and its gradient sinks, or None), a leaf split
    over "data" gives a ``tp.DataSlice`` a layer (inside the
    ``LayerSlice``), gathered at the start of its step
    (:func:`_whole_over_data`)."""
    leaves, treedef = tree_flatten(tree)

    def views(leaf):
        # one layer: a view whose backward is a view too (unbind's stacks a
        # copy of the layer's gradient)
        return (leaf.squeeze(0),) if leaf.shape[0] == 1 else leaf.unbind(0)

    per_leaf = [views(leaf) for leaf in leaves]
    splits = ([None] * len(leaves) if held is None else
              [tp_mod.split_on(sp, 0) for sp in _specs(held)[0]])
    dims, sinks = [None] * len(leaves), [None] * len(leaves)
    if data is not None:
        dspecs, dsinks = data
        dims = [next((j - 1 for j, e in enumerate(sp) if e), None)
                for sp in _specs(dspecs)[0]]
        if dsinks is not None:
            sinks = [None if sk is None else views(sk) for sk in
                     tree_flatten(dsinks, is_leaf=lambda x: x is None)[0]]

    def layer(j, split, i):
        at = i if split is None else (i % len(per_leaf[j])
                                      if i // len(per_leaf[j]) == tp.rank
                                      else 0)
        out = per_leaf[j][at]
        if dims[j] is not None:
            out = tp_mod.DataSlice(out, dims[j],
                                   None if sinks[j] is None else sinks[j][at])
        if split is not None:
            out = tp_mod.LayerSlice(out, i // len(per_leaf[j]))
        return out

    return [tree_unflatten(treedef, [layer(j, sp, i)
                                     for j, sp in enumerate(splits)])
            for i in range(n)]


def _whole_over_data(tree, data):
    """A layer's tree (``_unstack``) with each ``tp.DataSlice`` gathered
    over ``data`` (the ``DataAxis``; inside a ``tp.LayerSlice`` too,
    before the fetch from the owner: the ranks of a "data" group share
    their "model" coordinate, so they are owners or anchors together)."""
    if data is None:
        return tree
    leaves, treedef = tree_flatten(tree)

    def whole(x):
        if isinstance(x, tp_mod.DataSlice):
            return x.whole(data)
        if isinstance(x, tp_mod.LayerSlice) and isinstance(
                x.local, tp_mod.DataSlice):
            return tp_mod.LayerSlice(x.local.whole(data), x.owner)
        return x

    return tree_unflatten(treedef, [whole(x) for x in leaves])


def _data_of(data, key):
    """(the specs on ``data``'s axis, the gradient sinks) of
    ``params[key]``, or None."""
    if data is None:
        return None
    sinks = data.sinks
    return data.held[key], None if sinks is None else sinks[key]


def _specs(held):
    return tree_flatten(held, is_leaf=lambda x: isinstance(x, P))


def _layer_held(held):
    """A stacked tree's held specs without the layer dimension: those of
    each of its layers."""
    leaves, treedef = _specs(held)
    return tree_unflatten(treedef, [P(*sp[1:]) for sp in leaves])


def _store(stacked, trees: list):
    """Write ``trees[i]`` into slice i of the stacked tree, in place, and
    return it; a slice that already is that view (an attention cache,
    written in place) is left as it is."""
    leaves, _ = tree_flatten(stacked)
    for i, tree in enumerate(trees):
        for dst, src in zip(leaves, tree_flatten(tree)[0]):
            if src.numel() and src.data_ptr() != dst[i].data_ptr():
                dst[i].copy_(src)
    return stacked


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` under activation checkpointing where the reference applies
    ``jax.checkpoint``; with no gradient being recorded there is nothing
    to save, so it runs as it is."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    return fn


def _run_stack(params, cfg: ModelConfig, x, *, positions, vision=None,
               caches=None, cache_index=None, window=0, tp=None, data=None,
               rows=None):
    """Run the prefix layers then the periodic body (``tp``: the split's
    axis, or None; ``data``: the ``DataAxis`` each layer's leaves are
    gathered over, or None; ``rows``: the axis the worker's rows are split
    over, or None).

    ``caches``: None (training/prefill without cache) or a dict
    {"prefix": stacked, "body": tuple of stacked per position} matching
    init_cache.  Returns (x, new_caches, aux_sum)."""
    aux = torch.zeros((2,), dtype=F32, device=x.device)
    new_caches = {"prefix": None, "body": None}

    def prefix_step(h, aux, layer, cache):
        layer = _whole_over_data(layer, data)
        h, nc, (lb, zl) = _apply_layer(
            layer, cfg, "attn", "dense", h, positions=positions, vision=vision,
            cache=cache, cache_index=cache_index, window=window, tp=tp,
            held=prefix_held, ff=cfg.first_dense_ff, rows=rows,
        )
        return h, aux + torch.stack([lb, zl]), nc

    def body_step(h, aux, layers, caches_slice):
        layers = _whole_over_data(layers, data)
        new_slices = []
        for pos in range(cfg.period):
            cache = None if caches_slice is None else caches_slice[pos]
            h, nc, (lb, zl) = _apply_layer(
                layers[pos], cfg, cfg.mixer_pattern[pos], cfg.mlp_pattern[pos], h,
                positions=positions, vision=vision, cache=cache,
                cache_index=cache_index, window=window, tp=tp,
                held=layer_held[pos], rows=rows,
            )
            aux = aux + torch.stack([lb, zl])
            new_slices.append(nc)
        return h, aux, tuple(new_slices)

    prefix_step = _maybe_remat(cfg, prefix_step)
    body_step = _maybe_remat(cfg, body_step)

    if cfg.first_dense_layers:
        n = cfg.first_dense_layers
        held = None if tp is None else tp.held["prefix"]
        prefix_held = held and _layer_held(held)
        layers = _unstack(params["prefix"], n, tp, held,
                          _data_of(data, "prefix"))
        pc = None if caches is None else _unstack(caches["prefix"], n)
        out = []
        for i in range(n):
            x, aux, nc = prefix_step(x, aux, layers[i],
                                     None if pc is None else pc[i])
            out.append(nc)
        if pc is not None:
            new_caches["prefix"] = _store(caches["prefix"], out)

    n = cfg.n_periods
    body_held = (None,) * cfg.period if tp is None else tp.held["body"]
    layer_held = [h and _layer_held(h) for h in body_held]
    body = _data_of(data, "body")
    per_pos = [_unstack(p, n, tp, h, body and (body[0][pos], body[1] and
                                               body[1][pos]))
               for pos, (p, h) in enumerate(zip(params["body"], body_held))]
    per_pos_caches = (None if caches is None
                      else [_unstack(c, n) for c in caches["body"]])
    out = []
    for i in range(n):
        layers = tuple(p[i] for p in per_pos)
        cs = None if per_pos_caches is None else tuple(
            c[i] for c in per_pos_caches)
        x, aux, nc = body_step(x, aux, layers, cs)
        out.append(nc)
    if caches is not None:
        new_caches["body"] = tuple(
            _store(caches["body"][pos], [o[pos] for o in out])
            for pos in range(cfg.period))
    return x, new_caches, aux


# ---------------------------------------------------------------------------
# losses / entry points
# ---------------------------------------------------------------------------

def _chunk_loss(hq, tq, vq, unembed):
    logits = (hq @ unembed).to(F32)  # (B, Q, V)
    logits = maybe_constrain(logits, "data", None, "model")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tq[..., None].long())[..., 0]
    valid = vq.to(F32)
    nll = (lse - gold) * valid
    return torch.sum(nll), torch.sum(valid)


def _chunk_loss_split(tp, hq, tq, vq, unembed):
    """``_chunk_loss`` on this rank's vocabulary columns of the
    unembedding: the vocabulary-parallel cross-entropy."""
    logits = (tp_mod.copy_to_model(hq, tp) @ unembed).to(F32)
    valid = vq.to(F32)
    nll = tp_mod.vocab_parallel_ce(logits, tq, tp) * valid
    return torch.sum(nll), torch.sum(valid)


def _chunked_ce(cfg, h, unembed, targets, valid, tp=None, rows=None):
    """Memory-bounded cross-entropy: a loop over sequence chunks, each
    chunk's logits recomputed in the backward pass (checkpointed) so the
    (B, S, vocab) tensor never exists at once.  With ``tp``, the axis the
    unembedding's vocabulary is split over, each chunk's cross-entropy is
    the vocabulary-parallel one (its all-reduces run again when the chunk
    is recomputed).  With ``rows``, the axis the worker's rows are split
    over, the loss's sum and its count of valid positions add up the
    axis's ranks, whether or not the vocabulary is split (a masked loss's
    count differs from rank to rank)."""
    B, S, D = h.shape
    Q = min(cfg.logit_chunk, S)
    n_chunks = -(-S // Q)
    pad = n_chunks * Q - S
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    loss_fn = _chunk_loss
    if tp is not None:
        loss_fn = lambda *a: _chunk_loss_split(tp, *a)  # noqa: E731
    if torch.is_grad_enabled():
        plain_fn = loss_fn
        loss_fn = lambda *a: checkpoint(plain_fn, *a, use_reentrant=False)  # noqa: E731
    total = torch.zeros((), dtype=F32, device=h.device)
    count = torch.zeros((), dtype=F32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * Q, (c + 1) * Q)
        ls, ns = loss_fn(h[:, sl], targets[:, sl], valid[:, sl], unembed)
        total = total + ls
        count = count + ns
    if rows is not None:
        total = tp_mod.reduce_from_data(total, rows)
        count = tp_mod.reduce_from_data(count.detach(), rows)
    return total / torch.clamp(count, min=1.0)


def _positions(B, S, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def _top_whole_over_data(params, data):
    """``params`` with the leaves outside the period loop (the embedding
    or the frame projection, the unembedding, the MTP head) gathered over
    ``data`` (the ``DataAxis``) once, where they are split over it; the
    stacked prefix and body are gathered a layer at a time in their
    steps."""
    out = dict(params)
    for key in out:
        if key in ("prefix", "body"):
            continue
        dspecs, dsinks = _data_of(data, key)
        leaves, treedef = tree_flatten(out[key])
        specs = _specs(dspecs)[0]
        sinks = ([None] * len(leaves) if dsinks is None
                 else tree_flatten(dsinks, is_leaf=lambda x: x is None)[0])
        out[key] = tree_unflatten(treedef, [
            x if not any(sp) else tp_mod.gather_from_data(
                x, data, next(j for j, e in enumerate(sp) if e), sk)
            for x, sp, sk in zip(leaves, specs, sinks)])
    return out


class _Split(NamedTuple):
    """What a pass reads of the enclosing ``model_axis`` block: Megatron's
    axis ``tp``, the ``DataAxis`` the held pieces are gathered over, the
    axis the rows are split over (each None where there is none), and the
    axes the embedding (or the frame projection's output columns) and
    the unembedding are split over, or None."""

    tp: Any
    data: Any
    rows: Any
    embed: Any
    unembed: Any


def _split_of(params, cfg: ModelConfig):
    """(``params`` with the leaves outside the period loop gathered over
    "data" where they are split over it, the pass's ``_Split``)."""
    axis = current_model_axis()
    tp = None if axis is None else axis.megatron  # Megatron's split, or None
    data = None if axis is None else axis.data
    held = None if tp is None else tp.held
    if data is not None:
        params = _top_whole_over_data(params, data)
    frames = cfg.input_kind == "frames"
    embed = tp if held and tp_mod.split_on(
        held["frontend"] if frames else held["embed"], int(frames)) else None
    unembed = tp if held and tp_mod.split_on(held["unembed"], 1) else None
    rows = None if axis is None else axis.rows_axis()
    return params, _Split(tp, data, rows, embed, unembed)


def apply_train(params, cfg: ModelConfig, batch):
    """Next-token (or masked-prediction) training loss.  Returns (loss, aux
    dict).  Inside a ``model_axis`` block (module docstring), the split on
    this rank's pieces: the same loss on every rank of the axis."""
    params, sp = _split_of(params, cfg)
    tp, data, rows = sp.tp, sp.data, sp.rows
    held = None if tp is None else tp.held
    tp_embed, tp_unembed = sp.embed, sp.unembed
    x = _embed_inputs(params, cfg, batch, tp_embed)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    vision = batch.get("vision") if cfg.input_kind == "tokens+vision" else None
    x, _, aux = _run_stack(
        params, cfg, x, positions=positions, vision=vision,
        window=cfg.sliding_window, tp=tp, data=data, rows=rows,
    )
    h = rmsnorm(params["final_norm"], x)

    if cfg.input_kind == "frames":
        targets = batch["targets"]
        valid = batch.get("mask")
        if valid is None:
            valid = torch.ones(targets.shape, dtype=torch.bool,
                               device=targets.device)
        loss = _chunked_ce(cfg, h, params["unembed"], targets, valid,
                           tp_unembed, rows)
    else:
        tokens = batch["tokens"]
        pad = torch.nn.functional.pad
        targets = pad(tokens[:, 1:], (0, 1))
        valid = (torch.arange(S, device=x.device)[None] < S - 1).expand(B, S)
        loss = _chunked_ce(cfg, h, params["unembed"], targets, valid,
                           tp_unembed, rows)
        if cfg.mtp_depth and "mtp" in params:
            # simplified DeepSeek-V3 MTP: one extra block predicts t+2
            mtp = params["mtp"]
            mheld = held and held["mtp"]
            if tp_embed is not None:
                nxt = tp_mod.vocab_parallel_embed(params["embed"], targets,
                                                  tp)
            else:
                nxt = params["embed"][targets.long()]  # emb of t+1
            hm = torch.cat([h, nxt.to(h.dtype)], dim=-1)
            if mheld and tp_mod.split_on(mheld["proj"], 1):
                # a column split, gathered back to the whole residual
                hm = tp_mod.gather_replicated(
                    tp_mod.copy_to_model(hm, tp) @ mtp["proj"], tp, -1)
            else:
                hm = hm @ mtp["proj"]
            hm, _, _ = _apply_layer(
                mtp["layer"], cfg, "attn", "dense", hm, positions=positions,
                tp=tp, held=mheld and mheld["layer"], rows=rows,
            )
            hm = rmsnorm(mtp["norm"], hm)
            t2 = pad(tokens[:, 2:], (0, 2))
            v2 = (torch.arange(S, device=x.device)[None] < S - 2).expand(B, S)
            loss = loss + 0.3 * _chunked_ce(cfg, hm, params["unembed"], t2,
                                            v2, tp_unembed, rows)

    lb, zl = aux[0], aux[1]
    n_moe = sum(1 for m in cfg.mlp_pattern if m == "moe") * cfg.n_periods
    if n_moe:
        loss = loss + 0.01 * lb / n_moe + 1e-4 * zl / n_moe
    return loss, {"lb_loss": lb, "z_loss": zl}


def _last_logits(params, x, tp_unembed):
    """The last position's logits (B, vocab) in f32, through the
    vocabulary-split unembedding gathered whole over it where
    ``tp_unembed`` is its axis."""
    h = rmsnorm(params["final_norm"], x[:, -1])
    logits = h @ params["unembed"]
    if tp_unembed is not None:
        logits = tp_mod.gather_replicated(logits, tp_unembed, -1)
    return logits.to(F32)


def apply_prefill(params, cfg: ModelConfig, batch):
    """Full-sequence forward returning last-position logits (B, vocab).
    Inside a ``model_axis`` block, the split on this rank's pieces and
    the batch's rows it is given (module docstring), forward only."""
    params, sp = _split_of(params, cfg)
    x = _embed_inputs(params, cfg, batch, sp.embed)
    B, S = x.shape[:2]
    vision = batch.get("vision") if cfg.input_kind == "tokens+vision" else None
    x, _, _ = _run_stack(
        params, cfg, x, positions=_positions(B, S, x.device), vision=vision,
        window=cfg.sliding_window, tp=sp.tp, data=sp.data, rows=sp.rows,
    )
    return _last_logits(params, x, sp.unembed)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, mixer: str, batch: int, cache_len: int,
                 device, lead):
    dt = cfg.jdtype

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    if mixer == "attn":
        if cfg.attn_kind == "mla":
            return {
                "ckv": zeros(batch, cache_len, cfg.kv_lora_rank),
                "krope": zeros(batch, cache_len, cfg.qk_rope_dim),
            }
        return {
            "k": zeros(batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
            "v": zeros(batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
        }
    if mixer == "ssm":
        return ssm_mod.init_ssm_state(cfg, batch, dt, device=device, lead=lead)
    if mixer == "cross":
        return {"_empty": zeros(batch, 0)}  # vision kv are inputs
    raise ValueError(mixer)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None,
               mesh=None):
    """Decode cache tree; attention caches hold ``cache_len`` positions
    (the sliding window size for long-context configs).  With ``mesh``,
    only this rank's ``sharding.rules.cache_specs`` pieces of the cache
    of ``batch`` rows (``_cache_specs``)."""
    if mesh is not None:
        whole = init_cache(cfg, batch, cache_len, device="meta")
        specs = _specs(_cache_specs(mesh, cfg, whole))[0]
        leaves, treedef = tree_flatten(whole)
        dev = resolve_device(device)
        from repro_torch.sharding.rules import local_shape

        return tree_unflatten(treedef, [
            torch.zeros(local_shape(mesh, x.shape, sp), dtype=x.dtype,
                        device=dev) for x, sp in zip(leaves, specs)])
    dev = resolve_device(device)
    if cfg.sliding_window:
        cache_len = min(cache_len, cfg.sliding_window)
    caches = {"prefix": None, "body": None}
    if cfg.first_dense_layers:
        caches["prefix"] = _layer_cache(cfg, "attn", batch, cache_len, dev,
                                        (cfg.first_dense_layers,))
    caches["body"] = tuple(
        _layer_cache(cfg, cfg.mixer_pattern[pos], batch, cache_len, dev,
                     (cfg.n_periods,))
        for pos in range(cfg.period))
    return caches


def _cache_specs(mesh, cfg: ModelConfig, whole):
    """``sharding.rules.cache_specs`` of the whole cache tree ``whole``
    on ``mesh``; raises where a "model" axis of more than one rank does
    not divide an attention cache's length or an SSM state's heads (the
    split decode step computes on such a block: it never holds the
    whole)."""
    from repro_torch.sharding.constraints import axis_size
    from repro_torch.sharding.rules import _map_with_name, cache_specs

    size = axis_size(mesh, "model")

    def check(name, x):  # stacked: dim 2 is the length, or the heads
        if size > 1 and name in ("k", "v", "ckv", "krope", "h") and \
                x.shape[2] % size:
            raise ValueError(
                f"{cfg.name}: a \"model\" axis of {size} ranks does not "
                f"divide dim 2 of the cache leaf {name} {tuple(x.shape)} "
                "(an attention cache's length, an SSM state's heads)")
        return x

    _map_with_name(check, whole)
    return cache_specs(mesh, cfg, whole)


def shard_cache(cache, mesh, cfg: ModelConfig):
    """This rank's ``cache_specs`` pieces of the whole decode cache
    ``cache`` (the rows over "data" where it divides them, an attention
    cache's length and an SSM state's heads over "model")."""
    from repro_torch.api.mesh_exec import _local_piece

    specs = _specs(_cache_specs(mesh, cfg, cache))[0]
    leaves, treedef = tree_flatten(cache)
    return tree_unflatten(treedef, [
        leaf if not any(sp) else _local_piece(leaf, sp, mesh)
        for leaf, sp in zip(leaves, specs)])


def gather_cache(pieces, mesh, cfg: ModelConfig, batch: int, cache_len: int):
    """The whole cache of ``batch`` rows and ``cache_len`` positions from
    every rank's ``shard_cache`` pieces (a collective: every rank of the
    mesh calls it)."""
    from repro_torch.api.mesh_exec import _gather_leaf

    whole = init_cache(cfg, batch, cache_len, device="meta")
    specs = _specs(_cache_specs(mesh, cfg, whole))[0]
    leaves, treedef = tree_flatten(pieces)
    return tree_unflatten(treedef, [
        leaf if not any(sp) else _gather_leaf(leaf[None], sp, mesh, ())[0]
        for leaf, sp in zip(leaves, specs)])


def cache_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's decode cache (its ``init_cache`` or
    ``apply_decode`` output through ``np.asarray``, its own ``SSMState``
    included, or any tree with the same leaves in flatten order) as the
    port's cache tree of ``cfg`` on ``device``."""
    dev = resolve_device(device)
    treedef = tree_flatten(init_cache(cfg, 1, 1, device="meta"))[1]
    return tree_unflatten(treedef, [_leaf_to_torch(a, dev)
                                    for a in tree_flatten(tree)[0]])


def cache_to_numpy(tree):
    """The port's cache tree as numpy arrays on the host, in its nesting
    (leaves in the reference's flatten order): copies, since a decode
    step writes the cache in place."""
    return tree_map(lambda t: None if t is None else np.array(
        _leaf_to_numpy(t)), tree)


def apply_decode(params, cfg: ModelConfig, batch, caches, cache_index):
    """One-token decode step: batch["tokens"] is (B, 1); ``cache_index`` is
    the write position (== current sequence length so far, possibly wrapped
    by the caller for sliding windows).  Returns (logits (B, vocab), caches).

    The caches are updated in place and returned (the same tensors): the
    reference's functional update copies the cache each step, which at
    decode_32k's batch 128 x 32,768 would hold it three times over.
    Inside a ``model_axis`` block, the split on this rank's pieces of the
    params and of the cache (``init_cache(..., mesh=)``) and the rows of
    the batch it is given (module docstring)."""
    cache_index = int(cache_index)
    params, sp = _split_of(params, cfg)
    x = _embed_inputs(params, cfg, batch, sp.embed)
    B = x.shape[0]
    positions = torch.full((B, 1), cache_index, dtype=torch.long,
                           device=x.device)
    vision = batch.get("vision") if cfg.input_kind == "tokens+vision" else None
    x, new_caches, _ = _run_stack(
        params, cfg, x, positions=positions, vision=vision, caches=caches,
        cache_index=cache_index, window=cfg.sliding_window, tp=sp.tp,
        data=sp.data, rows=sp.rows,
    )
    return _last_logits(params, x, sp.unembed), new_caches
