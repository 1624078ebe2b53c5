"""Distributed Byz-VR-MARINA-PP trainer on ``torch.distributed``, the
counterpart of ``repro.launch.train``.

Mapping: a worker is a coordinate of the mesh's worker axes ("pod" and
"data", or the plan's or config's override), ``W`` of them.  The port
runs in manual SPMD, as ``repro_torch.api.mesh_exec`` does: every rank
calls the step with its held state and the same global batch, and gets
back its held new state.  What a rank holds is ``sharding.rules.
held_specs``, the reference's ``state_specs``: its ``param_specs``
piece of every leaf of params and g (under "tp" its "model" piece, under
fsdp_tp its "data" x "model" piece, under zero3 its piece of the "fsdp"
slot over "model"), the norms and scalars whole.  ``initial_state``
builds it from whole params.  Within a step, a rank

1. draws the round's randomness (the coin c_k, the cohort, the attack's
   and the compressor's seeds, Bucketing's order) from one CPU
   ``torch.Generator`` whose state is ``MeshTrainState.key``, the same
   on every rank; a :class:`TrainTape` replaces every draw with recorded
   ones (the reference's, in the parity tests);
2. takes x^{k+1} = x^k - gamma g^k (in f32, cast back) and its worker's
   gradient at x^{k+1} (and, on difference rounds, at x^k) on its
   worker's rows of the batch (worker i: rows i*b:(i+1)*b), by
   ``torch.autograd.grad`` over the held leaves, remat kept; inside a
   ``model_axis`` block, so that the ranks of a worker's "model" axis
   compute its gradient once between them, each its pieces: under "tp"
   and fsdp_tp by Megatron's split (``models.tp``), under zero3 by the
   whole pass on each rank's share of the rows.  Under fsdp_tp each
   layer's leaves are gathered over "data" before use, under zero3 over
   "model"; where "data" is a worker axis each of its ranks is another
   worker, and the worker's gradient of a gathered leaf stays whole over
   "data" (the reference's per-worker gradient, ``DataAxis`` "keep");
   where the axis is not a worker axis (fsdp_tp's "data" with pod
   workers, zero3's "model"), the worker's rows split over it when its
   size divides them (rank r: rows r*b/size on), the loss's sums over
   rows add up its ranks, and a reduce-scatter sums the gradients of the
   gathered leaves (an all-reduce those of the whole ones); where its
   size does not divide them, every rank runs them all and keeps its
   piece of the gradient;
3. forms its worker's message: the gradient (full rounds) or the
   gradient difference, leafwise RandK'd (``CompressSpec(kind=
   "rand_fraction")``), then corrupted by the attack if the worker is
   byzantine;
4. hands its message, the held piece with the worker axes stripped,
   to the plan's mesh step (``plan.build(mesh)``) with ``param_specs``
   stripped of the worker axes as ``base_specs`` (the message already
   is that piece); and takes the aggregate back to the held piece:
   narrowed along the axes that the held piece splits and the
   aggregation does not (fsdp_tp's "data" when it is a worker axis);
   nothing is gathered back; g^{k+1} = g^k + agg
   (difference rounds, clipped at lambda = alpha gamma ||g^k||, the norm
   of the whole g: each piece's squares summed over the axes that split
   it, the whole leaves counted once) or agg (full rounds, no clip).

Differences from the reference, each for a reason:

- **The split is Megatron's, written out.**  The reference's GSPMD
  splits every family's forward and backward pass over "model"; the
  port splits the attention decoders, dense, MoE (arctic) and MLA
  (deepseek-v3), the SSM and hybrid decoders (mamba2, jamba: the Mamba-2
  mixer's heads, ``in_proj`` and ``conv_w`` fetched whole once a layer
  since their pieces cut across its packed parts), the cross-attention
  decoder (llama-3.2-vision: the heads split, the vision tokens
  replicated, the gate after the sum) and the audio encoder (hubert: the
  frame projection column-split and gathered back to the residual)
  alike (``models.tp``).  zero3 splits no model compute: each layer is
  gathered over "model" in the period loop and the rows split over it,
  as the reference's ``override_data_axes(("model",))`` places them.
  Under "tp" with pod workers every "data" rank of a pod runs the
  worker's whole rows (the same numbers, computed again on each); the
  rows split over "data" under fsdp_tp only.  Where a rank's heads reach
  past its pieces (fewer kv heads than ranks) it all-gathers those
  weights.
- **Draws are of whole leaves.**  RandK's uniforms and gauss's noise are
  drawn per whole leaf, as before, and a rank keeps its piece of them,
  so that the split replays the whole run's draws exactly.
- **The key is a generator state.**  ``MeshTrainState.key`` is the uint8
  state of a CPU ``torch.Generator`` seeded from ``cfg.seed``, so that
  the state stays a plain tree that checkpoints; draws on the CPU make a
  run's draws independent of the device (the card replays the CPU's).
- **Omniscient attacks gather pieces.**  alie and ipm read every sampled
  honest message: their ranks all-gather the honest pieces over the
  worker axes (counted in ``collective_counts()``), run the attack on
  the (W, piece) view, whose statistics are per coordinate and so exact
  on a piece, and keep their own row.  The other attacks read only
  their own row and need no collective.
- ``jax.lax.cond`` is a Python branch on the coin, the same on every
  rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..api import AggregatorSpec, ClipSpec, PlanError, ScheduleSpec
from ..api import ServerPlan
from ..api.mesh_exec import _all_gather, _count, _spec_axes, leaf_agg_of
from ..core.tree_utils import tree_flatten, tree_map, tree_norm
from ..core.tree_utils import tree_unflatten
from ..models.model import ModelConfig, apply_train, init_params
from ..models.model import shard_params
from ..sharding.constraints import DataAxis, ModelAxis, model_axis
from ..sharding.rules import (LocalShard, held_specs, local_shape,
                              model_split, only_axis, param_specs,
                              state_sharding)
from .mesh import P, axis_size, model_group, num_workers
from .mesh import worker_axes as default_worker_axes

__all__ = [
    "ByzTrainConfig",
    "MeshTrainState",
    "TrainTape",
    "make_train_step",
    "robust_aggregate",
    "abstract_state",
    "state_specs",
    "resolve_plan",
    "train_key",
    "worker_grads",
    "model_axis_of",
    "initial_state",
    "train_loss",
    "held_norm",
    "main",
]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ByzTrainConfig:
    gamma: float = 3e-4
    p: float = 0.125  # Bernoulli full-grad probability
    n_byz: int = 0  # trailing workers are byzantine
    C: int = 0  # sampled cohort size (0 => all workers)
    # THE aggregation composition: a repro_torch.api.ServerPlan.  None
    # builds the sharded coordinate-median default with lambda =
    # 2.0 * ||x+ - x|| clipping and byz_bound = n_byz (``resolve_plan``).
    plan: Optional[ServerPlan] = None
    attack: str = "bf"  # a registry name or a core.attacks.Attack
    shard_mode: str = "tp"  # "tp" | "fsdp_tp" | "zero3"
    # the worker axes (empty: every batch-like axis, pod x data)
    worker_axes_override: tuple = ()
    seed: int = 0  # the seed of the step's generator (``train_key``)

    @classmethod
    def from_plan(cls, plan: ServerPlan, **overrides) -> "ByzTrainConfig":
        """Config with ``plan`` as the aggregation composition; the
        trainer-owned knobs come from ``overrides``."""
        return cls(plan=plan, **overrides)


def resolve_plan(cfg: ByzTrainConfig) -> ServerPlan:
    """The config's ServerPlan: explicit ``cfg.plan``, or the default
    trainer composition — coordinate-wise median on the sharded placement,
    clipping at lambda = 2.0 * ||x+ - x||."""
    if cfg.plan is not None:
        return cfg.plan
    return ServerPlan(
        aggregate=AggregatorSpec("cm", trim_ratio=0.25, byz_bound=cfg.n_byz),
        clip=ClipSpec(alpha=2.0),
        schedule=ScheduleSpec(placement="sharded",
                              worker_axes=tuple(cfg.worker_axes_override)),
        cohort=cfg.C or None,
    )


class MeshTrainState(NamedTuple):
    params: object  # x^k
    g: object  # g^k (gradient-shaped)
    key: torch.Tensor  # uint8: the state of the step's CPU generator
    step: torch.Tensor  # int32 scalar


def train_key(seed: int) -> torch.Tensor:
    """The initial ``MeshTrainState.key`` for ``seed``."""
    return torch.Generator().manual_seed(int(seed)).get_state()


@dataclasses.dataclass(frozen=True)
class TrainTape:
    """Recorded draws of ``steps`` steps over W workers: ``c`` (steps,)
    bool coins, ``sampled`` (steps, W) bool cohorts, ``order`` (steps, W)
    Bucketing's permutations, ``attack_noise[k][i]`` (W, size of leaf i)
    gauss's standard normal noise at step k, and ``randk[k][w][i]``
    (size of leaf i,) the uniforms of worker w's RandK at step k (leaves
    in flatten order).  The last two are needed only by gauss and by a
    compressing plan."""

    c: np.ndarray
    sampled: np.ndarray
    order: np.ndarray
    attack_noise: Optional[Sequence] = None
    randk: Optional[Sequence] = None

    def __len__(self) -> int:
        return len(self.c)


# ---------------------------------------------------------------------------
# aggregation entry points (over the ServerPlan API)
# ---------------------------------------------------------------------------

def _make_leaf_agg(cfg: ByzTrainConfig):
    """Aggregation over the worker axis of ONE leaf, resolved from the
    config's plan (the single-leaf semantics of direct callers)."""
    return leaf_agg_of(resolve_plan(cfg).build_aggregator())


def robust_aggregate(tree_w, mask, key, *, mesh, cfg: ByzTrainConfig,
                     base_specs=None, radius=None):
    """Aggregate this rank's piece of a worker-stacked tree under the
    config's resolved ServerPlan: ``resolve_plan(cfg).build(mesh)(...)``
    (``repro_torch.api.mesh_exec`` describes the pieces)."""
    step = resolve_plan(cfg).build(mesh)
    return step(tree_w, mask=mask, key=key, radius=radius,
                base_specs=base_specs)


# ---------------------------------------------------------------------------
# worker-side messages
# ---------------------------------------------------------------------------

def _leafwise_randk(key, tree, frac, shapes=None, cuts=None):
    """Unbiased leafwise RandK: keep the coordinates whose uniform score
    is among the ``max(1, int(frac * size))`` largest (ties at the
    threshold kept), scaled by size / kept.  ``key``: a
    ``torch.Generator`` (each leaf's uniforms drawn in leaf order) or one
    uniform array a leaf.  With ``shapes`` and ``cuts`` the leaves are
    pieces: the mask is drawn over each whole leaf (``shapes[i]``) and
    ``cuts[i]`` cuts this rank's piece of it."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for i, leaf in enumerate(leaves):
        shape = leaf.shape if shapes is None else shapes[i]
        d = math.prod(shape)
        kk = max(1, int(frac * d))
        if isinstance(key, torch.Generator):
            scores = torch.rand(d, generator=key, device=key.device)
        else:
            scores = torch.as_tensor(np.array(key[i], np.float32)).reshape(-1)
        scores = scores.to(device=leaf.device, dtype=F32)
        thresh = torch.topk(scores, kk).values[-1]
        mask = (scores >= thresh).reshape(shape)
        if cuts is not None:
            mask = cuts[i](mask)
        scale = torch.tensor(d / kk, dtype=leaf.dtype, device=leaf.device)
        out.append(leaf * mask.to(leaf.dtype) * scale)
    return tree_unflatten(treedef, out)


def _attack_stage(cfg: ByzTrainConfig):
    """The worker-stacked attack stage for the config's attack (a
    registry name or a built ``core.attacks.Attack``); iterate-reading
    (shb) and adaptive attacks are the simulation engines' and raise."""
    from ..scenarios.stage import TreeAttackStage

    stage = TreeAttackStage(cfg.attack)
    if stage.attack.needs_iterates:
        raise PlanError(
            f"attack {stage.attack.name!r} reads the iterates (x0, x_now); "
            "the mesh trainer does not track x0 — pick a message-level "
            "attack (bf/sf/lf/alie/ipm/gauss) or run shb through the "
            "simulation engines (repro_torch.core)")
    return stage


def _pass_axis(axis: Optional[ModelAxis], batch):
    """(the axis of a worker's pass on ``batch``, this rank's rows of
    it): under fsdp_tp with "data" not a worker axis, the rows split over
    "data" when its size divides them (rank r: the r-th block), else
    every rank takes them all."""
    data = None if axis is None else axis.data
    if data is None or data.worker:
        return axis, batch
    b = next(iter(batch.values())).shape[0]
    if b % data.size:
        return dataclasses.replace(axis, data=dataclasses.replace(
            data, rows=False)), batch
    n = b // data.size
    return (dataclasses.replace(axis, data=dataclasses.replace(data,
                                                               rows=True)),
            {k: v[data.rank * n:(data.rank + 1) * n]
             for k, v in batch.items()})


def _sinks(leaves, data: DataAxis):
    """The gradient sinks of the leaves split over "data" (zeros of the
    gathered shape, whole over "data"), None for the others: a tree in
    the params' structure."""
    specs, treedef = tree_flatten(data.held, is_leaf=lambda x: isinstance(
        x, P))
    out = []
    for x, sp in zip(leaves, specs):
        if not any(sp):
            out.append(None)
            continue
        shape = list(x.shape)
        for j, e in enumerate(sp):
            if e:
                shape[j] *= data.size
        out.append(torch.zeros(shape, dtype=x.dtype, device=x.device))
    return tree_unflatten(treedef, out)


def _sum_over_rows(grads: list, whole: list, data: DataAxis) -> None:
    """Sum over "data" the gradients ``grads[i]``, i in ``whole`` (the
    leaves not split over it, each rank's its rows' part), in place of
    the list: one all-reduce a dtype."""
    by_dtype = {}
    for i in whole:
        by_dtype.setdefault(grads[i].dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        torch.distributed.all_reduce(flat, group=data.group)
        _count("all_reduce", flat, data.group)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])


def worker_grads(params, model_cfg: ModelConfig, batch,
                 axis: Optional[ModelAxis] = None) -> list:
    """The gradient of ``apply_train``'s loss on ``batch`` at ``params``,
    as a list of leaves in flatten order (``torch.autograd.grad``).  With
    ``axis`` (``model_axis_of``), ``params`` are this rank's held pieces
    and the pass is split over it: the gradient of each piece.  Under
    fsdp_tp (``axis.data``) the rows split over "data" where
    ``_pass_axis`` says so, and a leaf split over "data" gets its
    worker's gradient whole over "data" where "data" is a worker axis,
    else the gradient of its piece (summed over the rows' ranks)."""
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    axis, batch = _pass_axis(axis, batch)
    data = None if axis is None else axis.data
    sinks = None
    if data is not None and data.worker:
        sinks = _sinks(leaves, data)
        axis = dataclasses.replace(axis, data=dataclasses.replace(
            data, sinks=sinks))
    with model_axis(axis):
        loss, _ = apply_train(tree_unflatten(treedef, leaves), model_cfg,
                              batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    if sinks is not None:  # the gathered leaves' gradients are the sinks'
        grads = [gr if sk is None else sk for gr, sk in zip(
            grads, tree_flatten(sinks, is_leaf=_is_none)[0])]
    grads = [torch.zeros_like(x) if gr is None else gr
             for gr, x in zip(grads, leaves)]
    if data is None or not data.rows:
        return grads
    whole = [i for i, sp in enumerate(tree_flatten(
        data.held, is_leaf=lambda x: isinstance(x, P))[0]) if not any(sp)]
    _sum_over_rows(grads, whole, data)
    return grads


def _is_none(x) -> bool:
    return x is None


def model_axis_of(mesh, model_cfg: ModelConfig, shard_mode: str = "tp",
                  worker_axes: Optional[tuple] = None) -> Optional[ModelAxis]:
    """The axis a worker's pass runs on over ``mesh``: a ``ModelAxis`` on
    "model", with this rank's "model" ``held_specs`` where Megatron's
    split is on (``model_split`` "tp" and more than one "model" rank) and
    the ``DataAxis`` of the pieces held besides: under fsdp_tp over
    "data" (a worker axis where ``worker_axes``, the run's, name it: by
    default the mesh's), under zero3 over "model" itself (not a worker
    axis); None where nothing is split (the pass runs whole)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return None
    size = axis_size(mesh, "model")
    held = held_specs(mesh, model_cfg, init_params(0, model_cfg,
                                                   device="meta"), shard_mode)
    leaves, treedef = tree_flatten(held, is_leaf=lambda x: isinstance(x, P))

    def on(axes):
        return tree_unflatten(treedef, [only_axis(sp, axes) for sp in leaves])

    data = None
    if shard_mode == "zero3":
        if size > 1:
            data = DataAxis(model_group(mesh), mesh.get_local_rank("model"),
                            size, on("model"), worker=False)
    elif any("data" in _spec_axes(sp) for sp in leaves):
        waxes = default_worker_axes(mesh) if worker_axes is None \
            else tuple(worker_axes)
        data = DataAxis(mesh.get_group("data"), mesh.get_local_rank("data"),
                        axis_size(mesh, "data"), on("data"),
                        worker="data" in waxes)
    megatron = model_split(model_cfg, shard_mode) == "tp" and size > 1
    if not megatron and data is None:
        return None
    return ModelAxis(model_group(mesh), mesh.get_local_rank("model"), size,
                     on("model") if megatron else None, data)


def held_norm(g_leaves, axis: Optional[ModelAxis], held) -> torch.Tensor:
    """||g|| of the whole g from this rank's pieces ``g_leaves`` (their
    held specs ``held``, in flatten order): each piece's squares summed
    over the axes that split it ("model", "data" or both; ``axis`` and,
    under fsdp_tp, its ``data``), the whole leaves' counted once (a
    collective on the split's groups)."""
    if axis is None:
        return tree_norm(g_leaves)
    kinds = [("model" in _spec_axes(sp), "data" in _spec_axes(sp))
             for sp in held]
    zero = torch.zeros((), device=g_leaves[0].device)

    def ssq(kind):
        return sum((g.float().square().sum() for g, k in zip(g_leaves, kinds)
                    if k == kind), zero)

    # over "model": the pieces split on both axes and on "model" alone;
    # then over "data": the first of those with the "data"-only ones
    parts = torch.stack([ssq((True, True)), ssq((True, False))])
    torch.distributed.all_reduce(parts, group=axis.group)
    _count("all_reduce", parts, axis.group)
    total = parts[0] + ssq((False, True))
    if any(k[1] for k in kinds):  # pieces split over "data"
        torch.distributed.all_reduce(total, group=axis.data.group)
        _count("all_reduce", total, axis.data.group)
    return torch.sqrt(total + parts[1] + ssq((False, False)))


def _run_worker_axes(mesh, cfg: "ByzTrainConfig") -> tuple:
    """The worker axes of a run: the plan's, the config's override, or
    every batch-like axis of the mesh."""
    return (tuple(resolve_plan(cfg).schedule.worker_axes)
            or tuple(cfg.worker_axes_override) or default_worker_axes(mesh))


def initial_state(params, model_cfg: ModelConfig, mesh, cfg: "ByzTrainConfig",
                  batch) -> "MeshTrainState":
    """The state a rank starts from: its held pieces of the whole
    ``params`` (``models.model.shard_params``), g^0 its worker's gradient
    of them on ``batch`` (split as the steps are, and cut to the held
    pieces), the key of ``cfg.seed`` and step 0."""
    held = shard_params(params, mesh, model_cfg, cfg.shard_mode)
    axis = model_axis_of(mesh, model_cfg, cfg.shard_mode,
                         _run_worker_axes(mesh, cfg))
    leaves, treedef = tree_flatten(held)
    g0 = worker_grads(held, model_cfg, batch, axis)
    if axis is not None and axis.data is not None and axis.data.worker:
        cuts = tree_flatten(state_sharding(mesh, axis.data.held),
                            is_leaf=lambda x: isinstance(x, LocalShard))[0]
        g0 = [cut(g) if g.shape != x.shape else g
              for g, x, cut in zip(g0, leaves, cuts)]
    return MeshTrainState(params=held, g=tree_unflatten(treedef, g0),
                          key=train_key(cfg.seed),
                          step=torch.zeros((), dtype=torch.int32))


def train_loss(params, model_cfg: ModelConfig, batch, mesh=None,
               shard_mode: str = "tp", worker_axes=None) -> float:
    """``apply_train``'s loss at a rank's held ``params`` (split over the
    mesh's "model" axis where ``model_axis_of`` says so: a collective),
    without gradients: the loss on all of ``batch``'s rows, on every
    rank (under fsdp_tp with "data" not one of the ``worker_axes``, the
    rows split over "data" and the sums added up)."""
    axis = None if mesh is None else model_axis_of(mesh, model_cfg,
                                                   shard_mode, worker_axes)
    axis, batch = _pass_axis(axis, batch)
    with torch.no_grad(), model_axis(axis):
        return float(apply_train(params, model_cfg, batch)[0])


def _sub_seed(seed: int, *ids) -> int:
    """A generator seed for (seed, *ids): the fold_in of this package."""
    ss = np.random.SeedSequence([int(seed), *map(int, ids)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


def _strip(spec, waxes) -> P:
    """``spec`` with the worker axes taken out of every entry (a mesh
    axis appears once: the worker dimension consumes them)."""
    def strip(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a not in waxes)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if entry in waxes else entry

    return P(*(strip(e) for e in spec))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def make_train_step(model_cfg: ModelConfig, mesh, cfg: ByzTrainConfig,
                    on_aggregate=None):
    """Build ``train_step(state, batch, tape=None) -> MeshTrainState`` for
    this rank of ``mesh``.

    The aggregation composition is the config's resolved ServerPlan,
    built once by ``plan.build(mesh)``; the plan also gives the clip
    stage (lambda = alpha * gamma * ||g||, or its static radius) and the
    compression fraction.  ``state`` holds this rank's pieces
    (``initial_state``); ``batch`` is the global batch (leaves with a
    leading W * b), the same on every rank; ``tape`` replaces the step's
    draws (module docstring).  ``on_aggregate(full, leaves)``, when
    given, sees each step's aggregate of the held pieces (its leaves in
    flatten order, in the server's dtype; whole where the rank holds
    leaves whole) before it is added to g: a probe for checks, since the
    cast of g + agg to g's dtype rounds most of a small aggregate away."""
    plan = resolve_plan(cfg)
    server = plan.build(mesh)
    attack_stage = _attack_stage(cfg)
    # cohort and worker axes are trainer-owned knobs when the plan leaves
    # them unset; an explicit plan.cohort / plan.schedule.worker_axes wins
    waxes = _run_worker_axes(mesh, cfg)
    W = math.prod(axis_size(mesh, a) for a in waxes)
    C = plan.cohort or cfg.C or W
    w = 0  # this rank's worker: its coordinates on waxes, row-major
    for a in waxes:
        w = w * axis_size(mesh, a) + mesh.get_local_rank(a)
    byz = torch.arange(W) >= W - cfg.n_byz
    byzantine = bool(byz[w])
    omniscient = attack_stage.attack.omniscient

    compress_frac = 0.0
    if plan.compress is not None:
        if plan.compress.kind != "rand_fraction":
            raise PlanError(
                "the mesh trainer's worker-side compression is leafwise "
                "RandK by fraction; use CompressSpec(kind='rand_fraction', "
                f"frac=...), got kind={plan.compress.kind!r}")
        compress_frac = plan.compress.frac

    axis = model_axis_of(mesh, model_cfg, cfg.shard_mode, waxes)
    whole = init_params(0, model_cfg, device="meta")
    shapes = [tuple(x.shape) for x in tree_flatten(whole)[0]]

    def flat_specs(tree):
        return tree_flatten(tree, is_leaf=lambda x: isinstance(x, P))[0]

    def shards(specs):
        return tree_flatten(state_sharding(mesh, specs),
                            is_leaf=lambda x: isinstance(x, LocalShard))[0]

    # the piece the rank holds (param_specs) and the message's extent,
    # the aggregation's spec: the held piece with the worker axes
    # stripped (a worker's gradient is whole over them).  The aggregate
    # comes back to the held piece narrowed along the worker axes that
    # the held piece splits (fsdp_tp's "data" when it is a worker axis)
    held = flat_specs(held_specs(mesh, model_cfg, whole, cfg.shard_mode))
    specs = [_strip(hp, waxes) for hp in held]
    narrows = shards([P(*(h if e is None else None for e, h in zip(sp, hp)))
                      for sp, hp in zip(specs, held)])
    msg_cuts = shards(specs)
    del whole

    def noise_pieces(noise):
        """gauss's noise of each whole leaf (1, size), cut to the
        message's extent (1, piece size)."""
        return [cut(nz.reshape(1, *shp)[0]).reshape(1, -1)
                for nz, shp, cut in zip(noise, shapes, msg_cuts)]

    def back(agg, i):
        """Leaf i's aggregate, back to the held piece."""
        return narrows[i](agg) if any(narrows[i].spec) else agg

    def draws(state, tape):
        """(c, sampled, order, attack key, RandK key) of this step, and
        the generator state after it: every rank draws the same values
        (the two keys are this worker's)."""
        k = int(state.step)
        gen = torch.Generator()
        gen.set_state(state.key)
        c = bool(torch.rand((), generator=gen) < cfg.p)
        perm = torch.randperm(W, generator=gen)
        order = torch.randperm(W, generator=gen)
        seed_att, seed_q = (int(s) for s in torch.randint(
            0, 2 ** 62, (2,), generator=gen))
        rank = torch.empty(W, dtype=torch.long)
        rank[perm] = torch.arange(W)
        sampled = rank < (W if c else C)
        att_key = torch.Generator().manual_seed(_sub_seed(seed_att, w))
        q_key = torch.Generator().manual_seed(_sub_seed(seed_q, w))
        if tape is not None:
            if len(tape) <= k:
                raise ValueError(f"the tape holds {len(tape)} steps, not "
                                 f"step {k}")
            c = bool(tape.c[k])
            sampled = torch.as_tensor(np.asarray(tape.sampled[k], bool))
            order = torch.as_tensor(np.asarray(tape.order[k]),
                                    dtype=torch.long)
            if tape.attack_noise is not None:
                att_key = [torch.as_tensor(np.asarray(nz, np.float32))
                           for nz in tape.attack_noise[k]]
            if compress_frac > 0.0:
                if tape.randk is None:
                    raise ValueError("a compressing plan's tape needs its "
                                     "randk uniforms")
                q_key = tape.randk[k][w]
        return c, sampled, order, att_key, q_key, gen.get_state()

    def corrupt(msgs, dev, sampled, att_key):
        """This rank's pieces (1, *piece) of its worker's wire message."""
        good = ~byz.to(dev)
        if omniscient and cfg.n_byz > 0:
            pieces = [m[None] for m in msgs]
            rows = pieces
            for ax in reversed(waxes):
                rows = [_all_gather(r, mesh, ax) for r in rows]
            if not byzantine:
                return pieces
            # the registry's omniscient attacks draw nothing
            wire = attack_stage.corrupt_tree(rows, good_mask=good,
                                             sampled=sampled, key=None)
            return [r[w:w + 1] for r in wire]
        if byzantine:  # the other attacks read only their own row
            key = att_key if isinstance(att_key, torch.Generator) else [
                nz[w:w + 1] for nz in att_key]
            if axis is not None and attack_stage.attack.name == "gauss" \
                    and isinstance(key, torch.Generator):  # whole leaves
                key = [torch.randn((1, math.prod(shp)), generator=key,
                                   device=key.device) for shp in shapes]
            if axis is not None and not isinstance(key, torch.Generator):
                key = noise_pieces(key)
            msgs = attack_stage.corrupt_tree(
                [m[None] for m in msgs], good_mask=good[w:w + 1],
                sampled=sampled[w:w + 1], key=key)
            msgs = [m[0] for m in msgs]
        return [m[None] for m in msgs]

    def train_step(state: MeshTrainState, batch, tape=None):
        c, sampled, order, att_key, q_key, next_key = draws(state, tape)
        p_leaves, treedef = tree_flatten(state.params)
        g_leaves = tree_flatten(state.g)[0]
        dev = p_leaves[0].device
        sampled, order = sampled.to(dev), order.to(dev)

        # x^{k+1} = x^k - gamma g^k, in f32; lambda = alpha*gamma*||g||
        params_new = []
        for x, g in zip(p_leaves, g_leaves):
            upd = g.to(F32, copy=True).mul_(cfg.gamma).neg_().add_(x)
            params_new.append(upd.to(x.dtype))
            del upd
        radius = None
        if server.clips and plan.clip.radius is not None:
            radius = float(plan.clip.radius)
        elif server.clips:
            radius = plan.clip.alpha * cfg.gamma * held_norm(g_leaves, axis,
                                                             held)

        # this worker's rows of the global batch
        b = next(iter(batch.values())).shape[0] // W
        wbatch = {k: v[w * b:(w + 1) * b] for k, v in batch.items()}
        msgs = worker_grads(tree_unflatten(treedef, params_new), model_cfg,
                            wbatch, axis)
        if not c:
            old = worker_grads(state.params, model_cfg, wbatch, axis)
            for m, o in zip(msgs, old):
                m.sub_(o)  # g_i(x^{k+1}) - g_i(x^k), in the gradient dtype
            del old
            if compress_frac > 0.0:
                msgs = _leafwise_randk(
                    q_key, msgs, compress_frac, *(
                        (shapes, msg_cuts) if axis is not None else ()))
        pieces = corrupt(msgs, dev, sampled, att_key)
        del msgs
        tree_w = tree_unflatten(treedef, pieces)
        spec_tree = tree_unflatten(treedef, specs)
        if c:  # full rounds aggregate the raw gradients: no clip
            agg = server.aggregate(tree_w, mask=sampled, key=order,
                                   base_specs=spec_tree)
        else:
            agg = server(tree_w, mask=sampled, key=order, radius=radius,
                         base_specs=spec_tree)
        del tree_w, pieces
        # back to the held pieces
        aggs = (back(a, i) for i, a in enumerate(tree_flatten(agg)[0]))
        if on_aggregate is not None:
            aggs = list(aggs)
            on_aggregate(c, aggs)
        g_new = []
        for a, g in zip(aggs, g_leaves):
            if c:
                g_new.append(a.to(g.dtype))
            else:
                g_new.append(g.to(F32, copy=True).add_(a).to(g.dtype))
        return MeshTrainState(
            params=tree_unflatten(treedef, params_new),
            g=tree_unflatten(treedef, g_new), key=next_key,
            step=state.step + 1)

    return train_step


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------

def abstract_state(model_cfg: ModelConfig, cfg: ByzTrainConfig, mesh=None):
    """The state on "meta" tensors (nothing allocated), for dry runs: the
    whole leaves, or with ``mesh`` this rank's held pieces of them
    (``held_specs``)."""
    params = init_params(0, model_cfg, device="meta")
    if mesh is not None:
        leaves, treedef = tree_flatten(params)
        held = tree_flatten(held_specs(mesh, model_cfg, params,
                                       cfg.shard_mode),
                            is_leaf=lambda x: isinstance(x, P))[0]
        params = tree_unflatten(treedef, [
            torch.empty(local_shape(mesh, x.shape, sp), dtype=x.dtype,
                        device="meta") for x, sp in zip(leaves, held)])
    return MeshTrainState(
        params=params,
        g=tree_map(torch.empty_like, params),
        key=torch.empty(train_key(cfg.seed).shape, dtype=torch.uint8,
                        device="meta"),
        step=torch.empty((), dtype=torch.int32, device="meta"))


def state_specs(mesh, model_cfg: ModelConfig, state, cfg: ByzTrainConfig):
    """The whole state's specs (``param_specs`` of the whole leaves, as
    the reference places its state).  ``state`` only gives the tree: a
    rank holds the pieces of ``held_specs`` (``abstract_state(...,
    mesh)``)."""
    ps = param_specs(mesh, model_cfg, init_params(0, model_cfg,
                                                  device="meta"),
                     mode=cfg.shard_mode)
    return MeshTrainState(params=ps, g=ps, key=P(), step=P())


# ---------------------------------------------------------------------------
# CLI launcher:  python -m repro_torch.launch.train --arch minitron_8b --smoke
# ---------------------------------------------------------------------------

class _ProcessGroup:
    """The default process group for ``main``: torchrun's (RANK,
    WORLD_SIZE, MASTER_ADDR in the environment), one already started,
    or a one-rank group of its own (NCCL on the card, gloo on the CPU)
    over a ``file://`` rendezvous in a temporary directory."""

    def __init__(self, dev: torch.device):
        self.dev, self.owned, self.tmp = dev, False, None

    def __enter__(self):
        import os
        import tempfile

        import torch.distributed as dist

        if dist.is_initialized():
            return self
        backend = "nccl" if self.dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if self.dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            self.tmp = tempfile.TemporaryDirectory()
            dist.init_process_group(
                backend, rank=0, world_size=1,
                init_method="file://" + os.path.join(self.tmp.name, "rdv"))
        self.owned = True
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if self.owned:
            dist.destroy_process_group()
        if self.tmp is not None:
            self.tmp.cleanup()
        return False


def main(argv=None):
    import argparse
    import time

    import torch.distributed as dist

    from .._device import resolve_device
    from ..configs.registry import get_config, get_smoke_config
    from ..data.pipeline import make_batch_iterator
    from .cli import (add_attack_args, add_plan_args, plan_from_args,
                      scenario_from_args)
    from .mesh import make_debug_mesh, make_production_mesh

    ap = argparse.ArgumentParser(description="Byz-VR-MARINA-PP mesh trainer")
    ap.add_argument("--arch", default="minitron_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + debug mesh (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--n-byz", type=int, default=1)
    ap.add_argument("--shard-mode", default="tp")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: NCCL, one rank per card) or "
                         "cpu (gloo, the plain PyTorch path)")
    add_plan_args(ap)
    add_attack_args(ap, attack="bf")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with _ProcessGroup(dev):
        world = dist.get_world_size()
        if args.smoke:
            model_cfg = get_smoke_config(args.arch).replace(
                dtype="float32", remat=False)
            mesh = make_debug_mesh(data=max(world // 2, 1),
                                   model=2 if world >= 2 else 1)
        else:
            model_cfg = get_config(args.arch)
            mesh = make_production_mesh(multi_pod=args.multi_pod)
        W = num_workers(mesh)
        scenario = scenario_from_args(args)
        n_byz = (scenario.n_byz(W) if scenario.byz_frac is not None
                 else args.n_byz)
        plan = plan_from_args(args, byz_bound=n_byz, clip_alpha=2.0)
        tc = ByzTrainConfig.from_plan(
            plan, gamma=args.gamma, n_byz=n_byz, attack=scenario.build(),
            shard_mode=args.shard_mode)
        lead = dist.get_rank() == 0
        if lead:
            print(f"[train] {model_cfg.name} on mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} ({W} "
                  f"workers, {tc.n_byz} byzantine, agg="
                  f"{plan.aggregate.rule}, model split "
                  f"{model_split(model_cfg, tc.shard_mode)}, device={dev})")
        step_fn = make_train_step(model_cfg, mesh, tc)
        it = make_batch_iterator(model_cfg, W * args.per_worker_batch,
                                 args.seq, device=dev)
        batch0 = next(it)
        state = initial_state(init_params(0, model_cfg, device=dev),
                              model_cfg, mesh, tc, batch0)
        t0 = time.time()
        for k in range(args.steps):
            state = step_fn(state, next(it))
            if k % 10 == 0 or k == args.steps - 1:
                loss = train_loss(state.params, model_cfg, batch0, mesh,
                                  tc.shard_mode)
                if lead:
                    print(f"[train] step {k:4d} loss {loss:.4f} "
                          f"({(time.time() - t0) / (k + 1):.2f}s/step)")
        if args.ckpt_dir:
            from ..checkpoint import save
            from ..models.model import gather_params

            whole = gather_params(state.params, mesh, model_cfg,
                                  tc.shard_mode)
            if lead:
                print("[train] checkpoint:", save(args.ckpt_dir, args.steps,
                                                  whole))


if __name__ == "__main__":
    main()
