"""Mesh execution of a built ServerPlan: the collective schedules, the
counterpart of ``repro.api.mesh_exec`` on ``torch.distributed``.

The port runs in manual SPMD, as the reference's ``shard_map`` body does:
every rank of the mesh calls the built ``ServerStep`` with plain local
tensors and gets back plain local tensors.  A rank's input is its piece
of the worker-stacked tree: along the leading worker dimension the rows
of its workers (the dimension split over the worker axes), and along each
other dimension what ``base_specs`` gives it (a ``P`` per leaf over the
unstacked dimensions; None: every leaf whole).  Its output is its piece
of the aggregated tree, per ``base_specs``, the same for both placements,
so that a trainer can swap one for the other.  ``mask`` (n,) and
Bucketing's ``key`` (a permutation) are the same on every rank.

  naive    the paper's parameter server: all-gather every worker's rows
           (and the coordinates of model-split dimensions) and aggregate
           the whole tree on every rank.  Bytes per rank ~ W |shard|.
  sharded  all_to_all the rows so that each rank holds all W rows of
           1/W of its coordinates, aggregate there, all-gather the
           result.  Bytes per rank ~ 2 |shard|.

Both give the same aggregation for the whole registry: the coordinate-wise
rules are exact on a block of coordinates, and the others (Krum,
CenteredClip, the Weiszfeld GM) all-reduce their row statistics over the
block's axes through ``reduce_fn``.  The iterative rules aggregate each
leaf (or superleaf chunk) on its own, as the reference does; the
selection rules (krum, multi_krum, plain or bucketed) are whole-tree: one
(W, W) Gram summed over the blocks, one selection, applied blockwise.
With ``radius`` every worker's message is clipped by its global tree
norm: the f32 sums of squares of its leaves, all-reduced over the axes
that split them, give the factors, which the kernels apply as they read
the rows; no clipped copy is formed.

``ScheduleSpec.blocks="pipelined"`` issues block i+1's all_to_all
(``async_op=True``) before block i's kernels run and waits on it before
using it; the ops are those of the sequential order, so the two are
bitwise equal.  ``superleaf_elems`` cuts the message into uniform chunks
per group of leaves split over the same axes.

The collectives run on ``mesh.get_group(axis)`` with the tensors as they
are (``all_to_all_single``, ``all_reduce``, ``all_gather_single`` or,
in older releases, ``all_gather_into_tensor``): NCCL on the card (one
rank per card) moves them card to card; gloo, on the CPU or with several
ranks on one card, stages every CUDA tensor through pinned host memory
(its CUDA path copies the tensor to the host, runs the collective over
TCP on the CPU and copies the result back), so on gloo a CUDA tensor
costs a collective on the host plus two copies.  ``collective_counts()``
gives the calls, the bytes each collective returned on this rank and its
route ("device": NCCL; "host": gloo on CUDA tensors, staged through the
host; "cpu": CPU tensors) since ``reset_collective_counts()``.  Over
an axis of one rank an all_to_all or an all-gather is the identity: the
tensor is returned as it is, with no collective and no copy, and is not
counted (the reductions of ``reduce_fn`` still run there).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.tree_utils import tree_flatten, tree_leaves, tree_superleaf_pack
from ..core.tree_utils import tree_unflatten
from ..kernels.clip_aggregate import clip_factor, row_ssq, row_ssq_plain
from ..launch.mesh import P, axis_size
from ..launch.mesh import worker_axes as _default_worker_axes
from .plan import PlanError, ScheduleSpec

__all__ = [
    "run_mesh_aggregate",
    "naive_aggregate",
    "leaf_agg_of",
    "mesh_worker_count",
    "schedule_map",
    "collective_counts",
    "reset_collective_counts",
]

_BIG = 3.4e37

# op -> [calls, bytes of the tensors it returned on this rank, routes]
_COLLECTIVES = {}
# all_gather_into_tensor took this name in newer releases of torch
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def collective_counts() -> dict:
    """op -> {"calls", "bytes", "route"} on this rank since the last reset
    ("route": the routes its calls took, joined by "+")."""
    return {op: {"calls": c, "bytes": b, "route": "+".join(sorted(r))}
            for op, (c, b, r) in _COLLECTIVES.items()}


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


def _route(out: torch.Tensor, group) -> str:
    if not out.is_cuda:
        return "cpu"
    return "device" if dist.get_backend(group) == "nccl" else "host"


def _count(op: str, out: torch.Tensor, group) -> None:
    c = _COLLECTIVES.setdefault(op, [0, 0, set()])
    c[0] += 1
    c[1] += out.numel() * out.element_size()
    c[2].add(_route(out, group))


def _all_to_all(x, mesh, axis, async_op: bool):
    """all_to_all over ``axis`` of the dim-0 chunks of contiguous ``x``:
    chunk j goes to the rank at coordinate j, and chunk j of the result
    came from it.  Returns (result, Work or None)."""
    if axis_size(mesh, axis) == 1:
        return x, None
    out, group = torch.empty_like(x), mesh.get_group(axis)
    work = dist.all_to_all_single(out, x, group=group, async_op=async_op)
    _count("all_to_all", out, group)
    return out, work


def _all_gather(x, mesh, axis, dim: int = 0):
    """The pieces of ``x`` of the ranks along ``axis``, concatenated along
    ``dim`` in coordinate order."""
    if axis_size(mesh, axis) == 1:
        return x
    group = mesh.get_group(axis)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((dist.get_world_size(group) * xt.shape[0],
                       *xt.shape[1:]), dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, xt, group=group)
    _count("all_gather", out, group)
    return out.movedim(0, dim)


def _psum_reduce(mesh, axes: tuple):
    """``reduce_fn`` of a block: the sum over the ranks along ``axes`` of
    a COPY of its argument (one all_reduce per axis), so it never writes
    into a tensor that a kernel still reads."""
    if not axes:
        return None

    def reduce_fn(t):
        out = t.clone()
        for ax in axes:
            group = mesh.get_group(ax)
            dist.all_reduce(out, group=group)
            _count("all_reduce", out, group)
        return out

    return reduce_fn


def mesh_worker_count(mesh, worker_axes_override: tuple = ()) -> int:
    """Number of workers the plan's worker axes enumerate on ``mesh``."""
    waxes = tuple(worker_axes_override) or _default_worker_axes(mesh)
    W = 1
    for a in waxes:
        W *= axis_size(mesh, a)
    return W


def leaf_agg_of(agg):
    """Aggregation over the worker axis of one (W, ...) leaf: flattens to
    the kernels' (n, d) shape; with ``factors`` it runs the fused
    ``Aggregator.clip_then_aggregate`` (no clipped matrix)."""

    def leaf_agg(leaf, mask, key, factors=None, reduce_fn=None):
        mat = leaf.reshape(leaf.shape[0], -1)
        if factors is None:
            out = agg(mat, mask=mask, key=key, reduce_fn=reduce_fn)
        else:
            out = agg.clip_then_aggregate(mat, _BIG, mask=mask, key=key,
                                          factors=factors,
                                          reduce_fn=reduce_fn)
        return out.reshape(leaf.shape[1:])

    return leaf_agg


def _entry_axes(entry) -> tuple:
    """Mesh axes one entry of a P splits its dimension over."""
    if isinstance(entry, (tuple, list)):
        return tuple(a for a in entry if a is not None)
    return () if entry is None else (entry,)


def _spec_axes(spec) -> tuple:
    """Mesh axes a P splits over (flattened, major first)."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def schedule_map(produce, consume, n, pipelined: bool):
    """``outs[i] = consume(i, produce(i))`` over ``n`` blocks.

    ``pipelined=False``: strictly in order.  ``pipelined=True``: the
    two-stage software pipeline: produce(0) first, then produce(i+1) is
    issued BEFORE consume(i), so that block i+1's collective is in flight
    while block i's kernels run.  Both orders issue the same per-block
    ops, so their results are bitwise equal."""
    if n == 0:
        return []
    if not pipelined or n == 1:
        return [consume(i, produce(i)) for i in range(n)]
    outs = []
    pending = produce(0)
    for i in range(n):
        cur = pending
        if i + 1 < n:
            pending = produce(i + 1)
        outs.append(consume(i, cur))
    return outs


def _row_ssq(leaves, agg, specs=None, mesh=None) -> torch.Tensor:
    """(n,) f32 sums of squares of each row's whole message: each leaf's
    (pass 1, ``row_ssq``, or its plain version where ``agg`` runs no
    kernels), all-reduced over the axes that split it when ``specs`` are
    given, added in flatten order."""
    total = None
    for i, leaf in enumerate(leaves):
        if leaf[0].numel() == 0:
            continue
        mat = leaf.reshape(leaf.shape[0], -1)
        part = (row_ssq if agg.uses_kernels(mat) else row_ssq_plain)(mat)
        if specs is not None:
            reduce_fn = _psum_reduce(mesh, _spec_axes(specs[i]))
            part = part if reduce_fn is None else reduce_fn(part)
        total = part if total is None else total + part
    return total


def naive_aggregate(tree_w, mask, key, *, agg, chunk_elems: int = 0,
                    factors=None):
    """The naive placement on the whole worker-stacked tree in one
    process: per leaf (or per superleaf chunk), the selection rules
    whole-tree.  ``factors`` (n,) clips each row by them (None: no
    clip)."""
    leaf_agg = leaf_agg_of(agg)
    if chunk_elems > 0:
        chunks, _, unpack = tree_superleaf_pack(tree_w, chunk_elems)
        if agg.supports_two_phase:
            stats = agg.accumulate_stats(chunks)
            sel = agg.finalize(stats, mask=mask, key=key, factors=factors)
            rows = agg.apply_selection(chunks, sel)
        else:
            rows = [leaf_agg(c, mask, key, factors=factors) for c in chunks]
        return unpack(rows)
    leaves, treedef = tree_flatten(tree_w)
    if agg.supports_two_phase:
        mats = [leaf.reshape(leaf.shape[0], -1) for leaf in leaves]
        stats = agg.accumulate_stats(mats)
        sel = agg.finalize(stats, mask=mask, key=key, factors=factors)
        outs = [agg.apply_selection(mat, sel).reshape(leaf.shape[1:])
                for mat, leaf in zip(mats, leaves)]
    else:
        outs = [leaf_agg(leaf, mask, key, factors=factors)
                for leaf in leaves]
    return tree_unflatten(treedef, outs)


def _gather_leaf(leaf, spec, mesh, waxes):
    """A rank's (rows, *shard) piece -> the whole (n, *shape) leaf."""
    for j, entry in enumerate(spec):
        for ax in reversed(_entry_axes(entry)):
            leaf = _all_gather(leaf, mesh, ax, dim=j + 1)
    for ax in reversed(waxes):
        leaf = _all_gather(leaf, mesh, ax, dim=0)
    return leaf


def _local_piece(out, spec, mesh):
    """This rank's piece of a whole aggregated leaf, per ``spec``."""
    for j, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        idx, parts = 0, 1
        for ax in axes:  # the first axis major
            size = axis_size(mesh, ax)
            idx = idx * size + mesh.get_local_rank(ax)
            parts *= size
        width = out.shape[j] // parts
        out = out.narrow(j, idx * width, width)
    return out.contiguous()


def _spec_leaves(base_specs, leaves) -> list:
    if base_specs is None:
        return [P(*([None] * (leaf.ndim - 1))) for leaf in leaves]
    specs = tree_leaves(base_specs, is_leaf=lambda x: isinstance(x, P))
    if len(specs) != len(leaves):
        raise PlanError(f"base_specs has {len(specs)} leaves, the message "
                        f"{len(leaves)}")
    for sp, leaf in zip(specs, leaves):
        if len(sp) > leaf.ndim - 1:
            raise PlanError(f"base spec {sp} has more entries than the "
                            f"leaf's {leaf.ndim - 1} unstacked dimensions")
    return [P(*sp, *([None] * (leaf.ndim - 1 - len(sp))))
            for sp, leaf in zip(specs, leaves)]


def run_mesh_aggregate(tree_w, mask, key, *, mesh, agg, spec: ScheduleSpec,
                       base_specs=None, radius=None):
    """Aggregate this rank's piece of a worker-stacked tree (module
    docstring) under ``spec`` on ``mesh``; returns this rank's piece of
    the aggregated tree.  ``agg`` is the plan's ``Aggregator``;
    ``radius``, when set, clips every worker's message at that radius by
    its global tree norm."""
    leaf_agg = leaf_agg_of(agg)
    two_phase = agg.supports_two_phase
    pipelined = spec.blocks == "pipelined"
    chunk_elems = int(spec.superleaf_elems)
    waxes = tuple(spec.worker_axes) or _default_worker_axes(mesh)
    W = mesh_worker_count(mesh, spec.worker_axes)
    leaves, treedef = tree_flatten(tree_w)
    specs = _spec_leaves(base_specs, leaves)
    n_rows = leaves[0].shape[0] * W
    use_factors = radius is not None

    if spec.placement == "naive" or not waxes:
        full = [_gather_leaf(leaf, sp, mesh, waxes)
                for leaf, sp in zip(leaves, specs)]
        factors = None
        if use_factors:
            factors = clip_factor(torch.sqrt(_row_ssq(full, agg)),
                                  radius).float()
        outs = tree_leaves(naive_aggregate(
            tree_unflatten(treedef, full), mask, key, agg=agg,
            chunk_elems=chunk_elems, factors=factors))
        return tree_unflatten(treedef, [_local_piece(o, sp, mesh)
                                        for o, sp in zip(outs, specs)])

    if leaves[0].shape[0] != 1:
        # one row per rank along the worker axes: more would be dropped
        # (or duplicated) by the per-rank scatter
        raise PlanError(
            f"sharded robust aggregation needs one row per worker: leaves "
            f"carry {n_rows} rows but the mesh enumerates {W} workers "
            f"over {waxes}")

    # each block's coordinates are spread over the worker axes (the
    # all_to_all chunks) and the axes its spec splits: a sum over exactly
    # those gives the rules their global row statistics
    stat_axes = [tuple(waxes) + _spec_axes(sp) for sp in specs]
    factors = None
    if use_factors:  # this rank's worker's, then all W in worker order
        ssq = _row_ssq(leaves, agg, specs, mesh)
        factors = clip_factor(torch.sqrt(ssq), radius).float()
        for ax in reversed(waxes):
            factors = _all_gather(factors, mesh, ax)
    if chunk_elems > 0:
        packed, block_axes, unpack = tree_superleaf_pack(
            tree_w, chunk_elems, group_ids=stat_axes)
        flats = [p[0] for p in packed]  # this rank's (chunk,) vectors
        shapes = None
    else:
        flats = [leaf[0].reshape(-1) for leaf in leaves]
        block_axes = stat_axes
        shapes = [leaf.shape[1:] for leaf in leaves]
        unpack = None
    sizes = [fl.shape[0] for fl in flats]
    pads = [(-s) % W for s in sizes]

    w_sizes = [axis_size(mesh, ax) for ax in waxes]

    def scatter(i):
        """This rank's flat block i -> the (W, size/W) block of all W
        rows (the kernels' input), as (tensor, Work or None)."""
        flat = flats[i]
        if pads[i]:
            flat = F.pad(flat, (0, pads[i]))
        # chunk k of the block, k the worker index of the rank that gets
        # it, at [k_1, ..., k_m] over the worker axes; each all_to_all
        # swaps one axis's chunk index for its sender's coordinate, so
        # that every rank ends with its own chunk of every worker's row
        sw, work = flat.reshape(*w_sizes, -1), None
        for a, ax in enumerate(waxes):  # over each worker axis in turn
            if work is not None:
                work.wait()
            sw, work = _all_to_all(sw.movedim(a, 0).contiguous(), mesh, ax,
                                   pipelined)
            sw = sw.movedim(0, a)
        return sw, work

    def ready(pending):
        sw, work = pending
        if work is not None:
            work.wait()
        return sw.reshape(W, -1)  # the rows in worker order

    def gather(aggd, i):
        out = aggd
        for ax in reversed(waxes):
            out = _all_gather(out, mesh, ax)
        return out[:sizes[i]] if pads[i] else out

    if two_phase:
        # whole-tree selection: ONE (W, W) Gram summed over the blocks
        # (each reduced over its own axes), one selection, applied
        # blockwise
        scat = []

        def consume_gram(i, pending):
            scat.append(ready(pending))
            return agg.accumulate_stats(
                scat[-1], reduce_fn=_psum_reduce(mesh, block_axes[i]))

        grams = schedule_map(scatter, consume_gram, len(flats), pipelined)
        stats = grams[0]
        for g in grams[1:]:
            stats = stats + g
        sel = agg.finalize(stats, mask=mask, key=key, factors=factors)
        rows = schedule_map(
            lambda i: agg.apply_selection(scat[i], sel),
            lambda i, applied: gather(applied, i),
            len(flats), pipelined)
    else:
        def consume_agg(i, pending):
            aggd = leaf_agg(ready(pending), mask, key, factors=factors,
                            reduce_fn=_psum_reduce(mesh, block_axes[i]))
            return gather(aggd, i)

        rows = schedule_map(scatter, consume_agg, len(flats), pipelined)

    if unpack is not None:
        return unpack(rows)
    return tree_unflatten(treedef, [r.reshape(shp)
                                    for r, shp in zip(rows, shapes)])
