"""Megatron's tensor-parallel split along the mesh's "model" axis, for the
decoders on token inputs (GQA, MHA or MLA attention, the cross-attention
to vision tokens, the Mamba-2 mixer, the SwiGLU MLP, the MoE layer, the
token embedding and the unembedding).

The reference's GSPMD splits each worker's forward and backward pass
over "model" from ``param_specs`` and the activation constraints; here
the split is written out.  Each rank of the axis holds its piece of a
split leaf (``sharding.rules.held_specs``) and computes with it:

* a **column split** (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``:
  output dim) takes the replicated activation through
  :func:`copy_to_model` (identity forward, all-reduce of the gradient
  backward, Megatron's f);
* a **row split** (``wo``, ``w_down``: input dim) is followed by
  :func:`reduce_from_model` (all-reduce forward, identity backward,
  Megatron's g);
* a column split whose **whole output** every rank needs (MLA's latents
  ahead of their norms, the MTP head's projection) is followed by
  :func:`gather_replicated` (all-gather forward; backward, this rank's
  piece of a gradient that is already the same on every rank), and the
  whole result enters the split again through :func:`copy_to_model`;
* the **cross-attention** (``models.layers.cross_attn_forward``) is
  the attention's split with the vision tokens, replicated on the axis,
  as the keys' and values' source (their own :func:`copy_to_model`);
  its gate scales the sum that :func:`reduce_from_model` gives, so that
  the gate's gradient is whole on every rank, as a norm's is;
* the **MoE layer** routes on the replicated tokens, outside the split,
  and each rank runs its own block of experts on the tokens routed to
  them: the dispatched tokens and the gates enter through
  :func:`copy_to_model`, the partial combine leaves through
  :func:`reduce_from_model` (``models.moe``);
* the **Mamba-2 mixer** (``models.ssm``) runs this rank's block of heads
  of the chunked scan: the columns of ``in_proj`` and the channels of
  ``conv_w`` it computes cut across the packed z | x | B | C | dt parts
  and its held pieces, so each leaf comes whole once a layer
  (:func:`take` over its whole range: gathered, or copied in) and the
  rank's parts are cut from it; B and C, which every head reads, are
  computed alike on every rank, and their gradients summed over the axis
  by that gather's backward; the gated norm over the inner width sums the
  ranks' partial sums of squares with :func:`sum_over_model` (an
  all-reduce forward and backward); ``out_proj`` is row-split;
* the **embedding** is split on the vocabulary:
  :func:`vocab_parallel_embed` looks up the tokens of this rank's rows,
  zeroes the others and all-reduces;
* the **unembedding** is split on the vocabulary:
  :func:`vocab_parallel_ce` is the cross-entropy over the split logits
  (the max and the sum of exponentials all-reduced over "model", the gold
  logit from the rank that holds it), the same loss on every rank; the
  serving steps gather the split logits whole (:func:`gather_replicated`);
* a **decode step** holds the cache's length split over the axis
  (``sharding.rules.cache_specs``): each rank attends over its block of
  positions and the softmax is merged across the axis, the maxima by
  :func:`max_over_model` and the partial sums by
  :func:`reduce_from_model` (``models.layers``); the Mamba-2 step holds
  its heads of the recurrent state (``models.ssm``).

``param_specs`` also splits the stacked layer dimension of the dense
MLP's leaves (the reference's rules take a stacked ``w_gate``/``w_up``/
``w_down`` of rank 3 for an expert stack) when the axis divides the
number of layers: a rank then holds whole layers of them.  Each layer's
weights come from the rank that holds them (:class:`LayerSlice`: a
broadcast forward, the gradient reduced to that rank backward), and the
hidden dimension is split as above.

A leaf that ``param_specs`` leaves whole (a dimension the axis does not
divide) is used through :func:`take`, which narrows it to this rank's
range and all-reduces its gradient; a piece that does not cover the range
a rank computes (fewer kv heads than ranks: half a head a piece) is
all-gathered first (:func:`gather_from_model`, whose backward all-reduces
the gradient and keeps this rank's piece).  Norms, scalars and the
residual stream stay whole and are computed alike on every rank, so their
gradients are the same on every rank.

Under fsdp_tp a rank holds its pieces split over "data" as well
(``held_specs``).  Each leaf comes whole over "data" just before use
(:func:`gather_from_data`: an all-gather forward), inside the period
loop's step, a layer at a time, so that under remat it runs again in the
recompute and no layer's weights outlive their layer; it gives back the
"model" piece that everything above reads.  Its backward depends on
what "data" is in the pass (``DataAxis.grad``): a worker axis keeps the
worker's gradient of the gathered leaf whole over "data" (written to the
leaf's sink, no collective: the reference's per-worker gradient); rows
split over "data" are summed by a reduce-scatter that leaves each rank
its piece; rows that every rank has are narrowed to the piece.  With
rows split, the sums over rows that the loss couples (the cross-entropy's
count, the MoE routing's means, capacity and slots) add up the axis's
ranks (:func:`reduce_from_data`, ``models.moe.route``).

With ``axis=None`` :func:`copy_to_model`, :func:`reduce_from_model`,
:func:`sum_over_model` and :func:`take` act on the whole tensors as
identities (``take`` narrows), so that one body runs a layer whole or
split.  Every function has a plain one-process twin (``*_plain``: the
whole computation on the whole tensors; ``sum_over_model``'s is
``reduce_from_model_plain``), against which the split is checked.
Collectives are counted in ``api.mesh_exec.collective_counts()``,
recomputed ones (activation checkpointing) included.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.constraints import DataAxis, ModelAxis

__all__ = [
    "split_range",
    "split_on",
    "copy_to_model",
    "reduce_from_model",
    "sum_over_model",
    "max_over_model",
    "gather_from_model",
    "gather_replicated",
    "take",
    "LayerSlice",
    "DataSlice",
    "gather_from_data",
    "gather_from_data_values",
    "reduce_from_data",
    "vocab_parallel_embed",
    "vocab_parallel_ce",
    "copy_to_model_plain",
    "reduce_from_model_plain",
    "gather_from_model_plain",
    "vocab_parallel_embed_plain",
    "vocab_parallel_ce_plain",
]


def _count(op: str, out: torch.Tensor, group) -> None:
    from repro_torch.api.mesh_exec import _count as count

    count(op, out, group)


def _all_reduce(x: torch.Tensor, axis: ModelAxis, op=dist.ReduceOp.SUM):
    """The reduction over the axis of a contiguous copy of ``x``."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=axis.group)
    _count("all_reduce", out, axis.group)
    return out


def split_range(n: int, axis: ModelAxis) -> tuple:
    """This rank's range [lo, hi) of a dimension of size ``n``: equal
    blocks in coordinate order (as ``param_specs`` splits) when the axis
    divides ``n``, else the nearest integer bounds."""
    return axis.rank * n // axis.size, (axis.rank + 1) * n // axis.size


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((axis.size * xt.shape[0], *xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        from repro_torch.api.mesh_exec import _ALL_GATHER

        _ALL_GATHER(out, xt, group=axis.group)
        _count("all_gather", out, axis.group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        whole = _all_reduce(grad, ctx.axis)
        return (whole.narrow(ctx.dim, ctx.axis.rank * ctx.width, ctx.width),
                None, None)


class _GatherReplicated(_GatherFromModel):
    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.axis.rank * ctx.width, ctx.width),
                None, None)


def copy_to_model(x, axis: ModelAxis):
    """``x`` (replicated on the axis) entering a split region: identity
    forward, the gradient summed over the axis backward (``x`` itself
    when ``axis`` is None)."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x, axis: ModelAxis):
    """The sum over the axis of the ranks' partial ``x`` (a row split's
    product): all-reduce forward, identity backward (``x`` itself when
    ``axis`` is None)."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def sum_over_model(x, axis: ModelAxis):
    """The sum over the axis of the ranks' partial ``x`` (a partial sum of
    squares) that every rank then uses inside the split: all-reduce
    forward, and all-reduce of the gradient backward, since each rank's
    use of the sum contributes a part of its gradient
    (``copy_to_model`` of ``reduce_from_model``; ``x`` itself when
    ``axis`` is None)."""
    return copy_to_model(reduce_from_model(x, axis), axis)


def max_over_model(x, axis: ModelAxis):
    """The elementwise max over the axis of the ranks' ``x``: one
    all-reduce, for values that carry no gradient (the decode step's
    score maxima; ``x`` itself when ``axis`` is None)."""
    return x if axis is None else _all_reduce(x.detach(), axis,
                                              dist.ReduceOp.MAX)


def gather_from_model(x, axis: ModelAxis, dim: int):
    """The ranks' pieces of ``x`` concatenated along ``dim`` in coordinate
    order; backward, the gradient summed over the axis, this rank's piece
    kept."""
    return _GatherFromModel.apply(x, axis, dim)


def gather_replicated(x, axis: ModelAxis, dim: int):
    """The ranks' pieces of ``x`` concatenated along ``dim``, a whole
    tensor that every rank then computes with alike (outside the split,
    until it enters it again through :func:`copy_to_model`); backward,
    this rank's piece of the gradient, which is the same on every rank,
    with no collective."""
    return _GatherReplicated.apply(x, axis, dim)


class _FromOwner(torch.autograd.Function):
    """A layer's weights from the rank that holds them: broadcast forward;
    backward, the ranks' gradients summed on that rank (the others get
    zeros for their anchor)."""

    @staticmethod
    def forward(ctx, local, owner, axis):
        ctx.owner, ctx.axis = owner, axis
        src = dist.get_global_rank(axis.group, owner)
        # contiguous on every rank: a gathered piece may be a strided view
        buf = (local.contiguous().clone() if axis.rank == owner
               else torch.empty(local.shape, dtype=local.dtype,
                                device=local.device))
        dist.broadcast(buf, src=src, group=axis.group)
        _count("broadcast", buf, axis.group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        out = grad.contiguous().clone()
        dist.reduce(out, dst=dist.get_global_rank(axis.group, ctx.owner),
                    group=axis.group)
        _count("reduce", out, axis.group)
        if axis.rank != ctx.owner:
            out = torch.zeros_like(out)
        return out, None, None


class LayerSlice:
    """Layer i of a stacked leaf whose layer dimension is split over the
    axis: ``local`` is this rank's slice of it when this rank is
    ``owner``, else any slice of the same shape of its own piece (an
    anchor that carries the backward pass).  :meth:`whole` gives the
    layer's weights on every rank."""

    def __init__(self, local, owner: int):
        self.local, self.owner = local, owner

    def whole(self, axis: ModelAxis):
        return _FromOwner.apply(self.local, self.owner, axis)


def _reduce_scatter(out, x, group):
    """The sum over ``group`` of its ranks' ``x``, each rank's block of
    dim 0 into ``out``: ``torch.distributed.reduce_scatter_tensor``.  A
    release without it raises: the split has no other route to the sum."""
    if not hasattr(dist, "reduce_scatter_tensor"):
        raise RuntimeError(
            f"torch {torch.__version__} offers no reduce_scatter_tensor: "
            "fsdp_tp's rows split over \"data\" need it")
    dist.reduce_scatter_tensor(out, x, group=group)
    _count("reduce_scatter", x, group)


def _gather_dim0(x, data: DataAxis):
    """Every "data" rank's ``x`` concatenated along dim 0 in coordinate
    order: one all-gather, counted."""
    from repro_torch.api.mesh_exec import _ALL_GATHER

    xt = x.contiguous()
    out = torch.empty((data.size * xt.shape[0], *xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    _ALL_GATHER(out, xt, group=data.group)
    _count("all_gather", out, data.group)
    return out


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, data, dim, sink):
        ctx.data, ctx.dim, ctx.width, ctx.sink = (data, dim, piece.shape[dim],
                                                  sink)
        return _gather_dim0(piece.movedim(dim, 0), data).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        data, dim, width = ctx.data, ctx.dim, ctx.width
        mode = data.grad
        if mode == "keep":
            if ctx.sink is None:
                raise RuntimeError("the gradient of a leaf gathered over a "
                                   "worker axis \"data\" needs its sink")
            ctx.sink.add_(grad)
            return None, None, None, None
        if mode == "narrow":
            return (grad.narrow(dim, data.rank * width, width), None, None,
                    None)
        gt = grad.movedim(dim, 0).contiguous()
        out = torch.empty((width, *gt.shape[1:]), dtype=grad.dtype,
                          device=grad.device)
        _reduce_scatter(out, gt, data.group)
        return out.movedim(0, dim), None, None, None


def gather_from_data(piece, data: DataAxis, dim: int, sink=None):
    """The ranks' pieces of a held leaf concatenated along ``dim`` over
    "data", in coordinate order: the leaf whole over "data".  Backward,
    per ``data.grad``: "keep" adds the gradient to ``sink`` (a buffer of
    the gathered shape) and gives the piece none; "reduce_scatter" sums
    the ranks' gradients and keeps this rank's piece; "narrow" keeps this
    rank's piece of its own."""
    return _GatherFromData.apply(piece, data, dim, sink)


def reduce_from_data(x, data: DataAxis):
    """The sum over "data" of the ranks' partial ``x`` (a sum over their
    rows): all-reduce forward, identity backward, so that each rank's
    gradient is its rows' part (``x`` itself when ``data`` is None)."""
    return x if data is None else _ReduceFromModel.apply(x, data)


def gather_from_data_values(x, data: DataAxis):
    """Every "data" rank's ``x`` stacked along a new dim 0 in coordinate
    order: an all-gather of values that carry no gradient (the MoE
    routing's per-choice counts)."""
    xt = x.detach()
    return _gather_dim0(xt, data).view(data.size, *xt.shape)


class DataSlice:
    """A leaf of a layer whose held piece is split over "data": ``piece``
    (a view of the stacked leaf), the dimension ``dim`` it is split on and
    the ``sink`` of its gradient (a view of the same layer of the sink, or
    None); :meth:`whole` gathers it."""

    def __init__(self, piece, dim: int, sink=None):
        self.piece, self.dim, self.sink = piece, dim, sink

    def whole(self, data: DataAxis):
        return gather_from_data(self.piece, data, self.dim, self.sink)


def split_on(spec, dim: int):
    """The entry of a held spec (``sharding.rules.held_specs``) for
    ``dim``: "model" where the leaf is split on it, else None (a ``P``
    leaves its trailing whole dims out)."""
    return spec[dim] if dim < len(spec) else None


def take(w, dim: int, spec, lo: int, hi: int, axis: ModelAxis):
    """Entries [lo, hi) along ``dim`` of a held leaf, ``spec`` its held
    spec (``split_on``): a piece that covers them
    is narrowed; a piece that does not is all-gathered first; a whole leaf
    (one ``param_specs`` does not split) is narrowed with its gradient
    summed over the axis, since every rank uses it for a part of the
    product; a :class:`LayerSlice` is fetched from its owner, whose
    backward sums the gradient there.  With ``axis`` None, ``w`` is whole:
    it is narrowed (``w`` itself for its whole range)."""
    if axis is None:
        return w if (lo, hi) == (0, w.shape[dim]) else w.narrow(dim, lo,
                                                                 hi - lo)
    if isinstance(w, LayerSlice):
        return w.whole(axis).narrow(dim, lo, hi - lo)
    if split_on(spec, dim) is None:
        return copy_to_model(w, axis).narrow(dim, lo, hi - lo)
    held = w.shape[dim]
    start = axis.rank * held
    if start == lo and hi == start + held:
        return w  # the piece itself (a narrow's backward would copy it)
    if start <= lo and hi <= start + held:
        return w.narrow(dim, lo - start, hi - lo)
    return gather_from_model(w, axis, dim).narrow(dim, lo, hi - lo)


def vocab_parallel_embed(piece, tokens, axis: ModelAxis):
    """The rows of ``tokens`` in the embedding whose vocabulary rows this
    rank holds (``piece``: rows [r * V/M, (r+1) * V/M)): the tokens out of
    that range look up nothing (zeros), and the all-reduce over the axis
    puts every token's row together, the same on every rank."""
    rows = piece.shape[0]
    local = tokens.long() - axis.rank * rows
    inside = (local >= 0) & (local < rows)
    looked = piece[local.clamp(0, rows - 1)]
    looked = torch.where(inside[..., None], looked,
                         torch.zeros((), dtype=piece.dtype,
                                     device=piece.device))
    return reduce_from_model(looked, axis)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, axis):
        cols = logits.shape[-1]
        local = target.long() - axis.rank * cols
        inside = (local >= 0) & (local < cols)
        local = local.clamp(0, cols - 1)
        m = _all_reduce(logits.amax(dim=-1), axis, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        gold = torch.gather(logits, -1, local[..., None])[..., 0]
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        # the sum of exponentials and the gold logit in one all-reduce
        sums = _all_reduce(torch.stack([e.sum(dim=-1), gold]), axis)
        ctx.axis = axis
        ctx.save_for_backward(e.div_(sums[0][..., None]), local, inside)
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(ctx, grad):
        soft, local, inside = ctx.saved_tensors
        out = soft * grad[..., None]
        out.scatter_add_(-1, local[..., None],
                         -(grad * inside.to(grad.dtype))[..., None])
        return out, None, None


def vocab_parallel_ce(logits, target, axis: ModelAxis):
    """Per-position -log softmax(logits)[target] over the whole
    vocabulary, from this rank's columns ``logits`` (..., V/M) (columns
    [r * V/M, (r+1) * V/M)); the same values on every rank."""
    return _VocabParallelCE.apply(logits, target, axis)


# ---------------------------------------------------------------------------
# plain one-process twins: the whole computation
# ---------------------------------------------------------------------------

def copy_to_model_plain(x):
    return x


def reduce_from_model_plain(parts):
    """The sum of every rank's partial tensor."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gather_from_model_plain(pieces, dim: int):
    return torch.cat(list(pieces), dim=dim)


def vocab_parallel_embed_plain(embed, tokens):
    return embed[tokens.long()]


def vocab_parallel_ce_plain(logits, target):
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, target.long()[..., None])[..., 0]
