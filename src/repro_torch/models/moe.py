"""Mixture-of-Experts layer, the counterpart of ``repro.models.moe``:
top-k routing with capacity-bounded scatter dispatch, shared experts
(DeepSeek-V3) and a parallel dense residual (Arctic).

  1. router logits -> top-k (expert_id, gate) per token; ties go to the
     lower expert index, as ``jax.lax.top_k`` breaks them (a stable
     descending sort: ``torch.topk`` promises no order on ties)
  2. position of each (token, choice) inside its expert's buffer via an
     exclusive cumulative count over the one-hot routing matrix, the K
     choices placed one after another on top of the running counts
  3. scatter tokens into (E, capacity, D) buffers — tokens over capacity
     are dropped (standard capacity-factor semantics) into a trash row
  4. batched expert SwiGLU (E, cap, D) x (E, D, F), in f32 products of
     upcast operands, a group of experts at a time so that the f32
     copies of the weights stay bounded (``_ExpertFFN``)
  5. gather back and combine weighted by the (renormalized) gates.

Aux losses: switch-style load-balance loss + router z-loss.

Under the tensor-parallel split (``tp``, ``models.tp``) the expert stacks
are split over "model" (``param_specs``: rank r holds experts
[r E/M, (r+1) E/M)) and the tokens are not: every rank has every token,
so the split needs no all_to_all.  The routing runs on the replicated
tokens, outside the split, the same on every rank (its capacity and
slots are the whole layer's, so the dropped choices are too); the
dispatched tokens and the gates enter the split through
``copy_to_model``; each rank scatters the choices routed to its own
experts into its own buffers, runs them, and combines those choices; the
shared experts' row-split partial joins that combine, and one
``reduce_from_model`` sums the ranks' partials.  An expert stack that
``param_specs`` leaves whole (the axis does not divide E) is narrowed to
the rank's ``split_range`` through ``take``; a rank with no expert adds a
zero partial and runs the same collectives.

With the worker's rows split over an axis (``rows``: "data" under
fsdp_tp with pod workers, "model" under zero3; ``ModelAxis.rows_axis``),
the routing's sums over tokens are the worker's: the load-balance means
and the z-loss add up the axis's ranks' sums (``tp.reduce_from_data``),
the capacity is that of the worker's T tokens, and each (token,
choice)'s slot counts the earlier ranks' tokens through an exclusive
prefix of their per-choice counts, so that the choices dropped are
exactly those of the whole batch.  Each rank then scatters its own
tokens into its experts' buffers at those slots: the buffers stay the
worker's capacity (the reference's buffers are replicated over the axis
too).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.constraints import maybe_constrain
from . import tp as tp_mod
from .layers import F32, Draw, dense_init, swiglu_partial

__all__ = ["init_moe", "moe_forward", "MoEOutput", "route", "top_k",
           "count_drops", "record_routing"]

_TALLIES: list = []  # the open tallies of ``count_drops``
_ROUTINGS: list = []  # the open [log, pins, passes] of ``record_routing``


class MoEOutput(NamedTuple):
    out: torch.Tensor
    lb_loss: torch.Tensor  # load-balance aux
    z_loss: torch.Tensor


def init_moe(rng: Draw, cfg, dtype):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    params = {
        "router": dense_init(rng, d, e, F32),  # router kept f32
        "w_gate": rng.normal((e, d, f), dtype, 1.0 / math.sqrt(d)),
        "w_up": rng.normal((e, d, f), dtype, 1.0 / math.sqrt(d)),
        "w_down": rng.normal((e, f, d), dtype, 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": dense_init(rng, d, fs, dtype),
            "w_up": dense_init(rng, d, fs, dtype),
            "w_down": dense_init(rng, fs, d, dtype, scale=1.0 / math.sqrt(fs)),
        }
    return params


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    in descending order, equal values by ascending index."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


# the f32 copies of the expert weights that one group of experts takes at
# once (the products are f32 products of upcast bf16 operands)
_GROUP_BYTES = 1 << 29
_EXPERTS = ("w_gate", "w_up", "w_down")


def _ffn(x, wg, wu, wd):
    """x: (e, cap, D) -> (e, cap, D), SwiGLU over e experts, in f32
    products (f64 ones for f64 operands)."""
    up = torch.promote_types(x.dtype, F32)
    x32 = x.to(up)
    g = torch.einsum("ecd,edf->ecf", x32, wg.to(up))
    u = torch.einsum("ecd,edf->ecf", x32, wu.to(up))
    h = (F.silu(g) * u).to(x.dtype)
    h = maybe_constrain(h, "expert", None, None)
    return torch.einsum("ecf,efd->ecd", h.to(up), wd.to(up)).to(x.dtype)


class _ExpertFFN(torch.autograd.Function):
    """The experts' SwiGLU on the flat buffer ``buf`` (n * cap + 1, D):
    expert-major slots of ``cap`` rows, then one trash row, whose output
    is 0.  ``_ffn`` runs one group of ``group`` experts at a time, so
    that the f32 copies of the weights exist for one group only; the
    backward pass saves the weights as they are (no f32 copy) and
    recomputes each group's forward before its gradient, so that each
    expert's products are ``_ffn``'s."""

    @staticmethod
    def forward(ctx, buf, wg, wu, wd, cap, group):
        ctx.save_for_backward(buf, wg, wu, wd)
        ctx.cap, ctx.group = cap, group
        out = torch.empty_like(buf)
        out[-1] = 0
        for a, b in _groups(wg.shape[0], group):
            rows = slice(a * cap, b * cap)
            x = buf[rows].view(b - a, cap, buf.shape[1])
            out[rows] = _ffn(x, wg[a:b], wu[a:b], wd[a:b]).flatten(0, 1)
        return out

    @staticmethod
    def backward(ctx, grad):
        buf, *ws = ctx.saved_tensors
        cap, D = ctx.cap, buf.shape[1]
        need = ctx.needs_input_grad[:4]
        outs = [torch.empty_like(t) if n else None
                for t, n in zip((buf, *ws), need)]
        if need[0]:
            outs[0][-1] = 0  # the trash row's
        for a, b in _groups(ws[0].shape[0], ctx.group):
            rows = slice(a * cap, b * cap)
            with torch.enable_grad():
                part = [t.detach().requires_grad_(n) for t, n in zip(
                    (buf[rows].view(b - a, cap, D), *(w[a:b] for w in ws)),
                    need)]
                got = iter(torch.autograd.grad(
                    _ffn(*part), [t for t in part if t.requires_grad],
                    grad[rows].view_as(part[0])))
            for out, at in zip(outs, (rows, *[slice(a, b)] * 3)):
                if out is not None:
                    out[at] = next(got).reshape(out[at].shape)
        return (*outs, None, None)


def _groups(n: int, group: int):
    return [(a, min(a + group, n)) for a in range(0, n, group)]


def _expert_ffn(w, buf, cap: int):
    """``buf`` (n * cap + 1, D) -> (n * cap + 1, D): the SwiGLU of the n
    experts ``w`` (leaves (n, D, F), (n, D, F), (n, F, D)) on their slots,
    0 on the trash row; a group of experts takes at most ``_GROUP_BYTES``
    of f32 weights at once."""
    per = 4 * sum(math.prod(w[k].shape[1:]) for k in _EXPERTS)
    return _ExpertFFN.apply(buf, *(w[k] for k in _EXPERTS), cap,
                            max(1, _GROUP_BYTES // per))


def route(params, cfg, xt, capacity_factor: float, rows=None):
    """The routing half of the layer on tokens ``xt`` (T, D): the gates
    (T, K), the experts (T, K), each (token, choice)'s slot in its
    expert's buffer and whether it was kept, the capacity, and the aux
    losses (lb, z).  ``rows``: the axis the worker's tokens are
    split over (``xt`` this rank's block of them, in rank order), or
    None; the slots, keeps, capacity and losses are then the whole
    batch's."""
    T = xt.shape[0] * (1 if rows is None else rows.size)
    E, K = cfg.n_experts, cfg.experts_per_token
    up = torch.promote_types(xt.dtype, F32)  # f32 (f64 for f64 tokens)
    logits = xt.to(up) @ params["router"].to(up)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, K)  # (T, K)
    for entry in _ROUTINGS:
        log, pins = entry[0], entry[1]
        if pins is not None:  # the next layer's, in turn
            pin = pins[entry[2] % len(pins)]
            entry[2] += 1
            if tuple(pin.shape) != tuple(expert_ids.shape):
                raise ValueError(f"pinned routing {tuple(pin.shape)} for "
                                 f"{tuple(expert_ids.shape)} choices")
            expert_ids = pin.to(expert_ids.device)
            gate_vals = torch.gather(probs, -1, expert_ids)
        log.append(expert_ids.detach())
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9
    )

    # aux losses (switch-transformer style); me: the mean router
    # probability, ce: the fraction of tokens routed to each expert
    routed = torch.sum(F.one_hot(expert_ids, E).to(F32), dim=1)
    if rows is None:
        me = torch.mean(probs, dim=0)  # (E,)
        ce = torch.mean(routed, dim=0)
        z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    else:  # the sums over every rank's tokens
        me = tp_mod.reduce_from_data(torch.sum(probs, dim=0), rows) / T
        ce = tp_mod.reduce_from_data(torch.sum(routed, dim=0), rows) / T
        z_loss = tp_mod.reduce_from_data(torch.sum(
            torch.logsumexp(logits, dim=-1) ** 2), rows) / T
    lb_loss = E * torch.sum(me * ce) / K

    capacity = max(1, int(capacity_factor * T * K / E))

    # The K routing choices one after another; positions inside each
    # expert buffer stay consistent across choices through per-expert
    # counts.
    counts = torch.zeros((E,), dtype=torch.int32, device=xt.device)
    if rows is not None:
        # every rank's per-choice counts (ranks, K, E): a choice's slots
        # start after the earlier choices' tokens of every rank and this
        # choice's tokens of the earlier ranks
        per = torch.stack([torch.sum(F.one_hot(expert_ids[:, kk], E), dim=0,
                                     dtype=torch.int32) for kk in range(K)])
        every = tp_mod.gather_from_data_values(per, rows)
        earlier = torch.sum(every[:rows.rank], dim=0)  # (K, E)
        after = torch.cumsum(torch.sum(every, dim=0), dim=0) - torch.sum(
            every, dim=0)  # the earlier choices', every rank's
        starts = earlier + after
    positions, keeps = [], []
    for kk in range(K):
        ids_k = expert_ids[:, kk]  # (T,)
        onehot = F.one_hot(ids_k, E).to(torch.int32)  # (T, E)
        base = counts if rows is None else starts[kk]
        intra = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
        pos_k = torch.sum(intra * onehot, dim=-1) + base[ids_k]
        keep_k = pos_k < capacity
        positions.append(torch.where(keep_k, pos_k, capacity - 1).long())
        keeps.append(keep_k)
        counts = counts + torch.sum(onehot, dim=0, dtype=torch.int32)
    return (gate_vals, expert_ids, torch.stack(positions, 1),
            torch.stack(keeps, 1), capacity, (lb_loss, z_loss))


def moe_forward(params, cfg, x, *, capacity_factor: float = 1.25, tp=None,
                held=None, rows=None):
    """x: (B, S, D).  Returns MoEOutput.  With ``tp`` (a ``ModelAxis``)
    and ``held`` (the layer's held specs), this rank's block of experts;
    ``rows``: the axis the worker's rows are split over, or None (module
    docstring)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    # the routing, on the replicated tokens under the split: the same on
    # every rank, and so are its gradients (to the router and to x)
    gate_vals, expert_ids, positions, keeps, capacity, (lb_loss, z_loss) = \
        route(params, cfg, xt, capacity_factor, rows)
    for tally in _TALLIES:
        tally[0] = tally[0] + torch.sum(~keeps).detach()
    if tp is None:
        lo, hi, experts, xin, gates = 0, E, params, xt, gate_vals
    else:
        lo, hi = tp_mod.split_range(E, tp)
        experts = {k: tp_mod.take(params[k], 0, held[k], lo, hi, tp)
                   for k in _EXPERTS}
        xin = tp_mod.copy_to_model(xt, tp)
        gates = tp_mod.copy_to_model(gate_vals, tp)

    # each (token, choice)'s row in the flat buffers of experts [lo, hi):
    # its expert's slot, or the trash row (dropped, or another rank's)
    n = hi - lo
    mine = keeps & (expert_ids >= lo) & (expert_ids < hi)
    rows = torch.where(mine, (expert_ids - lo) * capacity + positions,
                       n * capacity)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    # Scatter the K choices one after another, so the transient working
    # set stays O(T*D), never O(T*K*D).
    buffers = torch.zeros((n * capacity + 1, D), dtype=x.dtype,
                          device=x.device)
    for kk in range(K):
        src = torch.where(mine[:, kk, None], xin, zero)
        buffers = buffers.index_put((rows[:, kk],), src, accumulate=True)

    outputs = _expert_ffn(experts, buffers, capacity)

    combined = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for kk in range(K):
        gathered = outputs[rows[:, kk]]  # (T, D); the trash row's is 0
        combined = combined + gathered * gates[:, kk][:, None].to(x.dtype)

    if cfg.n_shared_experts:
        combined = combined + swiglu_partial(
            params["shared"], xin, tp, cfg.d_ff * cfg.n_shared_experts,
            held and held["shared"])
    if tp is not None:  # the experts' and the shared expert's partials
        combined = tp_mod.reduce_from_model(combined, tp)

    return MoEOutput(combined.reshape(B, S, D), lb_loss, z_loss)


@contextlib.contextmanager
def count_drops():
    """Inside the block, tally the (token, choice) pairs that every MoE
    forward pass drops over its experts' capacity (recomputed forward
    passes counted again): yields a one-entry list whose entry is the
    count, a tensor on the tokens' device (0 until a layer runs)."""
    tally = [0]
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


@contextlib.contextmanager
def record_routing(pin=None):
    """Inside the block, every MoE forward pass (recomputed ones too)
    appends its choices, the (T, K) expert ids, to the yielded list.  With
    ``pin`` ((T, K) expert ids, or a sequence of them, one a MoE layer in
    the order the layers run), the passes route by the pins in turn,
    cyclically, instead of by their own top-k, their gates the router's
    probabilities of those experts, renormalized: a run held against
    another whose routing it takes, on a model whose MoE layers run in
    the same order in every pass over them (a forward pass, and its
    recomputation under one checkpoint)."""
    log = []
    pins = (None if pin is None else
            [pin] if isinstance(pin, torch.Tensor) else list(pin))
    entry = [log, pins, 0]
    _ROUTINGS.append(entry)
    try:
        yield log
    finally:
        _ROUTINGS[:] = [e for e in _ROUTINGS if e is not entry]
