"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), the counterpart
of ``repro.models.ssm``.

Chunked SSD algorithm for training/prefill: within each chunk of length Q
the output is a masked (causal, decay-weighted) attention-like quadratic
form; across chunks a recurrent state h (heads, head_dim, d_state) is
carried by a loop over the chunks.

Decode: single-step SSM recurrence + rolling conv state, O(1) per token.

Layout follows Mamba-2: input projection produces [z (gate), x, B, C, dt];
depthwise causal conv over the (x, B, C) channels; A is a per-head scalar
decay (negative), D a per-head skip.

Under the tensor-parallel split (``tp``, ``models.tp``; training only)
rank r runs heads ``split_range(nh, M)`` of the scan: their z, x and dt
channels and all of B and C (one group, which every head reads).
``param_specs`` splits ``in_proj`` by column and ``conv_w`` by channel in
equal blocks, which cut across the packed parts, so each of the two
comes whole once a layer (``tp.take`` over its whole range: gathered,
its gradient all-reduced and this rank's piece kept) and the rank's
columns are cut from it into one product; B and C are computed alike on
every rank and their gradients summed over the axis by that gather.  The
gated norm over d_inner sums the ranks' partial sums of squares
(``tp.sum_over_model``); ``out_proj`` is row-split and the ranks'
products summed (``tp.reduce_from_model``).  The whole layer runs the
same body with ``tp=None``.

The decode step splits alike: rank r holds heads ``split_range(nh, M)``
of the recurrent state ``h`` (``sharding.rules.cache_specs``) and the
whole rolling conv buffer, which every rank writes alike from the whole
x | B | C row of ``in_proj`` (taken whole once a layer, as above); the
gated norm and ``out_proj`` as in the forward pass.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.sharding.constraints import maybe_constrain
from . import tp as tp_mod
from .layers import F32, Draw, dense_init, init_rmsnorm, rmsnorm

__all__ = ["init_mamba2", "mamba2_forward", "mamba2_decode_step",
           "init_ssm_state", "SSMState"]


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


def _softplus(x):
    """log(1 + e^x), as ``jax.nn.softplus`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba2(rng: Draw, cfg, dtype):
    d = cfg.d_model
    d_inner, nh = _dims(cfg)
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    d_in_proj = 2 * d_inner + 2 * N + nh  # z, x, B, C, dt
    return {
        "in_proj": dense_init(rng, d, d_in_proj, dtype),
        "conv_w": rng.normal((cfg.ssm_conv, conv_dim), dtype, 0.1),
        "conv_b": rng.full((conv_dim,), 0.0, dtype),
        # A = -exp(A_log), per head
        "A_log": rng.const(torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32))),
        "D": rng.full((nh,), 1.0, F32),
        # softplus^-1(0.01)
        "dt_bias": rng.const(torch.log(torch.expm1(torch.full((nh,), 0.01,
                                                              dtype=F32)))),
        "norm": init_rmsnorm(rng, d_inner, dtype),
        "out_proj": dense_init(rng, d_inner, d, dtype,
                               scale=1.0 / math.sqrt(d_inner)),
    }


def _split_proj(cfg, proj):
    d_inner, nh = _dims(cfg)
    N = cfg.ssm_state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: 2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xbc, dt


def _causal_conv(w, b, xbc, conv_state=None):
    """Depthwise causal conv1d over time.  xbc: (B, S, C).  Returns
    (out, new_conv_state).  conv_state: (B, K-1, C) rolling buffer."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros_like(xbc[:, : K - 1])
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    S = xbc.shape[1]
    out = sum(xp[:, i: i + S] * w[i][None, None] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu((out + b[None, None]).to(F32)).to(xbc.dtype), new_state


def _ssd_chunked(cfg, xh, dt, B_mat, C_mat, A, init_state=None):
    """Chunked SSD scan.

    xh: (B, S, H, P); dt: (B, S, H) (post-softplus); B_mat/C_mat: (B, S, N);
    A: (H,) negative decay.  Returns (y (B,S,H,P), final_state (B,H,P,N)).

    The intra-chunk decay L = exp(segsum) under the causal mask takes the
    exponent masked to 0 above the diagonal before the ``exp``: there the
    segment sum is a sum of -dt*A > 0, whose ``exp`` overflows at long
    chunks; masked after the ``exp`` only (as the reference does) the
    forward value is the same but the backward pass multiplies the zero
    cotangent by inf.
    """
    Bsz, S, H, P = xh.shape
    N = B_mat.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    n_chunks = -(-S // Q)
    pad = n_chunks * Q - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, pad))

    def reshape_chunks(t):
        return t.reshape((Bsz, n_chunks, Q) + tuple(t.shape[2:]))

    xc, dtc = reshape_chunks(xh), reshape_chunks(dt)
    Bc, Cc = reshape_chunks(B_mat), reshape_chunks(C_mat)

    dA = dtc * A[None, None, None, :]  # (B, nc, Q, H)  (negative)
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))[None, :, :, None]
    zero = torch.zeros((), dtype=F32, device=xh.device)

    h = (torch.zeros((Bsz, H, P, N), dtype=F32, device=xh.device)
         if init_state is None else init_state.to(F32))
    ys = []
    for c in range(n_chunks):
        xq, dtq, bq, cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cumq = cum[:, c]
        xq32 = xq.to(F32)
        # decay matrices: log decay i <- j, (B,Q,Q,H)
        seg = cumq[:, :, None, :] - cumq[:, None, :, :]
        L = torch.where(causal, torch.exp(torch.where(causal, seg, zero)),
                        zero)
        # intra-chunk (quadratic) term: y_i += sum_j L_ij (C_i.B_j) dt_j x_j
        CB = torch.einsum("bqn,bpn->bqp", cq.to(F32), bq.to(F32))  # (B,Q,Q)
        W = CB[:, :, :, None] * L  # (B,Q,Q,H)
        y_intra = torch.einsum("bqjh,bjh,bjhp->bqhp", W, dtq, xq32)
        # inter-chunk: contribution of the carried state
        decay_in = torch.exp(cumq)  # (B,Q,H)
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", cq.to(F32), h, decay_in)
        # state update: h_new = decay_total * h + sum_j decay_j->end B_j dt_j x_j
        total = torch.exp(cumq[:, -1:, :])  # (B,1,H)
        decay_out = torch.exp(cumq[:, -1:, :] - cumq)  # (B,Q,H)
        dBx = torch.einsum("bqn,bqh,bqhp->bhpn", bq.to(F32), dtq * decay_out,
                           xq32)
        h = h * total[:, 0, :, None, None] + dBx
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, n_chunks * Q, H, P)
    return y[:, :S], h


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, H, P, N) recurrent state
    conv: torch.Tensor  # (B, K-1, conv_dim) rolling conv buffer


def init_ssm_state(cfg, batch: int, dtype=F32, *, device=None,
                   lead=()) -> SSMState:
    """A zero state on ``device`` (the card unless told otherwise);
    ``lead`` prefixes every field's shape (a stack of layers)."""
    device = resolve_device(device)
    d_inner, nh = _dims(cfg)
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    lead = tuple(lead)
    return SSMState(
        h=torch.zeros(lead + (batch, nh, cfg.ssm_head_dim, N), dtype=F32,
                      device=device),
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                         dtype=dtype, device=device),
    )


def _columns(w, ranges):
    """The columns ``ranges`` ([lo, hi) pairs, in order) of ``w``'s last
    dimension, side by side: ``w`` itself when they are all of it."""
    merged = []
    for lo, hi in ranges:
        if merged and merged[-1][1] == lo:
            merged[-1] = (merged[-1][0], hi)
        elif hi > lo:
            merged.append((lo, hi))
    if merged == [(0, w.shape[-1])]:
        return w
    return torch.cat([w[..., lo:hi] for lo, hi in merged], dim=-1)


def _gated_rmsnorm(scale, y, z, width: int, tp, eps=1e-6):
    """``rmsnorm`` of y * silu(z) over the inner width ``width``, from
    this rank's channels (``scale`` its entries): the sum of squares of
    each row summed over the axis.  In f32 (f64 for f64 operands)."""
    up = torch.promote_types(y.dtype, F32)
    g = (y * F.silu(z.to(up)).to(y.dtype)).to(up)
    ss = tp_mod.sum_over_model(torch.sum(g * g, dim=-1, keepdim=True), tp)
    out = g * torch.rsqrt(ss / width + eps)
    return (out * scale.to(up)).to(y.dtype)


def mamba2_forward(params, cfg, x, *, state: Optional[SSMState] = None,
                   tp=None, held=None):
    """Full-sequence forward (training / prefill).  Returns (out, new_state).
    With ``tp`` (a ``ModelAxis``) and ``held`` (the leaves' held specs),
    this rank's heads on its pieces and the row-split product summed over
    the axis (module docstring); with ``tp=None`` every head."""
    if tp is not None and state is not None:
        raise ValueError("the tensor-parallel split trains: it takes no "
                         "SSM state")
    Bsz, S, d = x.shape
    d_inner, nh = _dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    h0, h1 = (0, nh) if tp is None else tp_mod.split_range(nh, tp)
    H, c0, c1 = h1 - h0, h0 * P, h1 * P  # the heads and their channels
    C = c1 - c0

    def leaf(name, dim, lo, hi, tree=params, specs=held):
        return tp_mod.take(tree[name], dim, specs and specs[name], lo, hi,
                           tp)

    # z | x | B | C | dt of these heads in one product; in_proj and conv_w
    # whole once (their pieces cut across the parts)
    conv_dim = d_inner + 2 * N  # x | B | C
    dt0 = d_inner + conv_dim  # dt's first column of in_proj
    w_in = _columns(leaf("in_proj", 1, 0, dt0 + nh), [
        (c0, c1), (d_inner + c0, d_inner + c1), (2 * d_inner, dt0),
        (dt0 + h0, dt0 + h1)])
    proj = tp_mod.copy_to_model(x, tp) @ w_in
    z, xbc, dt = proj.split([C, C + 2 * N, H], dim=-1)
    conv = [(c0, c1), (d_inner, conv_dim)]
    conv_in_state = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(
        _columns(leaf("conv_w", 1, 0, conv_dim), conv),
        _columns(leaf("conv_b", 0, 0, conv_dim), conv), xbc, conv_in_state)
    xs = xbc[..., :C].reshape(Bsz, S, H, P)
    B_mat = xbc[..., C: C + N].to(F32)
    C_mat = xbc[..., C + N:].to(F32)
    dt = _softplus(dt.to(F32) + leaf("dt_bias", 0, h0, h1)[None, None])
    A = -torch.exp(leaf("A_log", 0, h0, h1))  # (H,)

    xs = maybe_constrain(xs, "data", None, "heads", None)
    y, h_final = _ssd_chunked(
        cfg, xs, dt, B_mat, C_mat, A, None if state is None else state.h
    )
    y = y + leaf("D", 0, h0, h1)[None, None, :, None] * xs.to(F32)
    y = y.reshape(Bsz, S, C).to(x.dtype)
    y = _gated_rmsnorm(leaf("scale", 0, c0, c1, params["norm"],
                            held and held["norm"]), y, z, d_inner, tp)
    out = tp_mod.reduce_from_model(y @ leaf("out_proj", 0, c0, c1), tp)
    new_state = None
    if state is not None:
        new_state = SSMState(h=h_final, conv=new_conv.to(state.conv.dtype))
    return out, new_state


def mamba2_decode_step(params, cfg, x, state: SSMState, tp=None,
                       held=None):
    """Single-token decode.  x: (B, 1, d).  Returns (out (B,1,d), new_state).
    With ``tp`` and ``held``, this rank's heads of the state on its
    pieces (module docstring); with ``tp=None`` every head."""
    Bsz = x.shape[0]
    d_inner, nh = _dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    h0, h1 = (0, nh) if tp is None else tp_mod.split_range(nh, tp)
    H, c0, c1 = h1 - h0, h0 * P, h1 * P  # the heads and their channels
    if state.h.shape[1] != H:
        raise ValueError(f"an SSM state of {state.h.shape[1]} heads for "
                         f"heads [{h0}, {h1}) of {nh}")

    def leaf(name, dim, lo, hi, tree=params, specs=held):
        return tp_mod.take(tree[name], dim, specs and specs[name], lo, hi,
                           tp)

    conv_dim = d_inner + 2 * N
    # the whole z | x | B | C | dt row, so that every rank writes the same
    # conv buffer
    proj = x[:, 0] @ leaf("in_proj", 1, 0, d_inner + conv_dim + nh)
    z, xbc, dt = _split_proj(cfg, proj)
    # rolling conv: append, convolve last position, shift buffer
    window = torch.cat([state.conv.to(xbc.dtype), xbc[:, None]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window,
                            leaf("conv_w", 1, 0, conv_dim))
    xbc = F.silu((conv_out + leaf("conv_b", 0, 0, conv_dim)[None]).to(
        F32)).to(x.dtype)
    new_conv = window[:, 1:]

    xs = xbc[..., c0:c1].reshape(Bsz, H, P).to(F32)
    B_mat = xbc[..., d_inner: d_inner + N].to(F32)  # (B,N)
    C_mat = xbc[..., d_inner + N:].to(F32)
    dt = _softplus(dt[..., h0:h1].to(F32) + leaf("dt_bias", 0, h0, h1)[None])
    A = -torch.exp(leaf("A_log", 0, h0, h1))

    decay = torch.exp(dt * A[None])  # (B,H)
    h_new = state.h * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xs, B_mat
    )
    y = torch.einsum("bhpn,bn->bhp", h_new, C_mat) + leaf(
        "D", 0, h0, h1)[None, :, None] * xs
    y = y.reshape(Bsz, H * P).to(x.dtype)
    y = _gated_rmsnorm(leaf("scale", 0, c0, c1, params["norm"],
                            held and held["norm"]), y, z[..., c0:c1],
                       d_inner, tp)
    out = tp_mod.reduce_from_model(y @ leaf("out_proj", 0, c0, c1), tp)
    return out[:, None], SSMState(h=h_new, conv=new_conv.to(state.conv.dtype))
