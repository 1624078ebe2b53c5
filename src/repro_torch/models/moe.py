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
     are dropped (standard capacity-factor semantics)
  4. batched expert SwiGLU (E, cap, D) x (E, D, F), in f32 products
  5. gather back and combine weighted by the (renormalized) gates.

Aux losses: switch-style load-balance loss + router z-loss.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.constraints import maybe_constrain
from .layers import F32, Draw, dense_init

__all__ = ["init_moe", "moe_forward", "MoEOutput", "route", "top_k"]


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


def _expert_ffn(w, x):
    """x: (E, cap, D) -> (E, cap, D), batched SwiGLU over experts."""
    x32 = x.to(F32)
    g = torch.einsum("ecd,edf->ecf", x32, w["w_gate"].to(F32))
    u = torch.einsum("ecd,edf->ecf", x32, w["w_up"].to(F32))
    h = (F.silu(g) * u).to(x.dtype)
    h = maybe_constrain(h, "expert", None, None)
    return torch.einsum("ecf,efd->ecd", h.to(F32),
                        w["w_down"].to(F32)).to(x.dtype)


def route(params, cfg, xt, capacity_factor: float):
    """The routing half of the layer on tokens ``xt`` (T, D): the gates
    (T, K), the experts (T, K), each (token, choice)'s slot in its
    expert's buffer and whether it was kept, the capacity, and the aux
    losses (lb, z)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = xt.to(F32) @ params["router"].to(F32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, K)  # (T, K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9
    )

    # aux losses (switch-transformer style)
    me = torch.mean(probs, dim=0)  # (E,)
    ce = torch.mean(
        torch.sum(F.one_hot(expert_ids, E).to(F32), dim=1), dim=0
    )  # fraction of tokens routed to each expert
    lb_loss = E * torch.sum(me * ce) / K
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    capacity = max(1, int(capacity_factor * T * K / E))

    # The K routing choices one after another; positions inside each
    # expert buffer stay consistent across choices through per-expert
    # counts.
    counts = torch.zeros((E,), dtype=torch.int32, device=xt.device)
    positions, keeps = [], []
    for kk in range(K):
        ids_k = expert_ids[:, kk]  # (T,)
        onehot = F.one_hot(ids_k, E).to(torch.int32)  # (T, E)
        intra = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
        pos_k = torch.sum(intra * onehot, dim=-1) + counts[ids_k]
        keep_k = pos_k < capacity
        positions.append(torch.where(keep_k, pos_k, capacity - 1).long())
        keeps.append(keep_k)
        counts = counts + torch.sum(onehot, dim=0, dtype=torch.int32)
    return (gate_vals, expert_ids, torch.stack(positions, 1),
            torch.stack(keeps, 1), capacity, (lb_loss, z_loss))


def moe_forward(params, cfg, x, *, capacity_factor: float = 1.25):
    """x: (B, S, D).  Returns MoEOutput."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, expert_ids, positions, keeps, capacity, (lb_loss, z_loss) = \
        route(params, cfg, xt, capacity_factor)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    # Scatter the K choices one after another, so the transient working
    # set stays O(T*D), never O(T*K*D); a dropped choice adds 0 to its
    # expert's last slot.
    buffers = torch.zeros((E, capacity, D), dtype=x.dtype, device=x.device)
    for kk in range(K):
        src = torch.where(keeps[:, kk, None], xt, zero)
        buffers = buffers.index_put((expert_ids[:, kk], positions[:, kk]),
                                    src, accumulate=True)
    buffers = maybe_constrain(buffers, "expert", None, None)

    outputs = _expert_ffn(params, buffers)  # (E, cap, D)

    combined = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for kk in range(K):
        gathered = outputs[expert_ids[:, kk], positions[:, kk]]  # (T, D)
        gathered = torch.where(keeps[:, kk, None], gathered, zero)
        combined = combined + gathered * gate_vals[:, kk][:, None].to(x.dtype)

    if cfg.n_shared_experts:
        sh = params["shared"]
        g = F.silu((xt @ sh["w_gate"]).to(F32)).to(x.dtype)
        combined = combined + (g * (xt @ sh["w_up"])) @ sh["w_down"]

    return MoEOutput(combined.reshape(B, S, D), lb_loss, z_loss)
