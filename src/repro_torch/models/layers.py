"""Functional transformer building blocks shared by all 10 architectures,
the counterpart of ``repro.models.layers``.

Parameters are nested dicts of tensors built by ``init_*`` functions and
consumed by matching forward functions, with the reference's keys,
shapes and dtypes.  Where the reference asks an einsum for f32 results
from bf16 inputs (``preferred_element_type``), the operands are upcast
first: a bf16 ``torch.matmul`` on CUDA rounds its result to bf16.
Attention is the reference's chunked, flash-style loop over KV blocks
(memory O(chunk) instead of O(S^2)), so 32k-token prefill keeps bounded
activations; decode (q_len == 1) takes a single masked pass.

Initial weights come from a :class:`Draw`: a ``torch.Generator`` on the
target device and a leading shape, so that a layer's leaves are drawn
stacked over the layers that share it (``Draw.stacked``), as the
reference stacks its per-layer trees.  On ``device="meta"`` nothing is
drawn or allocated (``param_count``).

``gqa_forward``, ``cross_attn_forward``, ``mla_forward`` and
``swiglu_forward`` take ``tp``, a
``sharding.constraints.ModelAxis``, and ``held``, their leaves' held
specs: with them they run this rank's part of Megatron's column and row
split on the pieces it holds (``models.tp``); without them, whole.

A decode step under the split holds the cache's length split over
"model" (``sharding.rules.cache_specs``: rank r holds positions
[r L/M, (r+1) L/M) of every kv head, or of the MLA latents).  The new
token's queries, keys and values (or latents) are made whole on every
rank from its column pieces (an all-gather of (B, 1, ...) values); the
rank whose block holds the write position writes them, the start clamped
against the whole length as ``_write_at`` clamps it; every rank scores
all heads against its own positions, masked by their absolute
positions; the maxima are taken over "model" first, so that each rank's
exponentials are the whole pass's, and the sums of the exponentials and
of the weighted values are summed over it (``_merge_sums``): the whole
single pass's softmax up to the order of its sums.  The rank then keeps
its heads' columns for its ``wo`` rows, as the training split does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.constraints import maybe_constrain

from . import tp as tp_mod

F32 = torch.float32

__all__ = [
    "F32",
    "Draw",
    "dense_init",
    "init_rmsnorm",
    "rmsnorm",
    "rope_frequencies",
    "apply_rope",
    "attention",
    "init_gqa",
    "gqa_forward",
    "init_cross_attn",
    "cross_attn_forward",
    "init_mla",
    "mla_forward",
    "init_swiglu",
    "swiglu_forward",
    "swiglu_partial",
]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class Draw:
    """Where initial weights come from: ``generator`` (None on "meta"),
    the ``device`` they land on, and ``lead``, the leading shape every
    leaf gets (``(n_layers,)`` for a stacked layer)."""

    def __init__(self, generator, device, lead=()):
        self.generator = generator
        self.device = torch.device(device)
        self.lead = tuple(lead)

    @classmethod
    def from_seed(cls, seed: int, device) -> "Draw":
        device = torch.device(device)
        if device.type == "meta":
            return cls(None, device)
        return cls(torch.Generator(device=device).manual_seed(int(seed)),
                   device)

    def stacked(self, n: int) -> "Draw":
        return Draw(self.generator, self.device, (n,) + self.lead)

    def normal(self, shape, dtype, scale=1.0):
        """N(0, 1) draws in f32 times ``scale``, cast to ``dtype``."""
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, dtype=F32,
                        device=self.device)
        return (x * scale).to(dtype)

    def full(self, shape, value, dtype):
        return torch.full(self.lead + tuple(shape), value, dtype=dtype,
                          device=self.device)

    def const(self, values):
        """A per-layer constant (a 1-D tensor made on the CPU) repeated
        over the leading shape."""
        out = values.to(self.device)
        return out.expand(self.lead + tuple(values.shape)).clone()


def dense_init(rng: Draw, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return rng.normal((d_in, d_out), dtype, scale)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(rng: Draw, d, dtype):
    return {"scale": rng.full((d,), 1.0, dtype)}


def rmsnorm(params, x, eps=1e-6):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device),
                           exps)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(F32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked flash-style attention
# ---------------------------------------------------------------------------

_NEG_INF = -1e30
_KEEP_SCORES_BYTES = 8 << 30


def _merge_sums(l, o, tp):
    """The sums over "model" of the ranks' partial sums of exponentials
    ``l`` (...) and weighted values ``o`` (..., d): one all-reduce of the
    two side by side (``l``, ``o`` themselves when ``tp`` is None)."""
    if tp is None:
        return l, o
    both = tp_mod.reduce_from_model(torch.cat([l[..., None], o], dim=-1),
                                    tp)
    return both[..., 0], both[..., 1:]


def _attend_chunk(q, k, v, mask, tp=None):
    """Grouped chunk attention without KV expansion.

    q: (B,G,R,Tq,hd)  k/v: (B,G,Tk,hd)  mask: (1,1,1,Tq,Tk) or None.
    (G = kv heads, R = query heads per kv head.)  Returns (scores_max
    (B,G,R,Tq), exp_sum, weighted_v) in f32: the scores and the weighted
    values are f32 products of the (upcast) operands, as the reference's
    ``preferred_element_type=F32``.  With ``tp`` the keys are this rank's
    block of a length split over "model": the max is every rank's and the
    two sums are summed over the axis (module docstring)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bgrqd,bgkd->bgrqk", q.to(F32), k.to(F32)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(_NEG_INF, dtype=F32,
                                              device=s.device))
    m = tp_mod.max_over_model(torch.amax(s, dim=-1), tp)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).to(F32), v.to(F32))
    l, o = _merge_sums(l, o, tp)
    return m, l, o


def attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset=0,
    chunk: int = 1024,
    k_offset=0,
    tp=None,
):
    """Grouped-query attention core.

    q: (B, Tq, H, hd);  k, v: (B, Tk, KV, hd); H % KV == 0.
    ``q_offset``: absolute position of q[0] (decode: cache length);
    ``k_offset``: that of k[0]; with ``tp`` (decode only) the keys are
    this rank's block of a length split over "model" and the softmax is
    merged over the axis (``_attend_chunk``).
    ``window > 0``: sliding-window attention (each query sees the last
    ``window`` keys) — the sub-quadratic variant used for long_500k.
    A loop over KV chunks with a running log-sum-exp merge (flash-style)
    whenever Tk > chunk, keeping peak activation memory O(B*H*Tq*chunk),
    in the backward pass too where the scores kept for it would be large
    (each chunk's scores recomputed).
    """
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]  # MLA: value head dim differs from (rope-extended) key dim
    rep = H // KV
    dev = q.device
    # (B,G,R,Tq,hd), upcast once for every chunk's f32 scores
    qh = q.transpose(1, 2).reshape(B, KV, rep, Tq, hd).to(F32)
    kh = k.transpose(1, 2)  # (B,G,Tk,hd)
    vh = v.transpose(1, 2)

    q_pos = q_offset + torch.arange(Tq, device=dev)

    def mask_for(k_start, width, valid=None):
        k_pos = k_start + torch.arange(width, device=dev)
        m = torch.ones((Tq, width), dtype=torch.bool, device=dev)
        if causal:
            m &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            m &= k_pos[None, :] > q_pos[:, None] - window
        if valid is not None:
            m &= k_pos[None, :] < valid  # padding
        return m[None, None, None]  # (1,1,1,Tq,width)

    def finish(o, l):
        out = o / torch.clamp(l, min=1e-30)[..., None]  # (B,G,R,Tq,hd_v)
        out = out.reshape(B, H, Tq, hd_v)
        return out.transpose(1, 2).to(q.dtype)

    # Single pass when it fits, and always for decode (Tq == 1): scores
    # are only (B,G,R,1,Tk) there, so chunking buys nothing.
    if Tk <= chunk or Tq == 1:
        need_mask = causal or window > 0
        _, l, o = _attend_chunk(qh, kh, vh, mask_for(k_offset, Tk)
                                if need_mask else None, tp)
        return finish(o, l)
    if tp is not None or k_offset:
        raise ValueError("a length split over \"model\" is a decode step's")

    n_chunks = -(-Tk // chunk)
    pad = n_chunks * chunk - Tk
    if pad:
        kh = F.pad(kh, (0, 0, 0, pad))
        vh = F.pad(vh, (0, 0, 0, pad))

    m_run = torch.full((B, KV, rep, Tq), _NEG_INF, dtype=F32, device=dev)
    l_run = torch.zeros((B, KV, rep, Tq), dtype=F32, device=dev)
    o_run = torch.zeros((B, KV, rep, Tq, hd_v), dtype=F32, device=dev)
    # each chunk's scores are recomputed in the backward pass where the
    # backward pass would otherwise keep every chunk's, three f32 (Tq, Tk)
    # tensors a head, beyond _KEEP_SCORES_BYTES (deepseek-v3's 128 heads
    # at 4,096 tokens: 26 GB; minitron-8b's 32 keep their 6.4 GB, where
    # the recompute cost a difference round 9%)
    step = _attend_chunk
    if (torch.is_grad_enabled()
            and 12 * B * H * Tq * n_chunks * chunk > _KEEP_SCORES_BYTES):
        step = lambda *a: checkpoint(_attend_chunk, *a,  # noqa: E731
                                     use_reentrant=False)
    for idx in range(n_chunks):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        mc, lc, oc = step(qh, kh[:, :, sl], vh[:, :, sl],
                          mask_for(idx * chunk, chunk, Tk))
        m_new = torch.maximum(m_run, mc)
        a = torch.exp(m_run - m_new)
        b = torch.exp(mc - m_new)
        l_run = l_run * a + lc * b
        o_run = o_run * a[..., None] + oc * b[..., None]
        m_run = m_new
    return finish(o_run, l_run)


# ---------------------------------------------------------------------------
# GQA self-attention layer (with KV cache decode path)
# ---------------------------------------------------------------------------

def init_gqa(rng: Draw, cfg, dtype):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(rng, d, H * hd, dtype),
        "wk": dense_init(rng, d, KV * hd, dtype),
        "wv": dense_init(rng, d, KV * hd, dtype),
        "wo": dense_init(rng, H * hd, d, dtype, scale=1.0 / math.sqrt(H * hd)),
    }


def _write_at(buf, update, index):
    """``buf`` with ``update`` written along dim 1 from ``index``, the
    start clamped so the update fits, as ``dynamic_update_slice`` does.
    The write is in place (a KV cache is not copied a token), and
    ``buf`` itself is returned."""
    T = update.shape[1]
    start = max(0, min(int(index), buf.shape[1] - T))
    buf[:, start:start + T] = update.to(buf.dtype)
    return buf


def _cache_owner(start: int, width: int, tp) -> int:
    """The coordinate of the rank whose block of ``width`` positions of a
    length split over "model" holds position ``start``."""
    return start // width


def _write_split(buf, update, index, tp):
    """``_write_at`` on this rank's block of a cache whose length (dim 1)
    is split over "model" in equal blocks: the start clamped against the
    whole length, the one-token update written by the rank that holds
    it (the others leave their block as it is).  Returns ``buf``."""
    width, T = buf.shape[1], update.shape[1]
    if T != 1:
        raise ValueError("a length split over \"model\" writes one token")
    start = max(0, min(int(index), width * tp.size - T))
    if _cache_owner(start, width, tp) == tp.rank:
        buf[:, start % width] = update[:, 0].to(buf.dtype)
    return buf


def _whole_columns(x, w, spec, tp):
    """``x @ w`` whole on every rank from this rank's column piece ``w``
    (all-gathered over the axis, ``tp.gather_replicated``), or from the
    whole leaf where ``param_specs`` leaves it whole."""
    if tp_mod.split_on(spec, 1) is None:
        return x @ w
    return tp_mod.gather_replicated(x @ w, tp, -1)


def gqa_forward(
    params,
    cfg,
    x,
    *,
    positions,
    causal=True,
    window=0,
    cache=None,
    cache_index=None,
    tp=None,
    held=None,
):
    """Self-attention.  If ``cache`` is given (dict with 'k','v' of shape
    (B, L, KV, hd)) run incremental decode: write x's k/v at ``cache_index``
    and attend over the cache.  Returns (out, new_cache).  With ``tp`` (a
    ``ModelAxis``) and ``held`` (the leaves' held specs), this rank's heads
    on its pieces (``_gqa_split``)."""
    if tp is not None:
        if cache is not None:
            return _gqa_decode_split(params, held, cfg, x, positions,
                                     causal, window, cache, cache_index, tp)
        return _gqa_split(params, held, cfg, x, positions, causal, window,
                          tp), None
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, T, H, hd)
    k = (x @ params["wk"]).reshape(B, T, KV, hd)
    v = (x @ params["wv"]).reshape(B, T, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if T > 1:
        q = maybe_constrain(q, "data", None, "heads", None)
        k = maybe_constrain(k, "data", None, "kv", None)
        v = maybe_constrain(v, "data", None, "kv", None)

    if cache is not None:
        ck = _write_at(cache["k"], k, cache_index)
        cv = _write_at(cache["v"], v, cache_index)
        new_cache = {"k": ck, "v": cv}
        out = attention(
            q, ck, cv, causal=causal, window=window, q_offset=cache_index
        )
    else:
        new_cache = None
        out = attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, T, H * hd)
    return out @ params["wo"], new_cache


def _gqa_split(params, held, cfg, x, positions, causal, window, tp,
               kv=None):
    """This rank's part of the attention: the columns [lo, hi) of the
    heads' output that its ``wo`` rows take (equal blocks, as
    ``param_specs`` splits ``wo``), from the query heads that cover them
    and the kv heads those read; the row-split product all-reduced.

    The keys and values come from ``kv``: None for self-attention (from
    ``x``, RoPE on ``positions``), or the vision tokens (B, n_vis,
    d_model) of cross-attention (``positions`` None: no RoPE), which
    enter the split through their own ``copy_to_model``.

    When the range is whole heads of whole kv groups (heads and kv heads
    divisible by the axis) each rank computes its own heads on its own
    pieces; otherwise the heads it needs reach past its pieces (fewer kv
    heads than ranks: half a head a piece; or heads the axis does not
    divide) and ``tp.take`` all-gathers them, each query head reading its
    kv head by index."""
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV
    lo, hi = tp_mod.split_range(H * hd, tp)
    h0, h1 = lo // hd, -(-hi // hd)  # the query heads that cover [lo, hi)
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1  # the kv heads they read
    xin = tp_mod.copy_to_model(x, tp)
    src = xin if kv is None else tp_mod.copy_to_model(kv, tp)
    S = src.shape[1]
    wq, wk, wv = (tp_mod.take(params[n], 1, held[n], a * hd, b * hd, tp)
                  for n, a, b in (("wq", h0, h1), ("wk", g0, g1),
                                  ("wv", g0, g1)))
    q = (xin @ wq).reshape(B, T, h1 - h0, hd)
    k = (src @ wk).reshape(B, S, g1 - g0, hd)
    v = (src @ wv).reshape(B, S, g1 - g0, hd)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if h0 % rep or h1 % rep:  # not whole kv groups: one kv head a query head
        idx = torch.arange(h0, h1, device=x.device) // rep - g0
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    out = attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, T, (h1 - h0) * hd).narrow(2, lo - h0 * hd, hi - lo)
    wo = tp_mod.take(params["wo"], 0, held["wo"], lo, hi, tp)
    return tp_mod.reduce_from_model(out @ wo, tp)


def _gqa_decode_split(params, held, cfg, x, positions, causal, window,
                      cache, cache_index, tp):
    """A decode step of the attention on this rank's block of the cache's
    length (module docstring): q, k and v of the new token whole from the
    column pieces, the write by the block's owner, the softmax of every
    head over the rank's positions merged over "model", then the columns
    [lo, hi) of the heads' output that its ``wo`` rows take and the
    row-split product all-reduced."""
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (_whole_columns(x, params[n], held[n], tp).reshape(B, T, h, hd)
               for n, h in (("wq", H), ("wk", KV), ("wv", KV)))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck = _write_split(cache["k"], k, cache_index, tp)
    cv = _write_split(cache["v"], v, cache_index, tp)
    out = attention(q, ck, cv, causal=causal, window=window,
                    q_offset=cache_index, k_offset=tp.rank * ck.shape[1],
                    tp=tp).reshape(B, T, H * hd)
    lo, hi = tp_mod.split_range(H * hd, tp)
    wo = tp_mod.take(params["wo"], 0, held["wo"], lo, hi, tp)
    return (tp_mod.reduce_from_model(out.narrow(2, lo, hi - lo) @ wo, tp),
            {"k": ck, "v": cv})


# ---------------------------------------------------------------------------
# cross-attention (VLM layers: text queries, vision keys/values)
# ---------------------------------------------------------------------------

def init_cross_attn(rng: Draw, cfg, dtype):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(rng, d, H * hd, dtype),
        "wk": dense_init(rng, d, KV * hd, dtype),
        "wv": dense_init(rng, d, KV * hd, dtype),
        "wo": dense_init(rng, H * hd, d, dtype, scale=1.0 / math.sqrt(H * hd)),
        "gate": rng.full((1,), 0.0, dtype),  # tanh-gated residual (Llama-3.2 style)
    }


def cross_attn_forward(params, cfg, x, vision_kv, tp=None, held=None):
    """vision_kv: (B, n_vis, d_model) precomputed projected vision states.
    With ``tp`` (a ``ModelAxis``) and ``held`` (the leaves' held specs),
    this rank's heads on its pieces (``_gqa_split`` with the vision
    tokens as the keys' and values' source, no RoPE, not causal); the
    gate scales the sum over the axis, so that its gradient is whole on
    every rank, as a norm's is."""
    if tp is not None:
        out = _gqa_split(params, held, cfg, x, None, False, 0, tp,
                         kv=vision_kv)
        return torch.tanh(params["gate"].to(F32)).to(x.dtype) * out
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nv = vision_kv.shape[1]
    q = (x @ params["wq"]).reshape(B, T, H, hd)
    k = (vision_kv @ params["wk"]).reshape(B, nv, KV, hd)
    v = (vision_kv @ params["wv"]).reshape(B, nv, KV, hd)
    out = attention(q, k, v, causal=False)
    out = out.reshape(B, T, H * hd) @ params["wo"]
    return torch.tanh(params["gate"].to(F32)).to(x.dtype) * out


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------

def init_mla(rng: Draw, cfg, dtype):
    """Low-rank q (rank q_lora_rank) and joint kv compression (kv_lora_rank)
    with a decoupled RoPE sub-head of qk_rope_dim dims.  The decode cache
    stores only the latent c_kv plus the rope key: (kv_lora_rank + rope_dim)
    per token."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    rq, rkv, rd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim
    nope = hd  # non-rope head dim
    return {
        "wq_a": dense_init(rng, d, rq, dtype),
        "q_norm": init_rmsnorm(rng, rq, dtype),
        "wq_b": dense_init(rng, rq, H * (nope + rd), dtype),
        "wkv_a": dense_init(rng, d, rkv + rd, dtype),
        "kv_norm": init_rmsnorm(rng, rkv, dtype),
        "wkv_b": dense_init(rng, rkv, H * (nope + nope), dtype),
        "wo": dense_init(rng, H * nope, d, dtype, scale=1.0 / math.sqrt(H * nope)),
    }


def mla_forward(params, cfg, x, *, positions, cache=None, cache_index=None,
                window=0, tp=None, held=None):
    """cache: {'ckv': (B, L, rkv), 'krope': (B, L, rd)}.  With ``tp`` and
    ``held``, this rank's heads on its pieces (``_mla_split``), or a
    decode step on its block of the latent cache's length
    (``_mla_decode_split``)."""
    if tp is not None:
        if cache is not None:
            return _mla_decode_split(params, held, cfg, x, positions, cache,
                                     cache_index, window, tp)
        return _mla_split(params, held, cfg, x, positions, window, tp), None
    B, T, d = x.shape
    H, hd, rd = cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim
    rkv = cfg.kv_lora_rank
    nope = hd

    qa = rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = (qa @ params["wq_b"]).reshape(B, T, H, nope + rd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ params["wkv_a"]  # (B,T,rkv+rd)
    ckv = rmsnorm(params["kv_norm"], kv_a[..., :rkv])
    k_rope = apply_rope(kv_a[..., rkv:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        ckv = _write_at(cache["ckv"], ckv, cache_index)
        k_rope = _write_at(cache["krope"], k_rope, cache_index)
        new_cache = {"ckv": ckv, "krope": k_rope}
        q_offset = cache_index
    else:
        new_cache = None
        q_offset = 0

    if cache is not None and T == 1:
        # Absorbed decode (DeepSeek-V2/V3): never expand the latent to
        # per-head K/V.  Scores contract the query against the latent
        # directly (W_uk absorbed into q), values are read in latent space
        # and projected per head afterwards (W_uv applied to the 1-token
        # attention output).
        L = ckv.shape[1]
        wkv_b = params["wkv_b"].reshape(rkv, H, 2 * nope)
        w_uk = wkv_b[..., :nope]  # (rkv, H, nope)
        w_uv = wkv_b[..., nope:]  # (rkv, H, nope)
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope, w_uk)  # (B,1,H,rkv)
        s = torch.einsum("bthr,blr->bhtl", q_abs.to(F32), ckv.to(F32))
        s = s + torch.einsum(
            "bthr,blr->bhtl", q_rope.to(F32), k_rope.to(F32)
        )
        s = s / math.sqrt(nope + rd)
        l_pos = torch.arange(L, device=x.device)
        mask = l_pos[None, None, None, :] <= q_offset
        if window:
            mask = mask & (l_pos[None, None, None, :] > q_offset - window)
        s = torch.where(mask, s, torch.tensor(_NEG_INF, dtype=F32,
                                              device=s.device))
        alpha = torch.softmax(s, dim=-1)  # (B,H,1,L)
        o_lat = torch.einsum("bhtl,blr->bthr", alpha, ckv.to(F32))  # (B,1,H,rkv)
        out = torch.einsum("bthr,rhn->bthn", o_lat, w_uv.to(F32)).to(x.dtype)
        out = out.reshape(B, T, H * nope)
        return out @ params["wo"], new_cache

    # prefill / training: expand latent to per-head keys/values
    L = ckv.shape[1]
    kvb = (ckv @ params["wkv_b"]).reshape(B, L, H, 2 * nope)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    k = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(B, L, H, rd)], dim=-1
    )
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = attention(qf, k, v, causal=True, window=window, q_offset=q_offset)
    out = out.reshape(B, T, H * nope)
    return out @ params["wo"], new_cache


def _mla_split(params, held, cfg, x, positions, window, tp):
    """This rank's part of MLA: the latents whole on every rank, then the
    columns [lo, hi) of the heads' output that its ``wo`` rows take, from
    the heads that cover them, the row-split product all-reduced.

    ``wq_a`` and ``wkv_a`` are column-split: each rank computes its
    columns of the latents, which are all-gathered whole
    (``gather_replicated``), since ``q_norm`` and ``kv_norm`` read the
    whole latent (and ``wkv_a``'s piece may straddle the latent and the
    rope key); the norms and the rope key are computed alike on every
    rank, and the three enter the heads' split through one
    ``copy_to_model``.  A leaf ``param_specs`` leaves whole gives its
    latent from the replicated ``x`` directly; heads that reach past a
    rank's pieces (heads the axis does not divide) are gathered by
    ``take``."""
    B, T, d = x.shape
    H, nope, rd = cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    xin = tp_mod.copy_to_model(x, tp)

    def latent(name):
        if tp_mod.split_on(held[name], 1) is None:
            return x @ params[name]
        return tp_mod.gather_replicated(xin @ params[name], tp, -1)

    qa = rmsnorm(params["q_norm"], latent("wq_a"))
    kv_a = latent("wkv_a")
    ckv = rmsnorm(params["kv_norm"], kv_a[..., :rkv])
    k_rope = apply_rope(kv_a[..., rkv:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    qa, ckv, k_rope = tp_mod.copy_to_model(
        torch.cat([qa, ckv, k_rope], dim=-1), tp).split([rq, rkv, rd], -1)

    lo, hi = tp_mod.split_range(H * nope, tp)
    h0, h1 = lo // nope, -(-hi // nope)  # the heads that cover [lo, hi)
    nh = h1 - h0
    wq_b = tp_mod.take(params["wq_b"], 1, held["wq_b"], h0 * (nope + rd),
                       h1 * (nope + rd), tp)
    wkv_b = tp_mod.take(params["wkv_b"], 1, held["wkv_b"], h0 * 2 * nope,
                        h1 * 2 * nope, tp)
    q = (qa @ wq_b).reshape(B, T, nh, nope + rd)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kvb = (ckv @ wkv_b).reshape(B, T, nh, 2 * nope)
    k = torch.cat([kvb[..., :nope],
                   k_rope[:, :, None, :].expand(B, T, nh, rd)], dim=-1)
    qf = torch.cat([q[..., :nope], q_rope], dim=-1)
    out = attention(qf, k, kvb[..., nope:], causal=True, window=window)
    out = out.reshape(B, T, nh * nope).narrow(2, lo - h0 * nope, hi - lo)
    wo = tp_mod.take(params["wo"], 0, held["wo"], lo, hi, tp)
    return tp_mod.reduce_from_model(out @ wo, tp)


def _mla_decode_split(params, held, cfg, x, positions, cache, cache_index,
                      window, tp):
    """The absorbed decode step of MLA on this rank's block of the latent
    cache's length: the latents whole on every rank (as ``_mla_split``
    forms them), written by the block's owner; the absorbed queries of
    the rank's heads (all heads where the axis does not divide them)
    all-gathered; the softmax of every head over the rank's positions and
    its weighted latents merged over "model"; then ``w_uv`` and ``wo``
    for the columns [lo, hi) of the heads' output, the row-split product
    all-reduced."""
    B, T, d = x.shape
    H, nope, rd = cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim
    rkv = cfg.kv_lora_rank
    if T != 1:
        raise ValueError("a latent cache split over \"model\" decodes one "
                         "token")
    qa = rmsnorm(params["q_norm"], _whole_columns(x, params["wq_a"],
                                                  held["wq_a"], tp))
    kv_a = _whole_columns(x, params["wkv_a"], held["wkv_a"], tp)
    ckv = rmsnorm(params["kv_norm"], kv_a[..., :rkv])
    k_rope = apply_rope(kv_a[..., rkv:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    ckv = _write_split(cache["ckv"], ckv, cache_index, tp)
    k_rope = _write_split(cache["krope"], k_rope, cache_index, tp)

    # the heads whose queries this rank forms: its own block, gathered,
    # where the axis divides the heads; otherwise every head
    even = H % tp.size == 0
    a0, a1 = (tp.rank * H // tp.size, (tp.rank + 1) * H // tp.size) \
        if even else (0, H)
    wq_b = tp_mod.take(params["wq_b"], 1, held["wq_b"], a0 * (nope + rd),
                       a1 * (nope + rd), tp)
    wkv_b = tp_mod.take(params["wkv_b"], 1, held["wkv_b"], a0 * 2 * nope,
                        a1 * 2 * nope, tp).reshape(rkv, a1 - a0, 2 * nope)
    q = (qa @ wq_b).reshape(B, T, a1 - a0, nope + rd)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    q_abs = torch.einsum("bthn,rhn->bthr", q[..., :nope], wkv_b[..., :nope])
    if even:
        q_abs = tp_mod.gather_replicated(q_abs, tp, 2)
        q_rope = tp_mod.gather_replicated(q_rope, tp, 2)
    s = torch.einsum("bthr,blr->bhtl", q_abs.to(F32), ckv.to(F32))
    s = s + torch.einsum("bthr,blr->bhtl", q_rope.to(F32), k_rope.to(F32))
    s = s / math.sqrt(nope + rd)
    width = ckv.shape[1]
    l_pos = tp.rank * width + torch.arange(width, device=x.device)
    mask = l_pos[None, None, None, :] <= cache_index
    if window:
        mask = mask & (l_pos[None, None, None, :] > cache_index - window)
    s = torch.where(mask, s, torch.tensor(_NEG_INF, dtype=F32,
                                          device=s.device))
    p = torch.exp(s - tp_mod.max_over_model(torch.amax(s, dim=-1), tp)[
        ..., None])
    l, o_lat = _merge_sums(torch.sum(p, dim=-1), torch.einsum(
        "bhtl,blr->bhtr", p, ckv.to(F32)), tp)
    o_lat = (o_lat / l[..., None]).transpose(1, 2)  # (B,1,H,rkv)

    lo, hi = tp_mod.split_range(H * nope, tp)
    h0, h1 = lo // nope, -(-hi // nope)  # the heads that cover [lo, hi)
    out = torch.einsum("bthr,rhn->bthn", o_lat[:, :, h0:h1],
                       wkv_b[:, h0 - a0:h1 - a0, nope:].to(F32)).to(x.dtype)
    out = out.reshape(B, T, (h1 - h0) * nope).narrow(2, lo - h0 * nope,
                                                     hi - lo)
    wo = tp_mod.take(params["wo"], 0, held["wo"], lo, hi, tp)
    return (tp_mod.reduce_from_model(out @ wo, tp),
            {"ckv": ckv, "krope": k_rope})


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(rng: Draw, d, f, dtype):
    return {
        "w_gate": dense_init(rng, d, f, dtype),
        "w_up": dense_init(rng, d, f, dtype),
        "w_down": dense_init(rng, f, d, dtype, scale=1.0 / math.sqrt(f)),
    }


def swiglu_forward(params, x, tp=None, d_ff=0, held=None):
    """SwiGLU; with ``tp`` (a ``ModelAxis``) and ``held`` (the leaves'
    held specs), this rank's block of the hidden dimension ``d_ff``
    (column-split ``w_gate``/``w_up``, row-split ``w_down``) and one
    all-reduce."""
    if tp is not None:
        return tp_mod.reduce_from_model(swiglu_partial(
            params, tp_mod.copy_to_model(x, tp), tp, d_ff, held), tp)
    h = F.silu((x @ params["w_gate"]).to(F32)).to(x.dtype) * (
        x @ params["w_up"]
    )
    h = maybe_constrain(h, "data", None, "model")
    return h @ params["w_down"]


def swiglu_partial(params, xin, tp=None, d_ff=0, held=None):
    """The SwiGLU's product on ``xin``; with ``tp``, this rank's partial
    of it (``xin`` has entered the split through ``copy_to_model``): the
    hidden block [lo, hi) of ``d_ff``, whose row-split product the ranks
    sum (``swiglu_forward``, or a caller that sums it with its own)."""
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if tp is not None:
        lo, hi = tp_mod.split_range(int(d_ff), tp)
        wg, wu, wd = (tp_mod.take(params[n], dim, held[n], lo, hi, tp)
                      for n, dim in (("w_gate", 1), ("w_up", 1),
                                     ("w_down", 0)))
    h = F.silu((xin @ wg).to(F32)).to(xin.dtype) * (xin @ wu)
    return h @ wd
