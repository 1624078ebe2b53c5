"""The model zoo's parts, the port's against the reference's functions
on the same inputs (numpy, f32), as ``tests/test_model_parts.py`` and
``tests/test_models_smoke.py`` hold the reference's:

- the chunked SSD scan against a float64 sequential recurrence (rtol
  2e-4, the reference test's) and against the reference's
  ``_ssd_chunked`` with a carried state, value and gradient (1e-5 of the
  scale); at the real chunk of 256 the port's masked exponent keeps
  every gradient finite and equals the reference's wherever that is;
- the MoE scatter against a dense loop over experts (2e-3, the
  reference test's) and against the reference's ``moe_forward`` (1e-5);
  at capacity factor 0.1 the dropped (token, choice) pairs equal, as a
  set, those of a transcription of the reference's routing;
- chunked attention at Tk = 48 (one pass) and Tk = 4,096 (the chunked
  loop) against plain softmax (2e-4) and the reference (1e-5);
- MLA's absorbed decode against the expanded math (1e-3, the reference
  test's) and each step against the reference's (1e-5);
- the chunked CE against the direct one (rtol 1e-5) and the reference's,
  with its gradient;
- the sliding window, hubert's masked loss, the VLM with an open gate
  and MoE's aux losses, each also against the reference (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro.models import model as r_model
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm

import _torch_models as tmh

REL = 1e-5
KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _both_cfgs(**kw):
    return r_model.ModelConfig(**kw), t_model.ModelConfig(**kw)


def _ssm_cfgs(chunk):
    return _both_cfgs(
        name="t", n_layers=1, d_model=32, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=16, mixer_pattern=("ssm",), mlp_pattern=("none",),
        ssm_state=8, ssm_head_dim=4, ssm_chunk=chunk, dtype="float32")


def _ssd_inputs(seed, Bsz, seq, H, P, N, dt_scale=0.5):
    rng = np.random.RandomState(seed)
    return (rng.randn(Bsz, seq, H, P).astype(np.float32),
            (rng.rand(Bsz, seq, H) * dt_scale).astype(np.float32),
            rng.randn(Bsz, seq, N).astype(np.float32),
            rng.randn(Bsz, seq, N).astype(np.float32),
            -(rng.rand(H) + 0.1).astype(np.float32))


def _ssd_sequential(xh, dt, B_mat, C_mat, A, h0=None):
    """Naive O(S) state recurrence in float64: h_t = exp(dt_t A) h_{t-1} +
    dt_t B_t x_t, y_t = C_t . h_t (per head/headdim)."""
    xh, dt, B_mat, C_mat, A = (np.asarray(a, np.float64)
                               for a in (xh, dt, B_mat, C_mat, A))
    Bsz, S, H, P = xh.shape
    N = B_mat.shape[-1]
    h = np.zeros((Bsz, H, P, N)) if h0 is None else np.array(h0, np.float64)
    ys = np.zeros((Bsz, S, H, P))
    for t in range(S):
        decay = np.exp(dt[:, t] * A[None])
        h = h * decay[:, :, None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xh[:, t], B_mat[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", h, C_mat[:, t])
    return ys, h


@pytest.mark.parametrize("seq,chunk", [(8, 4), (16, 4), (13, 8), (32, 32)])
def test_ssd_chunked_matches_sequential(seq, chunk):
    _, cfg = _ssm_cfgs(chunk)
    ins = _ssd_inputs(0, 2, seq, 3, 4, 8)
    y, h = t_ssm._ssd_chunked(cfg, *map(_t, ins))
    y_ref, h_ref = _ssd_sequential(*ins)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=2e-4, atol=2e-4)


def _ssd_loss_ref(rcfg):
    def loss(xh, dt, Bm, Cm, A, h0):
        y, h = r_ssm._ssd_chunked(rcfg, xh, dt, Bm, Cm, A, init_state=h0)
        return jnp.sum(y ** 2) + jnp.sum(h ** 2), (y, h)
    return jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)


def _ssd_loss_port(cfg, ins):
    ts = [_t(a).requires_grad_(True) for a in ins]
    y, h = t_ssm._ssd_chunked(cfg, *ts[:5], init_state=ts[5])
    loss = torch.sum(y ** 2) + torch.sum(h ** 2)
    return loss, y, h, torch.autograd.grad(loss, ts)


def test_ssd_carried_state_and_grad_match_reference():
    """A carried state in, 12 steps over chunks of 4 (the last padded in
    a 13-step run too): output, final state and the gradient of
    sum(y^2) + sum(h^2) in every input against the reference's."""
    rcfg, cfg = _ssm_cfgs(4)
    for seq in (12, 13):
        ins = list(_ssd_inputs(1, 1, seq, 2, 4, 8))
        ins.append(np.random.RandomState(2).randn(1, 2, 4, 8).astype(np.float32))
        (rl, (ry, rh)), rg = _ssd_loss_ref(rcfg)(*map(jnp.asarray, ins))
        loss, y, h, grads = _ssd_loss_port(cfg, ins)
        np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=REL)
        tmh.assert_scaled_close(y.detach(), ry, REL, "y")
        tmh.assert_scaled_close(h.detach(), rh, REL, "h")
        for name, a, b in zip(("x", "dt", "B", "C", "A", "h0"), grads, rg):
            tmh.assert_scaled_close(a, b, REL, f"d{name} at S={seq}")


def test_ssd_split_calls_equal_one_pass():
    """Splitting a sequence across two calls with the carried state equals
    one full pass (prefill-then-decode consistency)."""
    _, cfg = _ssm_cfgs(4)
    xh, dt, Bm, Cm, A = map(_t, _ssd_inputs(1, 1, 12, 2, 4, 8))
    y_full, h_full = t_ssm._ssd_chunked(cfg, xh, dt, Bm, Cm, A)
    y1, h1 = t_ssm._ssd_chunked(cfg, xh[:, :8], dt[:, :8], Bm[:, :8],
                                Cm[:, :8], A)
    y2, h2 = t_ssm._ssd_chunked(cfg, xh[:, 8:], dt[:, 8:], Bm[:, 8:],
                                Cm[:, 8:], A, init_state=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_ssd_masked_exponent_keeps_the_real_chunk_finite():
    """At the real chunk (256 steps, A = (-1, -16), dt = 0.1) exp(segsum)
    above the diagonal overflows: the reference's gradient in dt is not
    finite there, the port's is, and equals the reference's wherever the
    reference's is finite; the loss and the gradient in x agree."""
    rcfg, cfg = _ssm_cfgs(256)
    rng = np.random.RandomState(3)
    S, H, P, N = 256, 2, 4, 8
    ins = [rng.randn(1, S, H, P).astype(np.float32),
           np.full((1, S, H), 0.1, np.float32),
           rng.randn(1, S, N).astype(np.float32),
           rng.randn(1, S, N).astype(np.float32),
           np.array([-1.0, -16.0], np.float32),
           np.zeros((1, H, P, N), np.float32)]
    (rl, _), rg = _ssd_loss_ref(rcfg)(*map(jnp.asarray, ins))
    loss, _, _, grads = _ssd_loss_port(cfg, ins)
    assert np.isfinite(float(rl))
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=REL)
    tmh.assert_scaled_close(grads[0], rg[0], REL, "dx")
    ref_dt, port_dt = np.asarray(rg[1]), grads[1].numpy()
    assert not np.all(np.isfinite(ref_dt))  # the reference-side caveat
    assert np.all(np.isfinite(port_dt))
    finite = np.isfinite(ref_dt)
    tmh.assert_scaled_close(port_dt[finite], ref_dt[finite], REL, "dt")
    for g in grads:
        assert torch.all(torch.isfinite(g))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_cfgs(**kw):
    return _both_cfgs(
        name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=8,
        vocab=16, mlp_pattern=("moe",), n_experts=4, experts_per_token=2,
        dtype="float32", **kw)


def _moe_params(rcfg):
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: r_moe.init_moe(k, rcfg, jnp.float32))(KEY))
    return np_params, t_model.params_from_numpy(np_params, device="cpu")


def _ref_moe(rcfg, capacity_factor=1.25):
    return jax.jit(lambda p, x: r_moe.moe_forward(
        p, rcfg, x, capacity_factor=capacity_factor))


def test_moe_scatter_matches_expert_loop_and_reference():
    rcfg, cfg = _moe_cfgs(capacity_factor=64.0)  # no drops
    np_params, params = _moe_params(rcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 16)))
    out = t_moe.moe_forward(params, cfg, _t(x), capacity_factor=64.0)
    ref = _ref_moe(rcfg, 64.0)(jax.tree_util.tree_map(jnp.asarray, np_params),
                               jnp.asarray(x))
    tmh.assert_scaled_close(out.out, ref.out, REL, "moe out")

    # dense loop over every expert, combined with the same gates
    xt = _t(x).reshape(-1, 16)
    probs = torch.softmax(xt @ params["router"], dim=-1)
    gates, ids = t_moe.top_k(probs, 2)
    gates = gates / gates.sum(-1, keepdim=True)
    expert_outs = torch.stack([
        (torch.nn.functional.silu(xt @ params["w_gate"][e])
         * (xt @ params["w_up"][e])) @ params["w_down"][e] for e in range(4)])
    T = xt.shape[0]
    loop = sum(expert_outs[ids[:, kk], torch.arange(T)] * gates[:, kk, None]
               for kk in range(2))
    np.testing.assert_allclose(out.out.reshape(-1, 16).numpy(), loop.numpy(),
                               rtol=2e-3, atol=2e-3)


def _ref_drops(params, rcfg, xt, capacity_factor):
    """The reference's routing (``repro/models/moe.py:75-101``) transcribed
    in jnp, returning its set of dropped (token, choice) pairs."""
    E, K = rcfg.n_experts, rcfg.experts_per_token
    T = xt.shape[0]
    probs = jax.nn.softmax(xt @ params["router"], axis=-1)
    _, expert_ids = jax.lax.top_k(probs, K)
    capacity = max(1, int(capacity_factor * T * K / E))
    counts = jnp.zeros((E,), jnp.int32)
    drops = set()
    for kk in range(K):
        ids_k = expert_ids[:, kk]
        onehot = jax.nn.one_hot(ids_k, E, dtype=jnp.int32)
        intra = jnp.cumsum(onehot, axis=0) - onehot
        pos_k = jnp.sum(intra * onehot, axis=-1) + counts[ids_k]
        drops |= {(int(t), kk) for t in np.nonzero(~np.asarray(pos_k < capacity))[0]}
        counts = counts + jnp.sum(onehot, axis=0)
    return drops


def test_moe_capacity_drops_the_references_pairs():
    """test_moe_capacity_drops_tokens' case: capacity factor 0.1 drops most
    choices; the port drops exactly the reference's (token, choice) pairs,
    its output equals the reference's and shrinks against capacity 64."""
    rcfg, cfg = _moe_cfgs()
    np_params, params = _moe_params(rcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 32, 16)))
    xt = _t(x).reshape(-1, 16)
    _, _, _, keeps, capacity, _ = t_moe.route(params, cfg, xt, 0.1)
    port_drops = {(int(t), int(k)) for t, k in torch.nonzero(~keeps).tolist()}
    ref_drops = _ref_drops(jax.tree_util.tree_map(jnp.asarray, np_params),
                           rcfg, jnp.asarray(x).reshape(-1, 16), 0.1)
    # 64 tokens x 2 choices into 4 experts of 3 slots: at most 12 kept
    assert capacity == 3 and len(port_drops) >= 64 * 2 - 4 * 3
    assert port_drops == ref_drops
    rparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tight = t_moe.moe_forward(params, cfg, _t(x), capacity_factor=0.1)
    full = t_moe.moe_forward(params, cfg, _t(x), capacity_factor=64.0)
    ref = _ref_moe(rcfg, 0.1)(rparams, jnp.asarray(x))
    tmh.assert_scaled_close(tight.out, ref.out, REL, "moe out at 0.1")
    assert float(torch.linalg.norm(tight.out)) < float(torch.linalg.norm(full.out))


def test_top_k_breaks_ties_by_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    vals, ids = t_moe.top_k(probs, 2)
    rvals, rids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


def test_moe_aux_losses_match_reference():
    """The load-balance and router z losses of one MoE layer, against the
    reference's ``moe_forward`` on the same weights and tokens."""
    rcfg, cfg = _moe_cfgs()
    np_params, params = _moe_params(rcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 16, 16)))
    out = t_moe.moe_forward(params, cfg, _t(x))
    ref = _ref_moe(rcfg)(jax.tree_util.tree_map(jnp.asarray, np_params),
                         jnp.asarray(x))
    assert float(out.lb_loss) > 0.0 and float(out.z_loss) >= 0.0
    np.testing.assert_allclose(float(out.lb_loss), float(ref.lb_loss), rtol=REL)
    np.testing.assert_allclose(float(out.z_loss), float(ref.z_loss), rtol=REL)
    tmh.assert_scaled_close(out.out, ref.out, REL, "moe out")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Tk,chunk_hit", [(48, False), (4096, True)])
def test_chunked_attention_matches_plain_and_reference(Tk, chunk_hit):
    rng = np.random.RandomState(3)
    B, Tq, H, KV, hd = 1, 8, 4, 2, 16
    q = rng.randn(B, Tq, H, hd).astype(np.float32)
    k = rng.randn(B, Tk, KV, hd).astype(np.float32)
    v = rng.randn(B, Tk, KV, hd).astype(np.float32)
    assert (Tk > 1024) == chunk_hit
    out = t_layers.attention(_t(q), _t(k), _t(v), causal=True,
                             q_offset=Tk - Tq, chunk=1024).numpy()
    ref = r_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, q_offset=Tk - Tq, chunk=1024)
    tmh.assert_scaled_close(out, ref, REL, "attention")
    kr = np.repeat(k, H // KV, axis=2)
    vr = np.repeat(v, H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(hd)
    q_pos = (Tk - Tq) + np.arange(Tq)
    s = np.where((np.arange(Tk)[None, :] <= q_pos[:, None])[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    plain = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vr)
    np.testing.assert_allclose(out, plain, rtol=2e-4, atol=2e-4)


def test_chunked_attention_with_window_and_padding_matches_reference():
    """Tk = 2,500 (a padded last chunk) under a window of 700, from an
    offset: the chunked loop's masks against the reference's."""
    rng = np.random.RandomState(4)
    q = rng.randn(2, 40, 4, 8).astype(np.float32)
    k = rng.randn(2, 2500, 2, 8).astype(np.float32)
    v = rng.randn(2, 2500, 2, 8).astype(np.float32)
    kw = dict(causal=True, window=700, q_offset=2460, chunk=1024)
    out = t_layers.attention(_t(q), _t(k), _t(v), **kw)
    ref = r_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    tmh.assert_scaled_close(out, ref, REL, "windowed attention")


# ---------------------------------------------------------------------------
# MLA absorbed decode
# ---------------------------------------------------------------------------

def test_mla_absorbed_decode_equals_expanded_math_and_reference():
    rcfg, cfg = _both_cfgs(
        name="mla", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=16, attn_kind="mla", q_lora_rank=24, kv_lora_rank=16,
        qk_rope_dim=8, head_dim=16, dtype="float32")
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: r_layers.init_mla(k, rcfg, jnp.float32))(KEY))
    rparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = t_model.params_from_numpy(np_params, device="cpu")
    B, S = 2, 10
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (B, S, 64)))
    positions = torch.arange(S)[None].expand(B, S)
    out_full, _ = t_layers.mla_forward(params, cfg, _t(x), positions=positions)
    cache = {"ckv": torch.zeros(B, S, 16), "krope": torch.zeros(B, S, 8)}
    rcache = {"ckv": jnp.zeros((B, S, 16)), "krope": jnp.zeros((B, S, 8))}
    ref_step = jax.jit(lambda p, xt, c, t: r_layers.mla_forward(
        p, rcfg, xt, positions=jnp.full((B, 1), t), cache=c, cache_index=t))
    for t in range(S):
        out_t, cache = t_layers.mla_forward(
            params, cfg, _t(x[:, t:t + 1]), positions=torch.full((B, 1), t),
            cache=cache, cache_index=t)
        ref_t, rcache = ref_step(rparams, jnp.asarray(x[:, t:t + 1]), rcache, t)
        tmh.assert_scaled_close(out_t, ref_t, REL, f"mla decode step {t}")
        tmh.assert_scaled_close(cache["ckv"], rcache["ckv"], REL, "ckv")
    np.testing.assert_allclose(out_t[:, 0].numpy(), out_full[:, -1].numpy(),
                               rtol=1e-3, atol=1e-3)


def test_cache_write_clamps_like_dynamic_update_slice():
    """A write that would run past the cache's end lands at its last
    fitting start, as ``jax.lax.dynamic_update_slice`` places it."""
    buf = np.zeros((1, 6, 2), np.float32)
    upd = np.ones((1, 2, 2), np.float32)
    for index in (0, 3, 4, 5, 9):
        got = t_layers._write_at(_t(buf), _t(upd), index).numpy()
        want = np.asarray(jax.lax.dynamic_update_slice(
            jnp.asarray(buf), jnp.asarray(upd), (0, index, 0)))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# chunked CE
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_direct_and_reference():
    rcfg, cfg = _both_cfgs(name="c", n_layers=1, d_model=8, n_heads=1,
                           n_kv_heads=1, d_ff=8, vocab=11, logit_chunk=3,
                           dtype="float32")
    rng = np.random.RandomState(5)
    B, S = 2, 7
    h = rng.randn(B, S, 8).astype(np.float32)
    un = rng.randn(8, 11).astype(np.float32)
    tgt = rng.randint(0, 11, (B, S)).astype(np.int32)
    valid = rng.rand(B, S) > 0.3
    th = _t(h).requires_grad_(True)
    loss = t_model._chunked_ce(cfg, th, _t(un), _t(tgt), _t(valid))
    (g,) = torch.autograd.grad(loss, [th])
    logits = h @ un
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    gold = np.take_along_axis(logits, tgt[..., None], axis=-1)[..., 0]
    direct = ((lse - gold) * valid).sum() / valid.sum()
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), direct, rtol=1e-5)
    f = lambda hh: r_model._chunked_ce(rcfg, hh, jnp.asarray(un),  # noqa: E731
                                       jnp.asarray(tgt), jnp.asarray(valid))
    rl, rg = jax.value_and_grad(f)(jnp.asarray(h))
    np.testing.assert_allclose(float(loss), float(rl), rtol=REL)
    tmh.assert_scaled_close(g, rg, REL, "d h")
    assert float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# whole-model behaviours
# ---------------------------------------------------------------------------

def test_sliding_window_masks_old_tokens_as_the_reference():
    """With window 8, the last logits do not depend on a token outside the
    window and do on one inside; each prefill equals the reference's."""
    rcfg, cfg = tmh.configs("minitron_8b", sliding_window=8)
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: r_model.init_params(k, rcfg))(KEY))
    rparams = tmh.to_jax(np_params)
    params = t_model.params_from_numpy(np_params, device="cpu")
    ref_prefill = jax.jit(lambda p, b: r_model.apply_prefill(p, rcfg, b))
    tokens = np.random.RandomState(6).randint(0, cfg.vocab, (1, 24)).astype(np.int32)
    far, near = tokens.copy(), tokens.copy()
    far[0, 2] = (far[0, 2] + 1) % cfg.vocab
    near[0, 22] = (near[0, 22] + 1) % cfg.vocab
    outs = []
    for tok in (tokens, far, near):
        with torch.no_grad():
            got = t_model.apply_prefill(params, cfg, {"tokens": _t(tok)}).numpy()
        ref = ref_prefill(rparams, {"tokens": jnp.asarray(tok)})
        tmh.assert_scaled_close(got, ref, REL, "windowed prefill")
        outs.append(got)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    assert np.max(np.abs(outs[0] - outs[2])) > 1e-6


def test_hubert_masked_loss_only_counts_masked():
    pair = tmh.Pair("hubert_xlarge")
    batch = tmh.numpy_batch(pair.rcfg, seq=16)
    batch["mask"] = np.zeros_like(batch["mask"])
    batch["mask"][:, :4] = True
    flipped = dict(batch, targets=batch["targets"].copy())
    flipped["targets"][:, 8:] = (flipped["targets"][:, 8:] + 1) % pair.tcfg.vocab
    losses = []
    ref_train = jax.jit(lambda p, b: r_model.apply_train(p, pair.rcfg, b))
    for b in (batch, flipped):
        with torch.no_grad():
            loss, _ = t_model.apply_train(pair.params, pair.tcfg, tmh.to_torch(b))
        ref, _ = ref_train(pair.ref_params, tmh.to_jax(b))
        np.testing.assert_allclose(float(loss), float(ref), rtol=REL)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_vlm_cross_attention_sees_vision():
    """With the gates open (0.5) in the carried weights, the prefill logits
    move with the vision tokens, as the reference's do."""
    pair = tmh.Pair("llama32_vision_90b")
    moved = dict(pair.batch, vision=pair.batch["vision"] + 1.0)
    with torch.no_grad():
        l1 = pair.port_prefill()
        l2 = t_model.apply_prefill(pair.params, pair.tcfg,
                                   tmh.to_torch(moved)).numpy()
    r2 = pair.ref_prefill_of(moved)
    tmh.assert_scaled_close(l2, r2, REL, "vlm prefill, moved vision")
    assert np.max(np.abs(l1 - l2)) > 1e-6
    gates = [g for g in pair.params["body"][0]["mixer"]["gate"].flatten()]
    assert all(float(g) == tmh.GATE for g in gates)
