"""The port's CenteredClip kernels and the bucketed coordinate median
against the JAX reference, on the CPU.

On CPU tensors the wrappers of ``repro_torch.kernels.centered_clip`` and
``clip_aggregate`` run their kernels' plain PyTorch versions, so these
tests hold the plain versions (the kernels' arithmetic) against the
reference's Pallas kernels in interpret mode (``repro.kernels.ops``), on
both CenteredClip schedules:

  resident  the reference's one-launch kernel (its VMEM rule admits these
            shapes) against the port's ``clip_then_centered_clip``, which
            the shared-memory rule sends to ``cclip_resident`` here;
  tiled     the reference forced onto its tiled schedule by a
            ``reduce_fn`` (any ``reduce_fn`` bypasses the resident branch),
            against the port's tiled functions called directly.

Inputs are numpy arrays made from seeds.  Tolerances: f32 rtol 1e-5 with
atol 1e-6; bf16 outputs are rounded from f32 values that agree to about
1e-6, so they may differ by one bf16 step (2^-7 relative).  The bucketed
median takes the reference's permutation ``jax.random.permutation(key,
n_p)`` and is exact away from ties.  The CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py, on the card.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.aggregators as ragg
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import aggregators as tagg
from repro_torch.kernels import clip_aggregate as ca
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# the package re-exports functions under the modules' names
cc = importlib.import_module("repro_torch.kernels.centered_clip")
rcc = importlib.import_module("repro.kernels.centered_clip")

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
# (n, d, s): the Fig. 1 shape, odd n with padding, wider rows
CASES = [(20, 40, 1), (20, 40, 2), (21, 700, 2), (21, 700, 3),
         (11, 1500, 2), (11, 1500, 1)]
TAU, ITERS = 1.5, 5  # tau below the rows' spread, so the clip engages


def _identity(v):
    """A ``reduce_fn`` that sums nothing: it forces the reference's tiled
    schedule without changing its numbers."""
    return v


def _case(n, d, s, seed, masked=True):
    """Rows, a mask (random with row 0 in; all rows when ``masked`` is
    False; none when it is "none"), a row order and a clip radius."""
    rng = np.random.RandomState(seed)
    xs = (rng.randn(n, d) * (1.0 + rng.rand(n, 1))).astype(np.float32)
    mask = rng.rand(n) > 0.3
    mask[0] = True
    if masked is False:
        mask[:] = True
    elif masked == "none":
        mask[:] = False
    idx = rng.permutation(n).astype(np.int32)
    norms = np.linalg.norm(xs, axis=1)
    return xs, mask, idx, float(np.median(norms))  # clips about half


def _inputs(xs, mask, idx, dtype):
    xt = torch.from_numpy(xs)
    xj = jnp.asarray(xs)
    if dtype == "bf16":
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    return (xt, torch.from_numpy(mask), torch.from_numpy(idx.astype(np.int64)),
            xj, jnp.asarray(mask), jnp.asarray(idx))


def _port_tiled(xs, radius, mask, idx, s, use_clip=True):
    """The port's tiled schedule, called directly: pass 1, the padded
    auxiliaries, (s >= 2) the bucket means, then ``cclip_tiled``."""
    n = xs.shape[0]
    factors = (cc.clip_factor(ops.row_norms(xs), radius) if use_clip
               else torch.ones(n))
    m, f, i = cc.pad_bucket_aux(mask.float(), factors, idx, n, s)
    if s >= 2:
        means, ok = cc.bucket_means_tiled(xs, m, f, i, s)
        out = cc.cclip_tiled(means, ok, None, iters=ITERS, tau=TAU)
    else:
        out = cc.cclip_tiled(xs, m, f, iters=ITERS, tau=TAU)
    return out.to(xs.dtype)


def _assert_close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(BF16_TOL if dtype == "bf16" else F32_TOL))


@pytest.mark.parametrize("n,d,s", CASES, ids=str)
@pytest.mark.parametrize("schedule", ["resident", "tiled"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_clip_cclip_matches_pallas_interpret(n, d, s, schedule, dtype):
    xs, mask, idx, radius = _case(n, d, s, n * 31 + d + s)
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, dtype)
    rfn = _identity if schedule == "tiled" else None
    want, wnorms = rops.clip_then_centered_clip(
        xj, radius, mj, ij, bucket_s=s, tau=TAU, iters=ITERS, reduce_fn=rfn)
    if schedule == "resident":
        assert cc.resident_smem_bytes(-(-n // s), d, "cclip") \
            <= cc.H100_SMEM_OPTIN
        got, norms = ops.clip_then_centered_clip(xt, radius, mt, it,
                                                 bucket_s=s, tau=TAU,
                                                 iters=ITERS)
        np.testing.assert_allclose(norms.numpy(), np.asarray(wnorms),
                                   rtol=1e-5)
    else:
        got = _port_tiled(xt, radius, mt, it, s)
    assert got.dtype == xt.dtype
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype)
    if dtype == "f32":
        oracle, _ = rref.clip_then_centered_clip_ref(
            xj, radius, mj, ij, bucket_s=s, tau=TAU, iters=ITERS)
        _assert_close(got.numpy(), oracle, "f32")
        own, _ = tref.clip_then_centered_clip_ref(
            xt, radius, mt, it, bucket_s=s, tau=TAU, iters=ITERS)
        _assert_close(own.numpy(), oracle, "f32")


@pytest.mark.parametrize("d", [1, 31, 33, 40])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("iters", [0, ITERS])
def test_cclip_resident_block_tiers_match_pallas_interpret(d, s, iters):
    """The widths where the card's resident kernel changes its block (one
    coordinate; one warp's 32 coordinates and one past them; Fig. 1's 40)
    and ``iters = 0`` (v0 alone), at n = 21: the plain twin that the card
    tests hold ``cclip_resident`` against is itself pinned to the
    reference's resident kernel there."""
    xs, mask, idx, radius = _case(21, d, s, 7 * d + s + iters)
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, "f32")
    want, _ = rops.clip_then_centered_clip(xj, radius, mj, ij, bucket_s=s,
                                           tau=TAU, iters=iters)
    got, _ = ops.clip_then_centered_clip(xt, radius, mt, it, bucket_s=s,
                                         tau=TAU, iters=iters)
    _assert_close(got.numpy(), want, "f32")


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("schedule", ["resident", "tiled"])
def test_cclip_all_masked_gives_zero_as_in_reference(s, schedule):
    """No sampled row: v0 = 0 / max(0, 1) and every scale is 0, so the
    result is 0."""
    xs, mask, idx, radius = _case(21, 700, s, 40 + s, masked="none")
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, "f32")
    rfn = _identity if schedule == "tiled" else None
    want, _ = rops.clip_then_centered_clip(xj, radius, mj, ij, bucket_s=s,
                                           tau=TAU, iters=ITERS, reduce_fn=rfn)
    got = (ops.clip_then_centered_clip(xt, radius, mt, it, bucket_s=s,
                                       tau=TAU, iters=ITERS)[0]
           if schedule == "resident" else _port_tiled(xt, radius, mt, it, s))
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    np.testing.assert_array_equal(got.numpy(), 0.0)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("shape", [(20, 40), (7, 33), (64, 130)], ids=str)
@pytest.mark.parametrize("tau", [0.5, 10.0])
def test_centered_clip_matches_pallas_interpret(shape, masked, tau):
    xs, mask, _, _ = _case(*shape, 1, sum(shape), masked)
    m = mask if masked else None
    got = ops.centered_clip(torch.from_numpy(xs),
                            None if m is None else torch.from_numpy(m),
                            tau=tau)
    want = rops.centered_clip(jnp.asarray(xs),
                              None if m is None else jnp.asarray(m), tau=tau)
    _assert_close(got.numpy(), want, "f32")
    _assert_close(tref.centered_clip_ref(
        torch.from_numpy(xs), tau, 5,
        mask=None if m is None else torch.from_numpy(m)).numpy(),
        rref.centered_clip_ref(jnp.asarray(xs), tau, 5,
                               None if m is None else jnp.asarray(m)), "f32")


@pytest.mark.parametrize("bucket_s", [0, 2, 3])
@pytest.mark.parametrize("n,d", [(20, 40), (21, 130), (16, 4096)], ids=str)
def test_centered_clip_rule_matches_reference(bucket_s, n, d):
    """The registry rule on the plain backend against the reference's jnp
    rule, and the kernel backend's composition (on CPU tensors, the plain
    versions) against the reference's pallas rule, in the reference's
    Bucketing order, unclipped and clipped."""
    xs, mask, _, radius = _case(n, d, 1, n + d + bucket_s)
    key = jax.random.PRNGKey(n + bucket_s)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, n)))
    xt, mt, xj, mj = (torch.from_numpy(xs), torch.from_numpy(mask),
                      jnp.asarray(xs), jnp.asarray(mask))
    kw = dict(tau=TAU, iters=4)
    for backend in ("jnp", "pallas"):
        ref = ragg.make_aggregator("cclip", bucket_s, backend=backend, **kw)
        port = tagg.make_aggregator("cclip", bucket_s, backend=backend, **kw)
        assert port.name == ref.name and port.is_aragg == ref.is_aragg
        assert port.f_a(d) == ref.f_a(d)
        if backend == "pallas":  # a CPU tensor runs the plain versions
            fns = tagg._kernel_fns(ops.clip_then_centered_clip, bucket_s,
                                   **kw)
        else:
            fns = (port, lambda x, r, m, key: port.clip_then_aggregate(
                x, r, m, key=key))
        _assert_close(fns[0](xt, mt, key=perm).numpy(),
                      ref(xj, mj, key=key), "f32")
        _assert_close(fns[1](xt, radius, mt, key=perm).numpy(),
                      ref.clip_then_aggregate(xj, radius, mj, key=key), "f32")


def test_cclip_resident_rule_counts_its_own_shared_memory():
    """CenteredClip's resident kernel is admitted by its own count (the
    rows, v, its two per-row weights m and s and the warp sums), which
    equals GM's layout: at n = 20 both admit d <= 2,750 unbucketed and
    d <= 5,266 under Bucketing(2), and the dispatch of each rule takes its
    own count."""
    budget = cc.H100_SMEM_OPTIN
    for s, rows, d_max in ((1, 20, 2750), (2, 10, 5266)):
        for rule in ("gm", "cclip"):
            assert cc.resident_smem_bytes(rows, d_max, rule) <= budget
            assert cc.resident_smem_bytes(rows, d_max + 1, rule) > budget
        for d, expect in ((d_max, "resident"), (d_max + 1, "tiled")):
            took = []
            cc.run_clip_then_iterative(
                torch.zeros(20, d), 1.0, None, None, bucket_s=s,
                use_clip=False, rule="cclip",
                resident_fn=lambda *a: took.append("resident") or a[0][0],
                tiled_fn=lambda *a: took.append("tiled") or a[0][0])
            assert took == [expect], (s, d)
    with pytest.raises(KeyError):
        cc.resident_smem_bytes(10, 10, "krum")


def test_serve_shape_takes_the_tiled_schedule():
    """At n = 16, d = 4,096 (the serve launcher's shape) the rows take
    262 KB, above the 227 KB: every close is tiled."""
    assert cc.resident_smem_bytes(16, 4096, "cclip") > cc.H100_SMEM_OPTIN


@pytest.mark.parametrize("s,d", [(1, 2750), (1, 2751), (2, 5266), (2, 5267)],
                         ids=str)
def test_cclip_plain_twin_takes_the_wrappers_schedule(s, d):
    """``clip_then_centered_clip_plain`` on both sides of the resident
    threshold: on CPU tensors it is the wrapper's own arithmetic, bit for
    bit, and it agrees with the oracle."""
    xs, mask, idx, radius = _case(20, d, s, d + s)
    xt, mt, it = (torch.from_numpy(xs), torch.from_numpy(mask),
                  torch.from_numpy(idx.astype(np.int64)))
    bidx = it if s >= 2 else None
    got, norms = cc.clip_then_centered_clip_plain(xt, radius, mt, bidx,
                                                  bucket_s=s, tau=TAU)
    want, wnorms = ops.clip_then_centered_clip(xt, radius, mt, bidx,
                                               bucket_s=s, tau=TAU)
    assert torch.equal(got, want) and torch.equal(norms, wnorms)
    oracle, _ = tref.clip_then_centered_clip_ref(xt, radius, mt, bidx,
                                                 bucket_s=s, tau=TAU)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **F32_TOL)


@pytest.mark.parametrize("n", [6, 21])
def test_cclip_update_matches_pallas_interpret(n):
    """One tiled step against the reference's update kernel, and v0 from
    z = None (0) with s = m against the reference's masked mean."""
    rng = np.random.RandomState(n)
    xs = rng.randn(n, 1024).astype(np.float32)  # a multiple of TILE_D
    z = rng.randn(1024).astype(np.float32)
    f = rng.rand(n).astype(np.float32)
    m = (rng.rand(n) > 0.3).astype(np.float32)
    sc = (rng.rand(n) * m).astype(np.float32)
    den = np.float32(max(m.sum(), 1.0))
    want = rcc._cclip_update_kernel  # the body, run through pallas_call
    from jax.experimental import pallas as pl

    out = pl.pallas_call(
        want, grid=(1,),
        in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0)),
                  pl.BlockSpec((n, 1), lambda i: (0, 0)),
                  pl.BlockSpec((n, 1), lambda i: (0, 0)),
                  pl.BlockSpec((1, 1024), lambda i: (0, i)),
                  pl.BlockSpec((n, 1024), lambda i: (0, i))],
        out_specs=pl.BlockSpec((1, 1024), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, 1024), jnp.float32),
        interpret=True,
    )(jnp.full((1, 1), den), jnp.asarray(sc)[:, None], jnp.asarray(f)[:, None],
      jnp.asarray(z)[None], jnp.asarray(xs))
    xt, ft = torch.from_numpy(xs), torch.from_numpy(f)
    got = cc.cclip_update(xt, torch.from_numpy(sc), ft, torch.from_numpy(z),
                          torch.tensor(den))
    np.testing.assert_allclose(got.numpy(), np.asarray(out)[0], **F32_TOL)
    v0 = cc.cclip_update(xt, torch.from_numpy(m), ft, None, torch.tensor(den))
    np.testing.assert_allclose(v0.numpy(),
                               (xs * (f * m)[:, None]).sum(0) / den,
                               rtol=1e-6, atol=1e-7)


def test_cclip_wrappers_check_their_inputs():
    xs = torch.randn(5, 8)
    with pytest.raises(ValueError, match="auxiliaries"):
        cc.cclip_resident(xs, torch.ones(7), torch.ones(7), torch.arange(7),
                          2)
    with pytest.raises(ValueError, match="sc must have shape"):
        cc.cclip_update(xs, torch.ones(4), None, None, torch.tensor(1.0))
    with pytest.raises(ValueError, match="den"):
        cc.cclip_update(xs, torch.ones(5), None, None, torch.ones(1))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.clip_then_centered_clip(xs.double(), 1.0)


# ---------------------------------------------------------------------------
# Bucketing o CM with an explicit permutation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s", [(20, 2), (21, 2), (21, 3), (16, 4), (9, 2)],
                         ids=str)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bucketed_cm_matches_pallas_interpret(n, s, masked, dtype):
    """The reference draws ``jax.random.permutation(key, n_p)`` inside;
    the port takes that permutation: equal away from ties (random data
    has none)."""
    rng = np.random.RandomState(n * s + masked)
    xs = rng.randn(n, 700).astype(np.float32)
    mask = (rng.rand(n) > 0.4).astype(np.float32) if masked else None
    key = jax.random.PRNGKey(n + s)
    n_p = n + (-n) % s
    perm = np.array(jax.random.permutation(key, n_p))
    xj, xt = jnp.asarray(xs), torch.from_numpy(xs)
    if dtype == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    want = rops.bucketed_coordinate_median(xj, key, mj, s=s)
    got = ops.bucketed_coordinate_median(xt, torch.from_numpy(perm), mt, s=s)
    assert got.dtype == xt.dtype and got.shape == (700,)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if dtype == "f32":
        oracle = rref.bucketed_cm_ref(xj, jnp.asarray(perm), mj, s)
        own = tref.bucketed_cm_ref(xt, torch.from_numpy(perm), mt, s)
        np.testing.assert_array_equal(own.numpy(), np.asarray(oracle))
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


def test_bucketed_cm_is_pass_two_with_unit_factors():
    """With the padded slots in place, the bucketed median is pass 2's
    bucketed CM with unit factors in the same order, bit for bit."""
    rng = np.random.RandomState(4)
    xs = torch.from_numpy(rng.randn(20, 300).astype(np.float32))
    mask = torch.from_numpy((rng.rand(20) > 0.3).astype(np.float32))
    order = torch.randperm(20, generator=torch.Generator().manual_seed(2))
    got = ops.bucketed_coordinate_median(xs, order, mask, s=2)
    want = ca.clip_bucket_select(xs, torch.ones(20), mask, order, 2, -1.0)
    assert torch.equal(got, want)


def test_bucketed_cm_checks_its_inputs():
    xs = torch.randn(5, 8)
    with pytest.raises(ValueError, match="perm must have shape"):
        ops.bucketed_coordinate_median(xs, torch.arange(5), s=2)
    with pytest.raises(ValueError, match="s >= 2"):
        ops.bucketed_coordinate_median(xs, torch.arange(5), s=1)
    assert ops.bucketed_coordinate_median(xs, torch.arange(6), s=2).shape \
        == (8,)
