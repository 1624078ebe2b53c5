"""The port's Weiszfeld geometric median (RFA) kernels against the JAX
reference, on the CPU.

On CPU tensors the wrappers of ``repro_torch.kernels.geometric_median``
and ``centered_clip`` run their kernels' plain PyTorch versions, so these
tests hold the plain versions (the kernels' arithmetic) against the
reference's Pallas kernels in interpret mode (``repro.kernels.ops``, as
tests/test_kernels_krum_gm.py runs them), on both schedules:

  resident  the reference's one-launch kernel (its VMEM rule admits these
            shapes) against the port's ``clip_then_geometric_median``,
            which the shared-memory rule sends to ``gm_resident`` here;
  tiled     the reference forced onto its tiled schedule by a
            ``reduce_fn`` (any ``reduce_fn`` bypasses the resident branch),
            against the port's tiled functions called directly.

Inputs are numpy arrays made from seeds.  Tolerances: f32 atol 1e-5 (as
the reference's own GM tests); bf16 outputs are rounded from f32 values
that agree to about 1e-6, so they may differ by one bf16 step (2^-7
relative).  The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py, on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# both packages re-export functions under their modules' names
cc = importlib.import_module("repro_torch.kernels.centered_clip")
gmk = importlib.import_module("repro_torch.kernels.geometric_median")
rcc = importlib.import_module("repro.kernels.centered_clip")

F32_TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
# (n, d, s): the Fig. 2 shape, odd n with padding, wider rows
CASES = [(20, 698, 1), (20, 698, 2), (21, 700, 2), (21, 700, 3),
         (11, 1500, 2), (11, 1500, 1)]


def _identity(v):
    """A ``reduce_fn`` that sums nothing: it forces the reference's tiled
    schedule without changing its numbers."""
    return v


def _case(n, d, s, seed, masked=True):
    """Rows, a mask (random with row 0 in; all rows when ``masked`` is
    False; none when it is "none"), a row order and a clip radius."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n) > 0.3
    mask[0] = True
    if masked is False:
        mask[:] = True
    elif masked == "none":
        mask[:] = False
    idx = rng.permutation(n).astype(np.int32)
    norms = np.linalg.norm(xs, axis=1)
    return xs, mask, idx, float(np.median(norms))  # clips about half


def _port_tiled(xs, radius, mask, idx, s, use_clip=True, iters=8):
    """The port's tiled schedule, called directly: pass 1, the padded
    auxiliaries, (s >= 2) the bucket means, then ``gm_tiled``."""
    n = xs.shape[0]
    factors = (cc.clip_factor(ops.row_norms(xs), radius) if use_clip
               else torch.ones(n))
    m, f, i = cc.pad_bucket_aux(mask.float(), factors, idx, n, s)
    if s >= 2:
        means, ok = cc.bucket_means_tiled(xs, m, f, i, s)
        return gmk.gm_tiled(means, ok, None, iters=iters).to(xs.dtype)
    return gmk.gm_tiled(xs, m, f, iters=iters).to(xs.dtype)


def _assert_close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(BF16_TOL if dtype == "bf16" else F32_TOL))


def _inputs(xs, mask, idx, dtype):
    xt = torch.from_numpy(xs)
    xj = jnp.asarray(xs)
    if dtype == "bf16":
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    return (xt, torch.from_numpy(mask), torch.from_numpy(idx.astype(np.int64)),
            xj, jnp.asarray(mask), jnp.asarray(idx))


@pytest.mark.parametrize("n,d,s", CASES, ids=str)
@pytest.mark.parametrize("schedule", ["resident", "tiled"])
def test_clip_gm_matches_pallas_interpret(n, d, s, schedule):
    xs, mask, idx, radius = _case(n, d, s, n * 31 + d + s)
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, "f32")
    rfn = _identity if schedule == "tiled" else None
    want, wnorms = rops.clip_then_geometric_median(
        xj, radius, mj, ij, bucket_s=s, reduce_fn=rfn)
    if schedule == "resident":
        assert cc.resident_smem_bytes(-(-n // s), d) <= cc.H100_SMEM_OPTIN
        got, norms = ops.clip_then_geometric_median(xt, radius, mt, it,
                                                    bucket_s=s)
        np.testing.assert_allclose(norms.numpy(), np.asarray(wnorms),
                                   rtol=1e-5)
    else:
        got = _port_tiled(xt, radius, mt, it, s)
    _assert_close(got.numpy(), want, "f32")
    oracle, _ = rref.clip_then_geometric_median_ref(xj, radius, mj, ij,
                                                    bucket_s=s)
    _assert_close(got.numpy(), oracle, "f32")
    own, _ = tref.clip_then_geometric_median_ref(xt, radius, mt, it,
                                                 bucket_s=s)
    _assert_close(own.numpy(), oracle, "f32")


@pytest.mark.parametrize("n,d,s", [(20, 698, 2), (21, 700, 3), (11, 1500, 1)],
                         ids=str)
@pytest.mark.parametrize("schedule", ["resident", "tiled"])
def test_clip_gm_bf16_matches_pallas_interpret(n, d, s, schedule):
    xs, mask, idx, radius = _case(n, d, s, 5 * n + d + s)
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, "bf16")
    rfn = _identity if schedule == "tiled" else None
    want, _ = rops.clip_then_geometric_median(xj, radius, mj, ij, bucket_s=s,
                                              reduce_fn=rfn)
    if schedule == "resident":
        got, _ = ops.clip_then_geometric_median(xt, radius, mt, it,
                                                bucket_s=s)
    else:
        got = _port_tiled(xt, radius, mt, it, s)
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), want, "bf16")


@pytest.mark.parametrize("d", [1, 31, 33, 40])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("iters", [0, 8])
def test_resident_block_tiers_match_pallas_interpret(d, s, iters):
    """The widths where the card's resident kernel changes its block (one
    coordinate; one warp's 32 coordinates and one past them; Fig. 1's 40)
    and ``iters = 0`` (z0 alone), at n = 21: the plain twin that the card
    tests hold ``gm_resident`` against is itself pinned to the reference's
    resident kernel there."""
    xs, mask, idx, radius = _case(21, d, s, 7 * d + s + iters)
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, "f32")
    want, _ = rops.clip_then_geometric_median(xj, radius, mj, ij, bucket_s=s,
                                              iters=iters)
    got, _ = ops.clip_then_geometric_median(xt, radius, mt, it, bucket_s=s,
                                            iters=iters)
    _assert_close(got.numpy(), want, "f32")


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("schedule", ["resident", "tiled"])
def test_all_masked_gives_zero_as_in_reference(s, schedule):
    """No sampled row: z0 = 0 / max(0, 1) and every weight is 0, so the
    result is 0 (not the 3.4e37 of the coordinate median)."""
    xs, mask, idx, radius = _case(21, 700, s, 40 + s, masked="none")
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, "f32")
    rfn = _identity if schedule == "tiled" else None
    want, _ = rops.clip_then_geometric_median(xj, radius, mj, ij, bucket_s=s,
                                              reduce_fn=rfn)
    got = (ops.clip_then_geometric_median(xt, radius, mt, it, bucket_s=s)[0]
           if schedule == "resident" else _port_tiled(xt, radius, mt, it, s))
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    np.testing.assert_array_equal(got.numpy(), 0.0)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("shape", [(20, 698), (7, 33), (64, 130)], ids=str)
def test_geometric_median_matches_pallas_interpret(shape, masked):
    xs, mask, _, _ = _case(*shape, 1, sum(shape), masked)
    m = mask if masked else None
    got = ops.geometric_median(torch.from_numpy(xs),
                               None if m is None else torch.from_numpy(m))
    want = rops.geometric_median(jnp.asarray(xs),
                                 None if m is None else jnp.asarray(m))
    _assert_close(got.numpy(), want, "f32")
    _assert_close(tref.geometric_median_ref(
        torch.from_numpy(xs), mask=None if m is None else torch.from_numpy(m)
    ).numpy(), rref.geometric_median_ref(
        jnp.asarray(xs), 8, 1e-8, None if m is None else jnp.asarray(m)),
        "f32")


def test_unclipped_gm_over_buckets_skips_pass_one():
    xs, mask, idx, _ = _case(21, 700, 2, 77)
    xt, mt, it, xj, mj, ij = _inputs(xs, mask, idx, "f32")
    got, norms = ops.clip_then_geometric_median(xt, 0.0, mt, it, bucket_s=2,
                                                use_clip=False, iters=3)
    want, _ = rops.clip_then_geometric_median(xj, 0.0, mj, ij, bucket_s=2,
                                              use_clip=False, iters=3)
    assert norms is None
    _assert_close(got.numpy(), want, "f32")


# ---------------------------------------------------------------------------
# the tiled helpers, piece by piece
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 21])
def test_diff_row_ssq_matches_pallas_interpret(n):
    rng = np.random.RandomState(n)
    xs = rng.randn(n, 1024).astype(np.float32)  # a multiple of TILE_D
    z = rng.randn(1024).astype(np.float32)
    f = rng.rand(n).astype(np.float32)
    want = rcc.diff_row_ssq(jnp.asarray(xs), jnp.asarray(z)[None],
                            jnp.asarray(f), interpret=True)
    got = cc.diff_row_ssq(torch.from_numpy(xs), torch.from_numpy(z),
                          torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        cc.diff_row_ssq(torch.from_numpy(xs), torch.from_numpy(z)).numpy(),
        ((xs - z) ** 2).sum(1), rtol=1e-5)


@pytest.mark.parametrize("n,s", [(20, 2), (21, 2), (21, 3), (8, 4)])
def test_bucket_means_match_pallas_interpret(n, s):
    """The reference pads the rows itself; the port pads only the
    auxiliaries and never reads an empty slot."""
    rng = np.random.RandomState(3 * n + s)
    xs = rng.randn(n, 512).astype(np.float32)
    mask = (rng.rand(n) > 0.4).astype(np.float32)
    f = rng.rand(n).astype(np.float32)
    idx = rng.permutation(n).astype(np.int32)
    rm, rf, ri, pad = rcc._pad_bucket_aux(jnp.asarray(mask), jnp.asarray(f),
                                          jnp.asarray(idx), n, s)
    xp = jnp.pad(jnp.asarray(xs), ((0, pad), (0, 0)))
    want, want_ok = rcc.bucket_means_tiled(xp, rm, rf, ri, s, interpret=True)
    m, fp, ip = cc.pad_bucket_aux(torch.from_numpy(mask), torch.from_numpy(f),
                                  torch.from_numpy(idx), n, s)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(rf))
    got, ok = cc.bucket_means_tiled(torch.from_numpy(xs), m, fp, ip, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))


def test_gm_update_is_the_weighted_mean():
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(6, 50).astype(np.float32))
    w = torch.from_numpy(rng.rand(6).astype(np.float32))
    f = torch.from_numpy(rng.rand(6).astype(np.float32))
    got = gmk.gm_update(x, w, f, w.sum())
    want = (x * (f * w)[:, None]).sum(0) / w.sum()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="wsum"):
        gmk.gm_update(x, w, f, w.sum()[None])


def test_resident_threshold_is_the_h100_shared_memory():
    """The dispatch rule: the resident schedule iff its shared memory fits
    the H100's 227 KB; both sides of the boundary at n = 20."""
    budget = cc.H100_SMEM_OPTIN
    assert budget == 227 * 1024
    for s, rows, d_max in ((1, 20, 2750), (2, 10, 5266)):
        assert cc.resident_smem_bytes(rows, d_max) <= budget
        assert cc.resident_smem_bytes(rows, d_max + 1) > budget
        for d, expect in ((d_max, "resident"), (d_max + 1, "tiled")):
            took = []
            xs = torch.zeros(20, d)
            cc.run_clip_then_iterative(
                xs, 1.0, None, None, bucket_s=s, use_clip=False,
                resident_fn=lambda *a: took.append("resident") or a[0][0],
                tiled_fn=lambda *a: took.append("tiled") or a[0][0])
            assert took == [expect], (s, d)


@pytest.mark.parametrize("s,d", [(1, 2750), (1, 2751), (2, 5266), (2, 5267)],
                         ids=str)
def test_plain_twin_takes_the_wrappers_schedule(s, d):
    """``clip_then_geometric_median_plain`` on both sides of the resident
    threshold: on CPU tensors it is the wrapper's own arithmetic, bit for
    bit, and it agrees with the oracle of ``repro_torch.kernels.ref``."""
    xs, mask, idx, radius = _case(20, d, s, d + s)
    xt, mt, it = (torch.from_numpy(xs), torch.from_numpy(mask),
                  torch.from_numpy(idx.astype(np.int64)))
    bidx = it if s >= 2 else None
    got, norms = gmk.clip_then_geometric_median_plain(xt, radius, mt, bidx,
                                                      bucket_s=s)
    want, wnorms = ops.clip_then_geometric_median(xt, radius, mt, bidx,
                                                  bucket_s=s)
    assert torch.equal(got, want) and torch.equal(norms, wnorms)
    oracle, _ = tref.clip_then_geometric_median_ref(xt, radius, mt, bidx,
                                                    bucket_s=s)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **F32_TOL)


def test_wrappers_check_their_inputs():
    xs = torch.randn(5, 8)
    with pytest.raises(ValueError, match="auxiliaries"):
        gmk.gm_resident(xs, torch.ones(7), torch.ones(7),
                        torch.arange(7), 2)
    with pytest.raises(ValueError, match="z must have shape"):
        cc.diff_row_ssq(xs, torch.zeros(7))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.clip_then_geometric_median(xs.double(), 1.0)
