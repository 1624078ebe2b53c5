"""The kernel wrappers' mesh arguments, ``factors=`` and ``reduce_fn``, on
the CPU: each wrapper's plain version (what it runs on a CPU tensor)
against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops``) on the same inputs.

``factors`` (n,) replaces pass 1 (the clip factors of a mesh come from
each worker's whole message); ``reduce_fn`` reduces the per-row sums of
squares, every iterative step's squared distances and the Krum Gram
across coordinate shards.  A doubling ``reduce_fn`` stands for a sum over
two ranks holding equal halves; an identity one must change nothing but
the schedule: with any ``reduce_fn`` the iterative rules take the tiled
schedule on both sides (the reference's rule), so the two are held
tiled against tiled.  Tolerances: selections and sums f32 rtol 1e-5 with
atol 1e-6; the GM and CenteredClip iterates atol 1e-5, as
tests/test_torch_gm.py.  The CUDA kernels are held against these plain
versions in tests/test_torch_cuda.py, on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops

cc = importlib.import_module("repro_torch.kernels.centered_clip")
gmk = importlib.import_module("repro_torch.kernels.geometric_median")
krk = importlib.import_module("repro_torch.kernels.krum")
cak = importlib.import_module("repro_torch.kernels.clip_aggregate")

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
ITER_TOL = dict(rtol=0, atol=1e-5)
N, D = 8, 300


def _double(t):
    return 2.0 * t


def _identity(t):
    return t


REDUCE = {"none": (None, None), "identity": (_identity, _identity),
          "double": (_double, _double)}
# (factors given, reduce_fn): the mesh's two arguments alone and together
COMBOS = [(False, "double"), (True, "none"), (True, "double")]


def _case(seed=0, s=1):
    rng = np.random.RandomState(seed)
    xs = rng.randn(N, D).astype(np.float32)
    mask = rng.rand(N) > 0.3
    mask[0] = True
    idx = rng.permutation(N).astype(np.int32)
    factors = (0.2 + 0.8 * rng.rand(N)).astype(np.float32)
    radius = float(np.median(np.linalg.norm(xs, axis=1)))
    return xs, mask, idx, factors, radius


def _args(case, with_factors, s):
    xs, mask, idx, factors, radius = case
    t = (torch.from_numpy(xs), torch.from_numpy(mask),
         torch.from_numpy(idx.astype(np.int64)) if s >= 2 else None,
         torch.from_numpy(factors) if with_factors else None)
    j = (jnp.asarray(xs), jnp.asarray(mask),
         jnp.asarray(idx) if s >= 2 else None,
         jnp.asarray(factors) if with_factors else None)
    return t, j, radius


def _check(got, want, tol):
    (g, gn), (w, wn) = got, want
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert (gn is None) == (wn is None)
    if gn is not None:
        np.testing.assert_allclose(gn.numpy(), np.asarray(wn), **SUM_TOL)


@pytest.mark.parametrize("with_factors,reduce", COMBOS, ids=str)
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("trim", [-1.0, 0.1])
def test_clip_then_aggregate_mesh_arguments(trim, s, with_factors, reduce):
    (xs, m, idx, f), (jx, jm, jidx, jf), radius = _args(_case(1), with_factors,
                                                        s)
    tfn, rfn = REDUCE[reduce]
    got = ops.clip_then_aggregate(xs, radius, m, idx, f, trim_ratio=trim,
                                  bucket_s=s, reduce_fn=tfn)
    want = rops.clip_then_aggregate(jx, jnp.float32(radius), jm, jidx, jf,
                                    trim_ratio=trim, bucket_s=s,
                                    reduce_fn=rfn)
    _check(got, want, SUM_TOL)


def test_row_norms_reduce_before_the_root():
    xs = torch.from_numpy(_case(2)[0])
    plain = cak.row_norms(xs)
    doubled = cak.row_norms(xs, _double)
    torch.testing.assert_close(doubled, plain * 2 ** 0.5, rtol=1e-6, atol=0)
    assert torch.equal(cak.row_norms_plain(xs, _double), doubled)


@pytest.mark.parametrize("with_factors,reduce",
                         COMBOS + [(True, "identity")], ids=str)
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("rule", ["gm", "cclip"])
def test_iterative_rules_mesh_arguments(rule, s, with_factors, reduce):
    (xs, m, idx, f), (jx, jm, jidx, jf), radius = _args(_case(3), with_factors,
                                                        s)
    tfn, rfn = REDUCE[reduce]
    if rule == "gm":
        got = ops.clip_then_geometric_median(xs, radius, m, idx, f,
                                             bucket_s=s, reduce_fn=tfn)
        want = rops.clip_then_geometric_median(
            jx, jnp.float32(radius), jm, jidx, jf, bucket_s=s, reduce_fn=rfn)
        plain = gmk.clip_then_geometric_median_plain(
            xs, radius, m, idx, f, bucket_s=s, reduce_fn=tfn)
    else:
        # tau below the distances, so that the clip in each step acts
        got = ops.clip_then_centered_clip(xs, radius, m, idx, f, tau=0.5,
                                          bucket_s=s, reduce_fn=tfn)
        want = rops.clip_then_centered_clip(
            jx, jnp.float32(radius), jm, jidx, jf, tau=0.5, bucket_s=s,
            reduce_fn=rfn)
        plain = cc.clip_then_centered_clip_plain(
            xs, radius, m, idx, f, tau=0.5, bucket_s=s, reduce_fn=tfn)
    _check(got, want, ITER_TOL)
    assert torch.equal(got[0], plain[0])


@pytest.mark.parametrize("rule", ["gm", "cclip"])
@pytest.mark.parametrize("s", [1, 2])
def test_reduce_fn_forces_the_tiled_schedule(rule, s):
    """A shape the resident kernel takes goes tiled once a reduce_fn is
    given: the resident kernel cannot host a collective between steps."""
    xs = torch.zeros(20, 40)
    for reduce_fn, expect in ((None, "resident"), (_identity, "tiled")):
        took = []
        cc.run_clip_then_iterative(
            xs, 1.0, None, None, torch.ones(20), bucket_s=s, use_clip=True,
            rule=rule, reduce_fn=reduce_fn,
            resident_fn=lambda *a: took.append("resident") or a[0][0],
            tiled_fn=lambda *a: took.append("tiled") or a[0][0])
        assert took == [expect]


@pytest.mark.parametrize("with_factors,reduce", COMBOS, ids=str)
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("multi", [False, True])
def test_clip_then_krum_mesh_arguments(multi, s, with_factors, reduce):
    (xs, m, idx, f), (jx, jm, jidx, jf), radius = _args(_case(4), with_factors,
                                                        s)
    tfn, rfn = REDUCE[reduce]
    got = ops.clip_then_krum(xs, radius, m, idx, f, byz_bound=1, multi=multi,
                             bucket_s=s, reduce_fn=tfn)
    want = rops.clip_then_krum(jx, jnp.float32(radius), jm, jidx, jf,
                               byz_bound=1, multi=multi, bucket_s=s,
                               reduce_fn=rfn)
    _check(got, want, SUM_TOL)
    plain = krk.clip_then_krum_plain(xs, radius, m, idx, f, byz_bound=1,
                                     multi=multi, bucket_s=s, reduce_fn=tfn)
    assert torch.equal(got[0], plain[0])


def test_krum_gram_reduces_each_block():
    xs = _case(5)[0]
    chunks = [xs[:, :100], xs[:, 100:250], xs[:, 250:]]
    got = ops.krum_gram([torch.from_numpy(c.copy()) for c in chunks],
                        reduce_fn=_double)
    want = rops.krum_gram([jnp.asarray(c) for c in chunks],
                          reduce_fn=_double)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)
    assert torch.equal(got, got.T)
