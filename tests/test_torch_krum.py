"""The port's Krum pieces against the JAX reference, on the CPU.

The four kernels' plain versions (Gram, cross-Gram, weighted row-sum,
select-row) are held against the reference's Pallas kernels in interpret
mode (``repro.kernels.krum``, as tests/test_kernels_krum_gm.py runs them)
and against ``repro.kernels.ref``; the selection algebra
(``krum_select_from_gram``) against the reference's on the same Gram and
the same Bucketing order; and the Krum rules of the registry against the
reference's jnp and pallas aggregators.  Inputs are numpy arrays from
seeds.

Tolerances: a Gram entry to rtol 1e-5 of its Cauchy-Schwarz scale
sqrt(G_ii G_jj) (an off-diagonal entry can sit near 0, where the two
packages' summation orders differ by more than 1e-5 of the entry); sums
rtol 1e-5 (atol 1e-6); winners, multi-Krum sets and row takes exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.aggregators as ragg
from repro.kernels import ref as rref
from repro_torch.core import aggregators as tagg
from repro_torch.kernels import krum as tk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

rk = importlib.import_module("repro.kernels.krum")  # the module, not the fn

SUM = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(3, 64), (8, 512), (11, 700), (16, 1024), (5, 1), (17, 4097),
          (20, 130)]


def _rows(n, d, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32).astype(dtype), rng


def _mask(rng, n):
    m = np.zeros(n, bool)
    m[: max(3, n // 2)] = True
    rng.shuffle(m)
    return m


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def assert_gram_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.sqrt(np.abs(np.outer(np.diag(want), np.diag(want))))
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * scale + 1e-6)


# ---------------------------------------------------------------------------
# the plain versions of the four kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gram_plain_matches_reference_kernel(shape, dtype):
    n, d = shape
    xs, _ = _rows(n, d, n * 31 + d)
    xj = jnp.asarray(xs, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    xt = _t(np.asarray(xj.astype(jnp.float32)))
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    want = np.asarray(rk.gram_matrix(xj, interpret=True))
    got = tk.gram_matrix(xt)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    assert_gram_close(got.numpy(), want)
    # the oracle: explicit f32 products summed in float64
    x64 = np.asarray(xj.astype(jnp.float32), np.float64)
    assert_gram_close(got.numpy(), x64 @ x64.T)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cross_gram_plain_matches_reference_kernel(shape):
    n, d = shape
    a, rng = _rows(n, d, 7 * n + d)
    b = rng.randn(n, d).astype(np.float32)
    want = np.asarray(rk.cross_gram(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True))
    got = tk.cross_gram(_t(a), _t(b)).numpy()
    scale = np.sqrt(np.outer((a.astype(np.float64) ** 2).sum(1),
                             (b.astype(np.float64) ** 2).sum(1)))
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * scale + 1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_gram_is_exactly_symmetric_and_cross_equals_gram(shape, dtype):
    n, d = shape
    xs, _ = _rows(n, d, n + 3 * d)
    x = _t(xs).to(dtype)
    g = tk.gram_matrix_plain(x)
    assert torch.equal(g, g.T)
    assert torch.equal(tk.cross_gram_plain(x, x), g)
    assert torch.equal(tk.cross_gram(x, x), tk.gram_matrix(x))
    # the embedding the streaming server uses: some rows of x at their
    # slots of a zero matrix, against x; the rows touched equal the Gram's
    emb = torch.zeros_like(x)
    rows = torch.arange(0, n, 2)
    emb[rows] = x[rows]
    blk = tk.cross_gram_plain(emb, x)
    assert torch.equal(blk[rows], g[rows])
    assert torch.equal(blk.T[:, rows], g[:, rows])


# the kernels' cut of the coordinate axis, mirrored in Python: the launch
# refuses any slice count but ceil(d / gram_sub_coords(n, d))
CUT_SHAPES = [(1, 1), (5, 1), (4, 33), (16, 4096), (17, 4097), (20, 1 << 16),
              (16, 1 << 20), (20, 2 ** 24 + 37), (128, 3000), (128, 1 << 24)]


@pytest.mark.parametrize("n,d", CUT_SHAPES, ids=str)
def test_gram_cut_covers_d_in_whole_runs(n, d):
    sub = tk.gram_sub_coords(n, d)
    slices = -(-d // sub)
    assert sub % tk.GRAM_RUN == 0
    assert tk.GRAM_RUN <= sub <= 32 * (-(-n // 8) * 8)
    assert slices * sub >= d > (slices - 1) * sub
    assert tk.gram_rounding_depth(n, d) == sub + -(-slices // 256) + 13


def test_gram_cut_at_the_wide_and_the_serve_shape():
    """At the server-step shape the chain stays at 768 multiply-adds and
    the depth at 867; at the serve shape the cut of (n, d) gives 256
    sub-slices of one run, many blocks' worth, where the cut of n alone
    gave 8, one block's."""
    wide = 2 ** 24 + 37
    assert tk.gram_sub_coords(20, wide) == 768
    assert -(-wide // 768) == 21846
    assert tk.gram_rounding_depth(20, wide) == 867
    assert tk.gram_sub_coords(16, 4096) == 16
    # a block runs at most 16 sub-slices (krum.cu's kMaxGroup)
    assert -(-4096 // 16) == 256 > 8 * 16
    assert tk.gram_rounding_depth(16, 4096) == 30
    assert tk.gram_sub_coords(16, 1 << 20) == 512  # as the cut of n gave


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weighted_row_sum_plain_matches_reference_kernel(shape, dtype):
    n, d = shape
    xs, rng = _rows(n, d, 3 * n + d)
    w = (rng.rand(n) * (rng.rand(n) > 0.3)).astype(np.float32)
    xj = jnp.asarray(xs, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    xt = _t(np.asarray(xj.astype(jnp.float32)))
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    want = np.asarray(rk.weighted_row_sum(xj, jnp.asarray(w), interpret=True))
    got = tk.weighted_row_sum(xt, _t(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SUM)


def test_zero_weight_row_with_inf_adds_exactly_zero():
    xs, _ = _rows(6, 300, 5)
    xs[2] = np.inf
    xs[4, 7] = -np.inf
    w = np.asarray([0.5, 1.0, 0.0, 0.25, 0.0, 2.0], np.float32)
    got = tk.weighted_row_sum(_t(xs), _t(w)).numpy()
    want = np.asarray(rk.weighted_row_sum(jnp.asarray(xs), jnp.asarray(w),
                                          interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **SUM)
    exact = (xs[[0, 1, 3, 5]] * w[[0, 1, 3, 5], None]).sum(0)
    np.testing.assert_allclose(got, exact, **SUM)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("winner", [0, "last", "mid", -3, 99])
def test_select_row_plain_matches_reference_kernel(shape, winner):
    n, d = shape
    xs, _ = _rows(n, d, n * d + 1)
    win = {"last": n - 1, "mid": n // 2}.get(winner, winner)
    want = np.asarray(rk.select_row(jnp.asarray(xs), jnp.int32(win),
                                    jnp.float32(0.75), interpret=True))
    got = tk.select_row(_t(xs), torch.tensor(win), torch.tensor(0.75))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), xs[min(max(win, 0), n - 1)] * np.float32(0.75))


def test_select_row_scale_zero_gives_zero_on_an_inf_row():
    xs, _ = _rows(5, 70, 2)
    xs[3] = np.inf
    got = tk.select_row(_t(xs), torch.tensor(3), torch.tensor(0.0))
    np.testing.assert_array_equal(got.numpy(), np.zeros(70, np.float32))
    want = np.asarray(rk.select_row(jnp.asarray(xs), jnp.int32(3),
                                    jnp.float32(0.0), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    # the one-hot weighted row-sum gives the same bits
    w = torch.zeros(5)
    w[1] = 0.5
    np.testing.assert_array_equal(
        tk.weighted_row_sum(_t(xs), w).numpy(),
        tk.select_row(_t(xs), torch.tensor(1), torch.tensor(0.5)).numpy())


@pytest.mark.parametrize("index_dtype", [torch.int8, torch.uint8, torch.int16,
                                         torch.int32, torch.int64], ids=str)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_select_row_index_types_and_storage_offsets(index_dtype, offset):
    """Every integer winner type gives the reference's row; an int32
    winner (the engine's) and an f32 scale reach the kernel as they are
    (no cast), others as int32; a matrix that starts ``offset`` values into
    its storage (so its rows start off a 16-byte boundary) gives the
    same."""
    n, d = 9, 4097
    xs, _ = _rows(n, d, 77 + offset)
    view = torch.cat([torch.zeros(offset), _t(xs).view(-1)])[offset:]
    view = view.view(n, d)
    assert view.storage_offset() == offset
    for win in (0, 5, n - 1, 99):
        w = torch.tensor(win).to(index_dtype)
        sc = torch.tensor(0.75)
        got_w, got_sc = tk._row_scalars(view, w, sc)
        assert got_sc is sc
        if index_dtype == torch.int32:
            assert got_w is w
        else:
            assert got_w.dtype == torch.int32 and int(got_w) == int(w)
        want = np.asarray(rk.select_row(jnp.asarray(xs), jnp.int32(int(w)),
                                        jnp.float32(0.75), interpret=True))
        np.testing.assert_array_equal(tk.select_row(view, w, sc).numpy(),
                                      want)


def test_wrappers_validate_their_inputs():
    x = torch.randn(4, 10)
    with pytest.raises(ValueError, match="at most 128 rows"):
        tk.gram_matrix(torch.randn(129, 3))
    with pytest.raises(ValueError, match="operands differ"):
        tk.cross_gram(x, torch.randn(4, 11))
    with pytest.raises(ValueError, match="shape"):
        tk.weighted_row_sum(x, torch.ones(5))
    with pytest.raises(ValueError, match="0-d"):
        tk.select_row(x, torch.tensor([1]), torch.tensor(1.0))
    with pytest.raises(TypeError, match="integer"):
        tk.select_row(x, torch.tensor(1.0), torch.tensor(1.0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.gram_matrix(x.double())


# ---------------------------------------------------------------------------
# the selection algebra
# ---------------------------------------------------------------------------

def _select_both(gram, mask, radius, bucket_idx, **kw):
    ref, rnorm = rk.krum_select_from_gram(
        jnp.asarray(gram), None if mask is None else jnp.asarray(mask),
        radius, None, None if bucket_idx is None else jnp.asarray(bucket_idx),
        **kw)
    port, pnorm = tk.krum_select_from_gram(
        _t(gram), None if mask is None else _t(mask), radius, None,
        None if bucket_idx is None else _t(bucket_idx), **kw)
    return ref, port, rnorm, pnorm


@pytest.mark.parametrize("n,d", [(8, 40), (11, 257), (20, 130), (5, 3)],
                         ids=str)
@pytest.mark.parametrize("bucket_s", [1, 2, 3])
@pytest.mark.parametrize("multi", [False, True], ids=["krum", "multikrum"])
@pytest.mark.parametrize("clip", [None, 1.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_krum_select_from_gram_matches_reference(n, d, bucket_s, multi, clip,
                                                 masked):
    xs, rng = _rows(n, d, 13 * n + d + bucket_s)
    xs *= rng.rand(n, 1).astype(np.float32) * 3  # rows of several norms
    mask = _mask(rng, n) if masked else None
    gram = (xs.astype(np.float64) @ xs.T.astype(np.float64)).astype(
        np.float32)
    gram = 0.5 * (gram + gram.T)
    idx = None
    if bucket_s >= 2:
        key = jax.random.PRNGKey(n + bucket_s)
        m = np.ones(n, bool) if mask is None else mask
        idx = np.asarray(ragg._bucket_order(key, jnp.asarray(m), n))
    ref, port, rnorm, pnorm = _select_both(
        gram, mask, clip, idx, byz_bound=1, multi=multi, bucket_s=bucket_s,
        use_clip=clip is not None)
    assert int(port.winner) == int(ref.winner)
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights),
                               **SUM)
    np.testing.assert_allclose(float(port.denom), float(ref.denom))
    np.testing.assert_allclose(float(port.scale), float(ref.scale), **SUM)
    if multi:
        np.testing.assert_array_equal(port.weights.numpy() != 0,
                                      np.asarray(ref.weights) != 0)
    assert (pnorm is None) == (rnorm is None)
    if pnorm is not None:
        np.testing.assert_allclose(pnorm.numpy(), np.asarray(rnorm), **SUM)


@pytest.mark.parametrize("m_select", [0, 1, 3, 50])
@pytest.mark.parametrize("byz_bound", [None, 0, 2])
def test_multi_krum_selection_size_and_ties(m_select, byz_bound):
    """Duplicate rows give exact score ties: the stable order keeps the
    lower row, as ``jnp.argsort`` does."""
    xs, rng = _rows(9, 33, m_select + 7)
    xs[4] = xs[1]
    xs[7] = xs[1]
    mask = _mask(rng, 9)
    mask[[1, 4, 7]] = True
    gram = (xs.astype(np.float64) @ xs.T.astype(np.float64)).astype(
        np.float32)
    gram = 0.5 * (gram + gram.T)
    ref, port, _, _ = _select_both(gram, mask, None, None, byz_bound=byz_bound,
                                   m_select=m_select, multi=True,
                                   use_clip=False)
    np.testing.assert_array_equal(port.weights.numpy(),
                                  np.asarray(ref.weights))
    assert int(port.winner) == int(ref.winner)


def test_krum_with_exact_ties_takes_the_first_row():
    xs, _ = _rows(7, 20, 3)
    xs[5] = xs[2]  # two identical rows: mutual nearest neighbours, d2 = 0
    got = tk.krum(_t(xs), byz_bound=1)
    want = np.asarray(rk.krum(jnp.asarray(xs), byz_bound=1, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  tref.krum_ref(_t(xs), None, 1).numpy())


# ---------------------------------------------------------------------------
# the whole call and the registry rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_krum_and_multi_krum_match_oracles(shape, masked):
    n, d = shape
    xs, rng = _rows(n, d, hash(shape) % 2**31)
    mask = _mask(rng, n) if masked else None
    mt = None if mask is None else _t(mask)
    mj = None if mask is None else jnp.asarray(mask)
    got = tk.krum(_t(xs), mt, byz_bound=1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rref.krum_ref(jnp.asarray(xs), mj, 1)))
    np.testing.assert_array_equal(got.numpy(),
                                  tref.krum_ref(_t(xs), mt, 1).numpy())
    for m_select in (0, 3):
        got = tk.multi_krum(_t(xs), mt, byz_bound=1, m_select=m_select)
        want = np.asarray(rref.multi_krum_ref(jnp.asarray(xs), mj, 1,
                                              m_select))
        np.testing.assert_allclose(got.numpy(), want, **SUM)
        np.testing.assert_allclose(
            got.numpy(), tref.multi_krum_ref(_t(xs), mt, 1, m_select).numpy(),
            **SUM)


@pytest.mark.parametrize("n,d,s", [(8, 64, 2), (11, 130, 3), (20, 300, 2),
                                   (21, 40, 2), (9, 5, 4)], ids=str)
@pytest.mark.parametrize("multi", [False, True], ids=["krum", "multikrum"])
def test_clip_then_krum_matches_reference_kernel_and_oracle(n, d, s, multi):
    xs, rng = _rows(n, d, n * d + s)
    xs *= rng.rand(n, 1).astype(np.float32) * 4
    mask = _mask(rng, n)
    key = jax.random.PRNGKey(s)
    idx = np.asarray(ragg._bucket_order(key, jnp.asarray(mask), n))
    for bucket_s in (1, s):
        bidx = idx if bucket_s >= 2 else None
        got, norms = tk.clip_then_krum(
            _t(xs), 2.0, _t(mask), None if bidx is None else _t(bidx),
            byz_bound=1, multi=multi, bucket_s=bucket_s)
        want, wnorms = rk.clip_then_krum(
            jnp.asarray(xs), jnp.float32(2.0), jnp.asarray(mask),
            None if bidx is None else jnp.asarray(bidx), byz_bound=1,
            multi=multi, bucket_s=bucket_s, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM)
        np.testing.assert_allclose(norms.numpy(), np.asarray(wnorms), **SUM)
        oracle, _ = tref.clip_then_krum_ref(
            _t(xs), 2.0, _t(mask), None if bidx is None else _t(bidx),
            byz_bound=1, multi=multi, bucket_s=bucket_s)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), **SUM)


def test_all_rows_masked():
    xs, _ = _rows(6, 50, 4)
    none = np.zeros(6, bool)
    for multi in (False, True):
        got, _ = tk.clip_then_krum(_t(xs), 1.0, _t(none), multi=multi,
                                   byz_bound=1)
        want, _ = rk.clip_then_krum(jnp.asarray(xs), jnp.float32(1.0),
                                    jnp.asarray(none), multi=multi,
                                    byz_bound=1, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM)


def test_krum_selects_an_honest_row_under_outliers():
    xs, _ = _rows(10, 64, 0)
    xs[7:] += 100.0
    got = tk.krum(_t(xs), byz_bound=3).numpy()
    assert np.abs(got).max() < 10.0


@pytest.mark.parametrize("rule", ["krum", "multi_krum"])
@pytest.mark.parametrize("bucket_s", [0, 2, 3])
@pytest.mark.parametrize("n,d", [(20, 40), (13, 130)], ids=str)
def test_registry_rules_match_reference(rule, bucket_s, n, d):
    """make_aggregator's krum/multi_krum against the reference's jnp rule
    (explicit bucket means) and pallas rule (Gram algebra, interpret
    mode), with the reference's Bucketing order carried across."""
    xs, rng = _rows(n, d, n + d + bucket_s)
    mask = rng.rand(n) > 0.3
    mask[:3] = True
    key = jax.random.PRNGKey(n + bucket_s)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, n)))
    xt, mt = _t(xs), _t(mask)
    xj, mj = jnp.asarray(xs), jnp.asarray(mask)
    for backend in ("torch", "auto"):
        port = tagg.make_aggregator(rule, bucket_s, backend=backend,
                                    byz_bound=2)
        assert port.supports_two_phase
        for ref_backend in ("jnp", "pallas"):
            ref = ragg.make_aggregator(rule, bucket_s, backend=ref_backend,
                                       byz_bound=2)
            np.testing.assert_allclose(
                port(xt, mt, key=perm).numpy(),
                np.asarray(ref(xj, mj, key=key)), **SUM)
            np.testing.assert_allclose(
                port.clip_then_aggregate(xt, 0.7, mt, key=perm).numpy(),
                np.asarray(ref.clip_then_aggregate(xj, 0.7, mj, key=key)),
                **SUM)


@pytest.mark.parametrize("rule,bucket_s", [("krum", 0), ("multi_krum", 0),
                                           ("krum", 2), ("multi_krum", 3)])
def test_two_phase_over_chunks_equals_one_shot(rule, bucket_s):
    """accumulate_stats over a list of coordinate chunks, one finalize,
    apply_selection per chunk: the concatenation is the one-shot
    aggregate on the whole matrix (the reference's two-phase contract)."""
    xs, rng = _rows(12, 90, 2 + bucket_s)
    mask = _t(rng.rand(12) > 0.2)
    xt = _t(xs)
    chunks = [xt[:, :40].contiguous(), xt[:, 40:].contiguous()]
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(1))
    for backend in ("torch", "auto"):
        agg = tagg.make_aggregator(rule, bucket_s, backend=backend,
                                   byz_bound=1)
        stats = agg.accumulate_stats(chunks)
        torch.testing.assert_close(stats, agg.accumulate_stats(xt),
                                   rtol=1e-5, atol=1e-4)
        sel = agg.finalize(agg.accumulate_stats(xt), mask=mask, key=perm,
                           radius=1.5)
        whole = agg.apply_selection(xt, sel)
        parts = agg.apply_selection(chunks, sel)
        np.testing.assert_array_equal(torch.cat(parts).numpy(), whole.numpy())
        ref = ragg.make_aggregator(rule, bucket_s, backend="pallas",
                                   byz_bound=1)
        rsel = ref.finalize(jnp.asarray(agg.accumulate_stats(xt).numpy()),
                            mask=jnp.asarray(mask.numpy()),
                            key=jax.random.PRNGKey(0), radius=1.5)
        if bucket_s < 2:  # the reference draws its own Bucketing order
            np.testing.assert_allclose(
                whole.numpy(), np.asarray(ref.apply_selection(
                    jnp.asarray(xs), rsel)), **SUM)


def test_two_phase_is_refused_where_absent_and_on_the_wrong_device():
    with pytest.raises(NotImplementedError, match="two-phase"):
        tagg.make_aggregator("cm").accumulate_stats(torch.randn(4, 3))
    agg = tagg.make_aggregator("krum", backend="cuda")
    with pytest.raises(ValueError, match="backend 'cuda'"):
        agg.accumulate_stats(torch.randn(4, 3))


@pytest.mark.parametrize("rule,bucket_s", [("krum", 0), ("multi_krum", 0),
                                           ("krum", 2), ("multi_krum", 2)])
def test_clip_takes_the_factors_from_diag_gram_on_every_backend(rule,
                                                                bucket_s):
    """Krum's clip is one form: the torch backend and auto on the CPU (the
    kernels' plain versions) agree bit for bit, and both equal the
    two-phase finalize at the radius."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(10, 37).astype(np.float32) * 2)
    mask = torch.from_numpy(rng.rand(10) > 0.2)
    perm = torch.from_numpy(rng.permutation(10))
    outs = []
    for backend in ("torch", "auto"):
        agg = tagg.make_aggregator(rule, bucket_s, backend=backend,
                                   byz_bound=2)
        outs.append(agg.clip_then_aggregate(x, 1.5, mask=mask, key=perm))
        sel = agg.finalize(agg.accumulate_stats(x), mask=mask, key=perm,
                           radius=1.5)
        outs.append(agg.apply_selection(x, sel))
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)


def test_cpu_krum_never_launches():
    ops.reset_launch_counts()
    x = torch.randn(9, 33)
    for backend in ("torch", "auto"):
        for rule in ("krum", "multi_krum"):
            agg = tagg.make_aggregator(rule, 2, backend=backend)
            agg(x)
            agg.clip_then_aggregate(x, 1.0)
    ops.krum_gram(x)
    ops.krum_cross_gram(x, x)
    assert sum(ops.launch_counts().values()) == 0
