"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; this
file imports neither jax nor the reference package, so it runs on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the coordinate median selects values and averages two with
the same f32 operations as the plain version, so it matches exactly when
both get the same clip factors; sums (row norms, trimmed means) agree to
f32 rtol 1e-5; a Gram entry to rtol 1e-5 of sqrt(G_ii G_jj); select_row
exactly.
"""
import importlib

import pytest
import torch

from repro_torch.configs.paper import fig1_marina_pp, fig1_problem_kwargs
from repro_torch.core import ByzVRMarinaPP, logistic_problem
from repro_torch.kernels import clip_aggregate as ca
from repro_torch.kernels import ops

cmk = importlib.import_module("repro_torch.kernels.coordinate_median")
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
NO_LAUNCHES = {"row_norms": 0, "clip_bucket_select": 0, "coordinate_median": 0,
               "diff_row_ssq": 0, "bucket_means": 0, "gm_resident": 0,
               "gm_update": 0, "gram_matrix": 0, "cross_gram": 0,
               "weighted_row_sum": 0, "select_row": 0, "bucketed_cm": 0,
               "cclip_resident": 0, "cclip_update": 0,
               "clipped_diff_ssq": 0, "clipped_diff_scale": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,s", [(20, 40, 2), (21, 40, 2), (20, 4133, 1),
                                   (64, 777, 3), (5, 1, 2)], ids=str)
@pytest.mark.parametrize("trim", [-1.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernels_match_plain(card, n, d, s, trim, dtype):
    g = torch.Generator(device=card).manual_seed(n + d)
    xs = torch.randn(n, d, device=card, generator=g).to(dtype)
    mask = torch.rand(n, device=card, generator=g) > 0.3
    idx = torch.randperm(n, device=card, generator=g).int()
    factors = torch.rand(n, device=card, generator=g)
    exact = dict(rtol=0, atol=0) if trim < 0 else SUM_TOL
    ops.reset_launch_counts()
    bidx = idx if s > 1 else None
    out = ca.clip_bucket_select(xs, factors, mask.float(), bidx, s, trim)
    plain = ca.clip_bucket_select_plain(xs, factors, mask.float(), bidx, s,
                                        trim)
    torch.testing.assert_close(out, plain, **exact)
    torch.testing.assert_close(ops.row_norms(xs), ca.row_norms_plain(xs),
                               rtol=1e-5, atol=0)
    cm = ops.trimmed_mean(xs, mask, trim) if trim >= 0 \
        else ops.coordinate_median(xs, mask)
    torch.testing.assert_close(
        cm, cmk.coordinate_median_plain(xs, mask, trim).to(dtype), **exact)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, row_norms=1,
                                       clip_bucket_select=1,
                                       coordinate_median=1)


@pytest.mark.cuda
def test_cuda_all_masked_gives_big(card):
    xs = torch.randn(6, 300, device=card)
    none = torch.zeros(6, dtype=torch.bool, device=card)
    big = torch.full((300,), 3.4e37, device=card)
    torch.testing.assert_close(ops.coordinate_median(xs, none), big,
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.trimmed_mean(xs, none, 0.1), big / 2,
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_nan", [1, 12], ids=["one-nan-row", "nan-majority"])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("trim", [-1.0, 0.1])
def test_cuda_nan_rows_sort_last_as_in_plain(card, n_nan, s, trim):
    """NaN sorts after every value in the kernel as in torch.sort (after
    masked rows' 3.4e37 too), and a selected NaN comes out as NaN."""
    g = torch.Generator(device=card).manual_seed(7 + n_nan)
    n, d = 20, 300
    xs = torch.randn(n, d, device=card, generator=g)
    xs[torch.randperm(n, device=card, generator=g)[:n_nan]] = float("nan")
    xs[0, :5] = -float("nan")  # the sign of a NaN does not move it
    mask = (torch.rand(n, device=card, generator=g) > 0.1).float()
    idx = torch.randperm(n, device=card, generator=g).int()
    factors = torch.rand(n, device=card, generator=g)
    bidx = idx if s > 1 else None
    exact = dict(rtol=0, atol=0) if trim < 0 else SUM_TOL
    torch.testing.assert_close(
        ca.clip_bucket_select(xs, factors, mask, bidx, s, trim),
        ca.clip_bucket_select_plain(xs, factors, mask, bidx, s, trim),
        equal_nan=True, **exact)
    cm = ops.trimmed_mean(xs, mask, trim) if trim >= 0 \
        else ops.coordinate_median(xs, mask)
    plain = cmk.coordinate_median_plain(xs, mask, trim)
    torch.testing.assert_close(cm, plain, equal_nan=True, **exact)
    assert bool((plain.abs() < 1e30).all()) == (n_nan == 1)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernel_does_not_take(card):
    with pytest.raises(ValueError, match="contiguous"):
        ops.coordinate_median(torch.randn(8, 6, device=card).t())
    with pytest.raises(ValueError, match="at most 128"):
        ops.coordinate_median(torch.randn(129, 6, device=card))
    with pytest.raises(ValueError, match="is on"):
        ops.coordinate_median(torch.randn(8, 6, device=card),
                              torch.ones(8, dtype=torch.bool))


@pytest.mark.cuda
def test_cuda_engine_goes_through_the_kernels(card):
    """backend "auto" on CUDA tensors: every server call launches a
    kernel, and the run agrees with the plain path on the same draws."""
    prob = logistic_problem(0, device=card, **fig1_problem_kwargs())
    ops.reset_launch_counts()
    _, met = ByzVRMarinaPP(prob, fig1_marina_pp(True), device=card).run(40)
    counts = ops.launch_counts()
    diff_rounds = int((~met["full_round"]).sum())
    assert counts == dict(NO_LAUNCHES, row_norms=diff_rounds,
                          clip_bucket_select=41)
    cpu = logistic_problem(0, device="cpu", **fig1_problem_kwargs())
    _, ref = ByzVRMarinaPP(cpu, fig1_marina_pp(True), device="cpu").run(40)
    torch.testing.assert_close(met["loss"], ref["loss"], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the Weiszfeld geometric-median kernels (csrc/geometric_median.cu)
# ---------------------------------------------------------------------------

def _gm_mods():
    return (importlib.import_module("repro_torch.kernels.centered_clip"),
            importlib.import_module("repro_torch.kernels.geometric_median"))


def _gm_case(card, n, d, s, dtype, seed, masked=True):
    cc, _ = _gm_mods()
    g = torch.Generator(device=card).manual_seed(seed)
    xs = torch.randn(n, d, device=card, generator=g).to(dtype)
    mask = torch.rand(n, device=card, generator=g) > 0.3
    mask[0] = True
    if not masked:
        mask[:] = False
    idx = torch.randperm(n, device=card, generator=g).int()
    factors = torch.rand(n, device=card, generator=g)
    m, f, i = cc.pad_bucket_aux(mask.float(), factors, idx, n, s)
    return xs, mask, idx, m, f, i


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 21])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_gm_kernels_match_plain(card, n, s, dtype):
    """Each kernel against its plain version on the same inputs; the
    outputs are f32 for both input types, so the f32 tolerance holds."""
    cc, gmk = _gm_mods()
    xs, mask, idx, m, f, i = _gm_case(card, n, 698, s, dtype, n * 10 + s)
    ops.reset_launch_counts()
    torch.testing.assert_close(
        gmk.gm_resident(xs, m, f, i, s, iters=8),
        gmk.gm_resident_plain(xs, m, f, i, s, iters=8, eps=1e-8), **SUM_TOL)
    if s >= 2:
        torch.testing.assert_close(cc.bucket_means(xs, m, f, i, s),
                                   cc.bucket_means_plain(xs, m, f, i, s)[0],
                                   **SUM_TOL)
    z = torch.randn(698, device=card)
    torch.testing.assert_close(cc.diff_row_ssq(xs, z, f[:n]),
                               cc.diff_row_ssq_plain(xs, z, f[:n]), **SUM_TOL)
    w = torch.rand(n, device=card)
    torch.testing.assert_close(gmk.gm_update(xs, w, f[:n], w.sum()),
                               gmk.gm_update_plain(xs, w, f[:n], w.sum()),
                               **SUM_TOL)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, diff_row_ssq=1,
                                       bucket_means=int(s >= 2),
                                       gm_resident=1, gm_update=1)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2])
def test_cuda_gm_dispatch_both_sides_of_the_threshold(card, s):
    """The largest d the resident rule admits at n = 20 runs gm_resident;
    one coordinate more runs the tiled kernels; both agree with the plain
    versions composed the same way."""
    cc, gmk = _gm_mods()
    budget = cc.smem_budget(card)
    rows = 20 // s
    d_max = (budget // 4 - rows * 18) // (rows + 1)
    assert cc.resident_smem_bytes(rows, d_max) <= budget \
        < cc.resident_smem_bytes(rows, d_max + 1)
    for d, resident in ((d_max, True), (d_max + 1, False)):
        xs, mask, idx, _, _, _ = _gm_case(card, 20, d, s, torch.float32, d)
        bidx = idx if s >= 2 else None
        ops.reset_launch_counts()
        got, norms = ops.clip_then_geometric_median(xs, 1.5, mask, bidx,
                                                    bucket_s=s)
        counts = ops.launch_counts()
        assert counts["gm_resident"] == int(resident)
        assert counts["gm_update"] == (0 if resident else 9)
        want, wnorms = gmk.clip_then_geometric_median_plain(
            xs, 1.5, mask, bidx, bucket_s=s)
        torch.testing.assert_close(got, want, **SUM_TOL)
        torch.testing.assert_close(norms, wnorms, **SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 3])
def test_cuda_gm_all_masked_gives_zero(card, s):
    xs, mask, idx, _, _, _ = _gm_case(card, 21, 700, s, torch.float32, 3,
                                      masked=False)
    bidx = idx if s >= 2 else None
    zero = torch.zeros(700, device=card)
    got, _ = ops.clip_then_geometric_median(xs, 1.0, mask, bidx, bucket_s=s)
    torch.testing.assert_close(got, zero, rtol=0, atol=0)
    wide = torch.randn(21, 6000, device=card)  # the tiled schedule
    got, _ = ops.clip_then_geometric_median(wide, 1.0, mask, bidx, bucket_s=s)
    torch.testing.assert_close(got, torch.zeros(6000, device=card), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_cuda_gm_kernels_repeat_bit_for_bit(card):
    """No atomics: two launches on the same inputs are bitwise equal."""
    cc, gmk = _gm_mods()
    xs, _, _, m, f, i = _gm_case(card, 21, 70000, 3, torch.float32, 8)
    z = torch.randn(70000, device=card)
    w = torch.rand(21, device=card)
    runs = [lambda: cc.diff_row_ssq(xs, z, f[:21]),
            lambda: cc.bucket_means(xs, m, f, i, 3),
            lambda: gmk.gm_update(xs, w, f[:21], w.sum()),
            lambda: gmk.gm_resident(xs[:, :698].contiguous(), m, f, i, 3)]
    for run in runs:
        assert torch.equal(run(), run())


@pytest.mark.cuda
def test_cuda_fig2_engine_goes_through_the_kernels(card):
    from repro_torch.configs.paper import fig2_heuristic, fig2_problem_kwargs
    from repro_torch.core import ClippedPPMomentum, mlp_problem

    cfg = fig2_heuristic("rfa", "shb", True)
    prob = mlp_problem(0, device=card, **fig2_problem_kwargs("shb"))
    ops.reset_launch_counts()
    _, met = ClippedPPMomentum(prob, cfg, device=card).run(30)
    counts = ops.launch_counts()
    assert counts["gm_resident"] == 31 and counts["row_norms"] == 30
    cpu = mlp_problem(0, device="cpu", **fig2_problem_kwargs("shb"))
    _, ref = ClippedPPMomentum(cpu, cfg, device="cpu").run(30)
    torch.testing.assert_close(met["loss"], ref["loss"], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the Krum kernels (csrc/krum.cu) and the streaming server on the card
# ---------------------------------------------------------------------------

def _krum_mod():
    return importlib.import_module("repro_torch.kernels.krum")


def _gram_close(got, want):
    scale = torch.sqrt(torch.outer(want.diagonal(), want.diagonal()).abs())
    err = (got - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(16, 4096), (17, 4097), (20, 1 << 16),
                                 (5, 1), (64, 999), (128, 300), (3, 70000)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_krum_kernels_match_plain(card, n, d, dtype):
    kr = _krum_mod()
    g = torch.Generator(device=card).manual_seed(n + d)
    xs = torch.randn(n, d, device=card, generator=g).to(dtype)
    ys = torch.randn(n, d, device=card, generator=g).to(dtype)
    w = torch.rand(n, device=card, generator=g)
    w[torch.rand(n, device=card, generator=g) > 0.6] = 0.0
    ops.reset_launch_counts()
    gram = kr.gram_matrix(xs)
    _gram_close(gram, kr.gram_matrix_plain(xs))
    cross = kr.cross_gram(xs, ys)
    want = kr.cross_gram_plain(xs, ys)
    scale = torch.sqrt(torch.outer(kr.gram_matrix_plain(xs).diagonal(),
                                   kr.gram_matrix_plain(ys).diagonal()))
    assert bool(((cross - want).abs() <= 1e-5 * scale + 1e-6).all())
    torch.testing.assert_close(kr.weighted_row_sum(xs, w),
                               kr.weighted_row_sum_plain(xs, w), **SUM_TOL)
    win, sc = torch.tensor(n // 2, device=card), torch.tensor(0.5, device=card)
    torch.testing.assert_close(kr.select_row(xs, win, sc),
                               kr.select_row_plain(xs, win, sc), rtol=0,
                               atol=0)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, gram_matrix=1,
                                       cross_gram=1, weighted_row_sum=1,
                                       select_row=1)


# The Gram kernels' shapes: the four of before (f32, a fresh allocation,
# keeping their ids), then rows that start off a 16-byte boundary (d = 1, 2, 3
# mod 4 in f32 and odd d in bf16, the matrix 0-3 values past an allocation),
# tiny d, n in {1, 4, 5, 20, 128}, a d of many steps and misaligned rows, and
# matrices whose last row ends at the end of their allocation ("end").
F32, BF16 = torch.float32, torch.bfloat16
GRAM_CASES = [pytest.param(n, d, F32, 0, id=f"{n}-{d}") for n, d in (
    (16, 4096), (17, 4097), (20, 1 << 20), (128, 3000))] + [
    pytest.param(n, d, dt, where,
                 id=f"{'f32' if dt == F32 else 'bf16'}-{n}-{d}-{where}")
    for n, d, dt, where in (
        (20, 4097, F32, 1), (20, 4098, F32, 2), (20, 4099, F32, 3),
        (17, 4097, BF16, 1), (20, 4099, BF16, 0), (5, 33, BF16, 3),
        (1, 1, F32, 0), (5, 1, F32, 1), (4, 2, F32, 0), (20, 3, F32, 2),
        (4, 5, BF16, 1), (1, 33, F32, 3), (5, 31, F32, 0), (20, 17, BF16, 0),
        (128, 9, F32, 1), (128, 33, BF16, 1), (20, (1 << 20) + 3, F32, 1),
        (20, 4097, F32, "end"), (17, 4099, BF16, "end"), (5, 3, F32, "end"))]


def _gram_rows(card, n, d, dtype, where, seed):
    """(n, d) rows ``where`` values past an allocation's start (0-3), or
    ending at the allocation's end ("end"; the allocation a whole number of
    the allocator's 512-byte blocks)."""
    if where != "end":
        return _offset_rows(card, n, d, dtype, where, seed)
    per = 512 // torch.tensor([], dtype=dtype).element_size()
    size = -(-n * d // per) * per
    g = torch.Generator(device=card).manual_seed(seed)
    buf = torch.randn(size, device=card, generator=g).to(dtype)
    return buf[size - n * d:].view(n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,dtype,where", GRAM_CASES)
def test_cuda_gram_is_symmetric_and_cross_equals_gram_bitwise(card, n, d,
                                                              dtype, where):
    kr = _krum_mod()
    xs = _gram_rows(card, n, d, dtype, where, d)
    gram = kr.gram_matrix(xs)
    assert torch.equal(gram, gram.T)
    assert torch.equal(kr.cross_gram(xs, xs), gram)
    assert torch.equal(kr.gram_matrix(xs), gram)  # no atomics
    emb = torch.zeros_like(xs)
    rows = torch.arange(1, n, 3, device=card)
    emb[rows] = xs[rows]
    blk = kr.cross_gram(emb, xs)
    assert torch.equal(blk[rows], gram[rows])
    assert torch.equal(blk.T[:, rows], gram[:, rows])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,dtype,where", GRAM_CASES)
def test_cuda_gram_within_f32_summation_limit_of_float64(card, n, d, dtype,
                                                         where):
    """Every Gram and cross-Gram entry lies within 8 f32 rounding units
    of the float64 product: 2^-24 sqrt(D) (sqrt(sum_k a_ik^2 b_jk^2) +
    |G_ij|), D the kernel's rounding depth.  On f32 inputs the same limit
    rejects the operands rounded to TF32."""
    kr = _krum_mod()
    xs = _gram_rows(card, n, d, dtype, where, n * d)
    ys = _gram_rows(card, n, d, dtype, where, n * d + 1)
    unit = 2.0 ** -24 * kr.gram_rounding_depth(n, d) ** 0.5
    for got, a, b in ((kr.gram_matrix(xs), xs, xs),
                      (kr.cross_gram(xs, ys), xs, ys)):
        a64, b64 = a.double(), b.double()
        g64 = a64 @ b64.T
        limit = 8 * unit * (((a64 * a64) @ (b64 * b64).T).sqrt() + g64.abs())
        assert bool(((got.double() - g64).abs() <= limit).all())
    if dtype != F32:
        return
    tf32 = ((xs.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    g64 = xs.double() @ xs.double().T
    limit = 8 * unit * (((xs.double() ** 2) @ (xs.double() ** 2).T).sqrt()
                        + g64.abs())
    stand_in = tf32.double() @ tf32.double().T
    assert not bool(((stand_in - g64).abs() <= limit).all())


@pytest.mark.cuda
def test_cuda_apply_kernels_guard_inf_and_clamp(card):
    kr = _krum_mod()
    xs = torch.randn(6, 5000, device=card)
    xs[2] = float("inf")
    w = torch.tensor([0.5, 1.0, 0.0, 0.25, 0.0, 2.0], device=card)
    got = kr.weighted_row_sum(xs, w)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, kr.weighted_row_sum_plain(xs, w),
                               rtol=0, atol=0)
    zero = kr.select_row(xs, torch.tensor(2, device=card),
                         torch.tensor(0.0, device=card))
    assert torch.equal(zero, torch.zeros(5000, device=card))
    for win, row in ((-4, 0), (99, 5)):
        got = kr.select_row(xs, torch.tensor(win, device=card),
                            torch.tensor(1.5, device=card))
        assert torch.equal(got, xs[row] * 1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("multi", [False, True], ids=["krum", "multikrum"])
@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "tf32-on"])
def test_cuda_bucketed_selection_equals_the_cpu(card, s, multi, tf32):
    """The (n, n) selection algebra on the card selects as on the CPU,
    whatever the TF32 setting: it has no matmul for TF32 to touch."""
    kr = _krum_mod()
    g = torch.Generator().manual_seed(s + 2 * multi)
    xs = torch.randn(20, 3000, generator=g) * torch.rand(20, 1, generator=g)
    mask = torch.rand(20, generator=g) > 0.2
    idx = torch.randperm(20, generator=g).int()
    gram = kr.gram_matrix_plain(xs)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        on_card, _ = kr.krum_select_from_gram(
            gram.to(card), mask.to(card), 0.8, None, idx.to(card),
            byz_bound=2, multi=multi, bucket_s=s)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    on_cpu, _ = kr.krum_select_from_gram(gram, mask, 0.8, None, idx,
                                         byz_bound=2, multi=multi, bucket_s=s)
    assert int(on_card.winner) == int(on_cpu.winner)
    torch.testing.assert_close(on_card.weights.cpu(), on_cpu.weights,
                               rtol=1e-5, atol=1e-7)
    assert torch.equal(on_card.weights.cpu() != 0, on_cpu.weights != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rule,bucket_s", [("krum", 0), ("multi_krum", 0),
                                           ("krum", 2), ("multi_krum", 2),
                                           ("cm", 0), ("centered_clip", 0),
                                           ("centered_clip", 2)])
@pytest.mark.parametrize("radius", [None, 5.0], ids=["noclip", "clip"])
def test_cuda_serve_close_bitwise_equals_one_shot(card, rule, bucket_s,
                                                  radius):
    """On the card the executor takes the kernel form: every round's
    incremental close equals the one-shot ServerStep bit for bit, the
    kernels were launched, and the aggregates agree with the CPU path."""
    from repro_torch.api import (AggregatorSpec, BucketSpec, ClipSpec,
                                 ScheduleSpec, ServerPlan)
    from repro_torch.serve import CohortBuilder, round_key

    plan = ServerPlan(aggregate=AggregatorSpec(rule, byz_bound=4),
                      clip=ClipSpec(radius=radius) if radius else None,
                      bucket=BucketSpec(s=bucket_s) if bucket_s else None,
                      schedule=ScheduleSpec(placement="naive", backend="auto"))
    rng = torch.Generator().manual_seed(1)
    xs = torch.randn(16, 4096, generator=rng) * 3
    step = plan.build()
    for trial, k in enumerate((12, 16, 5)):
        slots = torch.randperm(16, generator=rng)[:k]
        on_card = CohortBuilder(plan, 16, 4096, chunk_size=3, device=card)
        on_cpu = CohortBuilder(plan, 16, 4096, chunk_size=3, device="cpu")
        assert on_card.executor.kernels and not on_cpu.executor.kernels
        ops.reset_launch_counts()
        for lo in range(0, k, 4):
            ids = slots[lo:lo + 4].numpy()
            on_card.ingest(xs[ids].numpy(), ids)
            on_cpu.ingest(xs[ids].numpy(), ids)
        got = on_card.close(round_key(3, trial))
        buf, arrived, _ = on_card.state()
        want = step(buf, mask=arrived, key=round_key(3, trial))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        counts = ops.launch_counts()
        if rule == "cm" and radius:  # pass 1 + pass 2, close and one-shot
            assert counts == dict(NO_LAUNCHES, row_norms=2,
                                  clip_bucket_select=2)
        elif rule == "cm":
            assert counts == dict(NO_LAUNCHES, coordinate_median=2)
        elif rule == "centered_clip" and bucket_s:  # 8 bucket means: resident
            assert counts == dict(NO_LAUNCHES, row_norms=2 * bool(radius),
                                  cclip_resident=2)
        elif rule == "centered_clip":  # 16 rows of 4,096 exceed 227 KB
            assert counts == dict(NO_LAUNCHES, row_norms=2 * bool(radius),
                                  diff_row_ssq=10, cclip_update=12)
        else:
            chunks = sum(-(-min(4, k - lo) // 3) for lo in range(0, k, 4))
            apply = "select_row" if rule == "krum" and not bucket_s \
                else "weighted_row_sum"
            assert counts == dict(NO_LAUNCHES, cross_gram=chunks,
                                  gram_matrix=1, **{apply: 2})
        torch.testing.assert_close(got.cpu(), on_cpu.close(
            round_key(3, trial)), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# CenteredClip (csrc/centered_clip.cu), clipped_diff (csrc/clipped_diff.cu)
# and the bucketed median (csrc/clip_aggregate.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 21])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_cclip_kernels_match_plain(card, n, s, dtype):
    cc, _ = _gm_mods()
    xs, mask, idx, m, f, i = _gm_case(card, n, 698, s, dtype, n * 7 + s)
    ops.reset_launch_counts()
    torch.testing.assert_close(
        cc.cclip_resident(xs, m, f, i, s, iters=5, tau=1.0),
        cc.cclip_resident_plain(xs, m, f, i, s, iters=5, tau=1.0), **SUM_TOL)
    z = torch.randn(698, device=card)
    sc = torch.rand(n, device=card) * m[:n]
    den = m[:n].sum().clamp(min=1.0)
    for zz in (z, None):
        torch.testing.assert_close(
            cc.cclip_update(xs, sc, f[:n], zz, den),
            cc.cclip_update_plain(xs, sc, f[:n], zz, den), **SUM_TOL)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, cclip_resident=1,
                                       cclip_update=2)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2])
def test_cuda_cclip_dispatch_both_sides_of_the_threshold(card, s):
    """The largest d CenteredClip's own resident count admits at n = 20
    runs cclip_resident; one coordinate more runs the tiled kernels (v0 and
    5 steps: 6 updates, 5 distance passes); both agree with the plain
    versions composed the same way."""
    cc, _ = _gm_mods()
    budget = cc.smem_budget(card, "cclip")
    rows = 20 // s
    d_max = (budget // 4 - rows * 18) // (rows + 1)
    assert cc.resident_smem_bytes(rows, d_max, "cclip") <= budget \
        < cc.resident_smem_bytes(rows, d_max + 1, "cclip")
    for d, resident in ((d_max, True), (d_max + 1, False)):
        xs, mask, idx, _, _, _ = _gm_case(card, 20, d, s, torch.float32, d)
        bidx = idx if s >= 2 else None
        ops.reset_launch_counts()
        got, norms = ops.clip_then_centered_clip(xs, 1.5, mask, bidx,
                                                 bucket_s=s, tau=0.5)
        counts = ops.launch_counts()
        assert counts == dict(
            NO_LAUNCHES, row_norms=1, cclip_resident=int(resident),
            cclip_update=0 if resident else 6,
            diff_row_ssq=0 if resident else 5,
            bucket_means=int(not resident and s >= 2))
        want, wnorms = cc.clip_then_centered_clip_plain(
            xs, 1.5, mask, bidx, bucket_s=s, tau=0.5)
        torch.testing.assert_close(got, want, **SUM_TOL)
        torch.testing.assert_close(norms, wnorms, **SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 1000, 262145, 3 * 2 ** 20 + 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("keep_dtype", [torch.bool, torch.float32],
                         ids=["bool", "num"])
def test_cuda_clipped_diff_matches_plain(card, length, dtype, keep_dtype):
    """The norm to rtol 1e-6; the output bit for bit given the same
    factor: the plain version rescaled by the kernel's own norm."""
    cdk = importlib.import_module("repro_torch.kernels.clipped_diff")
    g = torch.Generator(device=card).manual_seed(length)
    shape = (length,) if length % 2 else (2, length // 2)
    gn = torch.randn(shape, device=card, generator=g).to(dtype)
    go = torch.randn(shape, device=card, generator=g).to(dtype)
    keep = (torch.rand(shape, device=card, generator=g) < 0.3).to(keep_dtype)
    radius = 0.25 * float(length) ** 0.5
    ops.reset_launch_counts()
    got, norm = ops.clipped_diff(gn, go, radius, keep, 10.0 / 3.0)
    _, want_norm = cdk.clipped_diff_plain(gn, go, radius, keep, 10.0 / 3.0)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, clipped_diff_ssq=1,
                                       clipped_diff_scale=1)
    assert got.shape == shape and got.dtype == dtype
    torch.testing.assert_close(norm, want_norm, rtol=1e-6, atol=0)
    d = ((gn.float() - go.float()) * keep.to(dtype).float()
         * torch.tensor(10.0 / 3.0, device=card)).to(dtype).float()
    factor = ca.clip_factor(norm, torch.tensor(radius, device=card))
    assert torch.equal(got, (d * factor).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(20, 2), (21, 2), (21, 3), (16, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_bucketed_cm_matches_plain(card, n, s, dtype):
    g = torch.Generator(device=card).manual_seed(n * s)
    xs = torch.randn(n, 4133, device=card, generator=g).to(dtype)
    mask = (torch.rand(n, device=card, generator=g) > 0.3).float()
    n_p = n + (-n) % s
    perm = torch.randperm(n_p, device=card, generator=g)
    ops.reset_launch_counts()
    got = ops.bucketed_coordinate_median(xs, perm, mask, s=s)
    want = ca.bucketed_cm_plain(xs, perm.int(), mask, s).to(dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.launch_counts() == dict(NO_LAUNCHES, bucketed_cm=1)


@pytest.mark.cuda
def test_cuda_new_kernels_repeat_bit_for_bit(card):
    cc, _ = _gm_mods()
    xs, _, _, m, f, i = _gm_case(card, 21, 70000, 3, torch.float32, 9)
    sc = torch.rand(21, device=card)
    z = torch.randn(70000, device=card)
    keep = torch.rand(21, 70000, device=card) < 0.5
    runs = [lambda: cc.cclip_update(xs, sc, f[:21], z, sc.sum()),
            lambda: cc.cclip_resident(xs[:, :698].contiguous(), m, f, i, 3),
            lambda: ops.clipped_diff(xs, xs.flip(0), 3.0, keep, 2.0)[1],
            lambda: ops.bucketed_coordinate_median(
                xs, torch.arange(21, device=card), s=3)]
    for run in runs:
        assert torch.equal(run(), run())


# ---------------------------------------------------------------------------
# the streaming kernels at every alignment: select_row, clipped_diff_scale
# ---------------------------------------------------------------------------

STREAM_DS = [1, 3, 4, 5, 7, 8, 9, 4095, 4097, 2 ** 20 + 3]


def _cd_mod():
    return importlib.import_module("repro_torch.kernels.clipped_diff")


def _offset_rows(card, n, d, dtype, offset, seed):
    """An (n, d) contiguous matrix whose storage starts ``offset`` values
    past an allocation, so that row r starts at offset + r d values."""
    g = torch.Generator(device=card).manual_seed(seed)
    buf = torch.randn(offset + n * d, device=card, generator=g).to(dtype)
    return buf[offset:].view(n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", STREAM_DS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_select_row_at_every_alignment(card, d, dtype):
    """Every winner of n = 20 rows, with the matrix starting 0-7 values
    into its allocation: the row starts at every residue modulo 4 (f32)
    and 8 (bf16).  Bit for bit the plain version, one launch a call."""
    kr = _krum_mod()
    n = 20
    sc = torch.tensor(0.75, device=card)
    for offset in range(8):
        xs = _offset_rows(card, n, d, dtype, offset, d + offset)
        for r in range(n):
            win = torch.tensor(r, dtype=torch.int32, device=card)
            ops.reset_launch_counts()
            got = kr.select_row(xs, win, sc)
            torch.cuda.synchronize()
            assert ops.launch_counts() == dict(NO_LAUNCHES, select_row=1)
            assert torch.equal(got, kr.select_row_plain(xs, win, sc))
            assert torch.equal(got, xs[r].float() * 0.75)


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_select_row_index_types_clamp_and_non_finite(card, index_dtype,
                                                          dtype):
    """int32 and int64 winners, out-of-range winners (clamped), scale 0 on an inf row (zeros, no NaN), and inf and NaN
    values with a scale that is not 0 (propagated as in the plain
    version)."""
    kr = _krum_mod()
    n, d = 7, 4097
    xs = _offset_rows(card, n, d, dtype, 3, 11)
    xs[2] = float("inf")
    xs[4, ::3] = float("nan")
    xs[4, 1::3] = float("-inf")
    cases = [(2, 0.0), (2, 1.5), (4, -2.0), (4, 0.0), (-5, 1.25), (99, 1.25),
             (6, float("nan"))]
    for win, s in cases:
        w = torch.tensor(win, dtype=index_dtype, device=card)
        sc = torch.tensor(s, device=card)
        got = kr.select_row(xs, w, sc)
        want = kr.select_row_plain(xs, w, sc)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        if s == 0.0:
            assert torch.equal(got, torch.zeros(d, device=card))


@pytest.mark.cuda
def test_cuda_select_row_launches_no_cast_for_an_int32_winner(card):
    """One kernel a call and no other operation: an int32 winner (the
    engine's) and an f32 scale reach the kernel as they are."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    kr = _krum_mod()
    xs = torch.randn(20, 4099, device=card)
    sc = torch.tensor(0.5, device=card)
    win = torch.tensor(10, dtype=torch.int32, device=card)
    kr.select_row(xs, win, sc)  # built and loaded before the count
    ops.reset_launch_counts()
    with Ops() as seen:
        kr.select_row(xs, win, sc)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, select_row=1)
    assert seen.seen == ["aten.empty.memory_format"]


@pytest.mark.cuda
@pytest.mark.parametrize("length", [*range(1, 10), 4095, 4096, 4097,
                                    3 * 2 ** 20 + 7], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_clipped_diff_scale_at_every_alignment(card, length, dtype):
    """The scale pass on a d that starts 0-7 values past an aligned start:
    bit for bit the plain version, one launch a call; and the whole
    clipped_diff on a 2-D d of the same length."""
    cdk = _cd_mod()
    g = torch.Generator(device=card).manual_seed(length)
    base = torch.randn(length + 8, device=card, generator=g).to(dtype)
    factor = torch.tensor(0.6180339887, device=card)
    for offset in range(8):
        d = base[offset:offset + length]
        ops.reset_launch_counts()
        got = cdk.clipped_diff_scale(d, factor)
        torch.cuda.synchronize()
        assert ops.launch_counts() == dict(NO_LAUNCHES, clipped_diff_scale=1)
        assert got.dtype == dtype
        assert torch.equal(got, cdk.clipped_diff_scale_plain(d, factor))
    shape = (1, length) if length % 2 else (2, length // 2)
    gn = torch.randn(shape, device=card, generator=g).to(dtype)
    go = torch.randn(shape, device=card, generator=g).to(dtype)
    keep = torch.rand(shape, device=card, generator=g) < 0.5
    got, norm = ops.clipped_diff(gn, go, 0.5, keep, 2.0)
    d, _ = cdk.clipped_diff_ssq_plain(gn.view(-1), go.view(-1),
                                      keep.view(-1), 2.0)
    factor = ca.clip_factor(norm, torch.tensor(0.5, device=card))
    assert got.shape == shape
    assert torch.equal(got.view(-1), cdk.clipped_diff_scale_plain(d, factor))


@pytest.mark.cuda
def test_cuda_clipped_diff_scale_refuses_a_strided_d(card):
    """A CUDA view that is not dense (every other value, a column) raises
    instead of reading d.numel() consecutive values; the contiguous copy
    of the same values goes through the kernel."""
    cdk = _cd_mod()
    v = torch.randn(64, device=card)
    x = torch.randn(8, 5, device=card)
    factor = torch.tensor(0.5, device=card)
    for d in (v[::2], x[:, 2]):
        ops.reset_launch_counts()
        with pytest.raises(ValueError, match="contiguous"):
            cdk.clipped_diff_scale(d, factor)
        assert ops.launch_counts() == NO_LAUNCHES
        got = cdk.clipped_diff_scale(d.contiguous(), factor)
        torch.cuda.synchronize()
        assert torch.equal(got, cdk.clipped_diff_scale_plain(d, factor))
