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
from repro_torch.kernels import networks, ops

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
# the selection template's networks (csrc/select.cuh, select_networks.cuh)
# ---------------------------------------------------------------------------

def _bucket_mask(card, g, w, s, kind):
    """(w * s,) row mask: every bucket kept ("all"), about 70% of them
    ("random") or 4 of them ("four"); a kept bucket keeps its first row
    and each other row with probability 1/2."""
    if kind == "all":
        keep = torch.ones(w, dtype=torch.bool, device=card)
    elif kind == "random":
        keep = torch.rand(w, device=card, generator=g) > 0.3
    else:
        keep = torch.zeros(w, dtype=torch.bool, device=card)
        keep[torch.randperm(w, device=card, generator=g)[:4]] = True
    rows = torch.rand(w, s, device=card, generator=g) > 0.5
    rows[:, 0] = True
    return (rows & keep[:, None]).reshape(-1).float()


@pytest.mark.cuda
@pytest.mark.parametrize("w,s", networks.EXACT, ids=str)
@pytest.mark.parametrize("kind", ["all", "random", "four"])
@pytest.mark.parametrize("trim", [-1.0, 0.1])
def test_cuda_exact_networks_by_the_0_1_principle(card, w, s, kind, trim):
    """Column c of the input holds the w bits of c (each bucket's s rows
    alike, so a kept bucket's mean is its bit): every 0-1 input of the
    exact width's network, under three masks.  The median equals the plain
    version's exactly, the trimmed mean within SUM_TOL."""
    g = torch.Generator(device=card).manual_seed(w * 10 + s)
    cols = torch.arange(2 ** w, device=card)
    bits = ((cols[None, :] >> torch.arange(w, device=card)[:, None]) & 1)
    xs = bits.float().repeat_interleave(s, dim=0).contiguous()
    mask = _bucket_mask(card, g, w, s, kind)
    ones = torch.ones(w * s, device=card)
    exact = dict(rtol=0, atol=0) if trim < 0 else SUM_TOL
    ops.reset_launch_counts()
    got = ca.clip_bucket_select(xs, ones, mask, None, s, trim)
    torch.testing.assert_close(
        got, ca.clip_bucket_select_plain(xs, ones, mask, None, s, trim),
        **exact)
    launches = dict(NO_LAUNCHES, clip_bucket_select=1)
    if s == 1:
        cm = ops.coordinate_median(xs, mask) if trim < 0 \
            else ops.trimmed_mean(xs, mask, trim)
        torch.testing.assert_close(
            cm, cmk.coordinate_median_plain(xs, mask, trim), **exact)
        launches["coordinate_median"] = 1
    torch.cuda.synchronize()
    assert ops.launch_counts() == launches


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 16])
def test_cuda_median_at_every_kept_count(card, n):
    """The s = 1 median takes its own network for each count of kept rows
    (0..n).  The columns hold every 0-1 input of the n rows, then random
    values with +inf, NaN, 1e38 and 3.4e37 among them (kept keys above
    the empty slots' 3.4e37, the path that sorts all n slots): the median
    equals the plain version's at every count."""
    g = torch.Generator(device=card).manual_seed(n)
    cols = torch.arange(2 ** n, device=card)
    bits = ((cols[None, :] >> torch.arange(n, device=card)[:, None]) & 1)
    odd = torch.randn(n, 4099, device=card, generator=g)
    for value, every in ((float("inf"), 5), (float("nan"), 7), (1e38, 3),
                         (3.4e37, 11)):
        hit = torch.rand(n, 4099, device=card, generator=g) < 0.3
        hit[:, ::every] = False
        odd[hit] = value
    xs = torch.cat([bits.float(), odd], dim=1).contiguous()
    for count in range(n + 1):
        mask = torch.zeros(n, dtype=torch.bool, device=card)
        mask[torch.randperm(n, device=card, generator=g)[:count]] = True
        ops.reset_launch_counts()
        torch.testing.assert_close(
            ops.coordinate_median(xs, mask),
            cmk.coordinate_median_plain(xs, mask, -1.0),
            equal_nan=True, rtol=0, atol=0)
        torch.cuda.synchronize()
        assert ops.launch_counts() == dict(NO_LAUNCHES, coordinate_median=1)


# every exact (nb, s) and one generic nb per NB_CAPS class (16/32/64/128)
# at s = 1, 2 and 3
SELECT_WIDTHS = [(20, 1), (16, 1), (20, 2), (16, 2), (18, 3), (16, 3),
                 (11, 1), (21, 1), (40, 1), (100, 1), (22, 2), (42, 2),
                 (100, 2), (200, 2), (21, 3), (64, 3), (250, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", SELECT_WIDTHS, ids=str)
@pytest.mark.parametrize("weights", [False, True], ids=["0-1", "weights"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_selection_random_values_at_every_width(card, n, s, weights,
                                                     dtype):
    """Random rows, clip factors, Bucketing order and a mask of 0/1 (the
    divide left out where it is exact) or of fractional weights (the IEEE
    divide), at the exact widths and a generic one of each NB_CAPS class:
    the median exactly, the trimmed mean within SUM_TOL."""
    g = torch.Generator(device=card).manual_seed(n * 10 + s)
    xs = torch.randn(n, 1000, device=card, generator=g).to(dtype)
    keep = torch.rand(n, device=card, generator=g) > 0.3
    mask = keep.float()
    if weights and s > 1:
        mask = mask * (torch.rand(n, device=card, generator=g) + 0.25)
    factors = torch.rand(n, device=card, generator=g)
    idx = torch.randperm(n, device=card, generator=g).int() if s > 1 \
        else None
    for trim in (-1.0, 0.1):
        exact = dict(rtol=0, atol=0) if trim < 0 else SUM_TOL
        torch.testing.assert_close(
            ca.clip_bucket_select(xs, factors, mask, idx, s, trim),
            ca.clip_bucket_select_plain(xs, factors, mask, idx, s, trim),
            **exact)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 16, 21])
def test_cuda_masked_inf_in_a_half_kept_bucket_makes_it_nan(card, n):
    """At s = 2 a masked row is still read when its bucket keeps the
    other row: its inf times mask 0 is NaN, so the bucket's mean is NaN,
    in the kernel as in the plain version and the reference."""
    g = torch.Generator(device=card).manual_seed(n)
    xs = torch.randn(n, 777, device=card, generator=g)
    mask = torch.ones(n, device=card)
    mask[1::4] = 0.0  # one masked row in every other bucket
    xs[1::4, ::3] = float("inf")
    xs[1::4, 1::3] = float("nan")
    idx = torch.arange(n, device=card, dtype=torch.int32)
    ones = torch.ones(n, device=card)
    plain = ca.clip_bucket_select_plain(xs, ones, mask, idx, 2, 0.0)
    assert bool(plain.isnan().any())
    for trim in (-1.0, 0.0):
        exact = dict(rtol=0, atol=0) if trim < 0 else SUM_TOL
        torch.testing.assert_close(
            ca.clip_bucket_select(xs, ones, mask, idx, 2, trim),
            ca.clip_bucket_select_plain(xs, ones, mask, idx, 2, trim),
            equal_nan=True, **exact)


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


# The resident kernels (csrc/resident.cuh) at every block size and code path
# their launcher can pick: one warp (d <= 96) with one to three coordinates
# a thread, up to 8 warps, the rows in registers (rows <= 10, d <= 768,
# two or three coordinates a thread) or in shared memory (more rows, wider
# rows, the largest width the layout admits, "max"); rows above the 16-row
# tile and above a warp's 32 (n = 40, 70 at s = 1); masks with every row
# off and with one row kept; rows that start 4 bytes past a 16-byte
# boundary ("offset").
RESIDENT_CASES = (
    [(n, d, s, dtype, iters, "random")
     for n in (20, 21) for s in (1, 2, 3)
     for d in (1, 31, 32, 33, 40, 64, 65, 96, 97, 698, 1000, 1200, 1536,
               2047, "max")
     for dtype in (torch.float32, torch.bfloat16) for iters in (0, 1, "path")]
    + [(n, d, s, torch.float32, "path", mask)
       for n, d, s in ((40, 10, 1), (40, 33, 1), (70, 300, 1), (20, 40, 2),
                       (20, 698, 2), (20, 2047, 1))
       for mask in ("random", "none", "one")]
    + [(n, d, s, dtype, "path", "offset")
       for n, d, s, dtype in ((20, 2047, 1, torch.float32),
                              (20, "max", 1, torch.float32),
                              (21, 700, 1, torch.float32),
                              (10, 698, 1, torch.float32),
                              (20, 2047, 1, torch.bfloat16))])


def _resident_case(card, n, d, s, dtype, mask_kind):
    """Rows, padded auxiliaries (random clip factors and row order) and
    the width ("max": the largest the layout admits at this n and s)."""
    cc, _ = _gm_mods()
    rows = -(-n // s)
    if d == "max":
        d = (cc.smem_budget(card) // 4 - rows * 18) // (rows + 1)
    g = torch.Generator(device=card).manual_seed(n * 10007 + d * 7 + s)
    xs = torch.randn(n, d, device=card, generator=g).to(dtype)
    if mask_kind == "offset":
        buf = torch.zeros(n * d + 1, device=card, dtype=dtype)
        buf[1:] = xs.flatten()
        xs = buf[1:].view(n, d)
    mask = torch.rand(n, device=card, generator=g) > 0.3
    mask[0] = True
    if mask_kind in ("none", "one"):
        mask[:] = False
    if mask_kind == "one":
        mask[n // 2] = True
    idx = torch.randperm(n, device=card, generator=g).int()
    factors = torch.rand(n, device=card, generator=g)
    return (xs, *cc.pad_bucket_aux(mask.float(), factors, idx, n, s))


def _case_id(case):
    n, d, s, dtype, iters, mask = case
    return (f"n{n}-d{d}-s{s}-{'bf16' if dtype == torch.bfloat16 else 'f32'}"
            f"-it{iters}-{mask}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", RESIDENT_CASES, ids=_case_id)
def test_cuda_gm_resident_matches_plain_at_every_tier(card, case):
    """gm_resident against its plain version within the sum tolerance, and
    two calls bit for bit equal ("path": the 8 steps of Fig. 2)."""
    n, d, s, dtype, iters, mask_kind = case
    _, gmk = _gm_mods()
    iters = 8 if iters == "path" else iters
    xs, m, f, i = _resident_case(card, n, d, s, dtype, mask_kind)
    ops.reset_launch_counts()
    got = gmk.gm_resident(xs, m, f, i, s, iters=iters)
    again = gmk.gm_resident(xs, m, f, i, s, iters=iters)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, gm_resident=2)
    torch.testing.assert_close(
        got, gmk.gm_resident_plain(xs, m, f, i, s, iters=iters, eps=1e-8),
        **SUM_TOL)
    assert torch.equal(got, again)


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
@pytest.mark.parametrize("case", RESIDENT_CASES, ids=_case_id)
def test_cuda_cclip_resident_matches_plain_at_every_tier(card, case):
    """cclip_resident against its plain version within the sum tolerance
    (tau 1.0, below the rows' spread, so the clip engages), and two calls
    bit for bit equal ("path": the 5 steps of Fig. 1)."""
    n, d, s, dtype, iters, mask_kind = case
    cc, _ = _gm_mods()
    iters = 5 if iters == "path" else iters
    xs, m, f, i = _resident_case(card, n, d, s, dtype, mask_kind)
    ops.reset_launch_counts()
    got = cc.cclip_resident(xs, m, f, i, s, iters=iters, tau=1.0)
    again = cc.cclip_resident(xs, m, f, i, s, iters=iters, tau=1.0)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(NO_LAUNCHES, cclip_resident=2)
    torch.testing.assert_close(
        got, cc.cclip_resident_plain(xs, m, f, i, s, iters=iters, tau=1.0),
        **SUM_TOL)
    assert torch.equal(got, again)


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


_ADAPTIVE_RULES = [("mean", True, True), ("mean", False, False),
                   ("cm", True, True), ("cm", True, False),
                   ("trimmed_mean", True, True), ("rfa", True, True),
                   ("rfa", False, False), ("centered_clip", True, True),
                   ("centered_clip", True, False), ("krum", False, False),
                   ("krum", False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rule,clip,bucket", _ADAPTIVE_RULES, ids=str)
def test_cuda_differentiable_aggregate_pairs_kernels_with_the_shadow(
        card, rule, clip, bucket):
    """The adaptive adversary's view of a kernel-backed plan: the forward
    runs the kernels (launches counted) within f32 rtol 1e-5 of the plain
    shadow, and the gradient, the shadow's backward on the same inputs
    and Bucketing order, equals the shadow's own bit for bit."""
    from repro_torch.api import (AggregatorSpec, BucketSpec, ClipSpec,
                                 ScheduleSpec, ServerPlan)
    from repro_torch.scenarios import (differentiable_aggregate,
                                       torch_shadow_plan)

    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(20, 64, device=card, generator=g)
    mask = torch.rand(20, device=card, generator=g) > 0.3
    w = torch.randn(64, device=card, generator=g)
    order = torch.randperm(20, generator=torch.Generator().manual_seed(3))
    radius = ca.row_norms_plain(x).median() if clip else None
    plan = ServerPlan(aggregate=AggregatorSpec(rule, byz_bound=4),
                      clip=ClipSpec(alpha=1.0) if clip else None,
                      bucket=BucketSpec(s=2) if bucket else None,
                      schedule=ScheduleSpec(backend="auto"))
    outs, grads = [], []
    for p in (plan, torch_shadow_plan(plan)):
        m = x.clone().requires_grad_(True)
        ops.reset_launch_counts()
        out = differentiable_aggregate(p)(m, mask=mask, key=order,
                                          radius=radius)
        torch.cuda.synchronize()
        launched = sum(ops.launch_counts().values())
        assert (launched > 0) == (p is plan)
        assert (type(out.grad_fn).__name__ == "KernelForwardBackward") == (
            p is plan)
        (gr,) = torch.autograd.grad((out * w).sum(), m)
        outs.append(out.detach())
        grads.append(gr)
    torch.testing.assert_close(outs[0], outs[1], **SUM_TOL)
    assert torch.equal(grads[0], grads[1])
    assert torch.isfinite(grads[0]).all() and grads[0].abs().sum() > 0


@pytest.mark.cuda
def test_cuda_kernel_path_refuses_a_tensor_that_records_a_gradient(card):
    """On the card a kernel-backed step given a grad-recording tensor
    raises (the kernels build no graph); under no_grad it runs."""
    from repro_torch.api import AggregatorSpec, ClipSpec, ServerPlan

    step = ServerPlan(aggregate=AggregatorSpec("cm"),
                      clip=ClipSpec(radius=1.0)).build()
    x = torch.randn(20, 40, device=card, requires_grad=True)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="no autograd graph"):
        step(x, radius=1.0)
    assert ops.launch_counts() == NO_LAUNCHES
    with torch.no_grad():
        step(x, radius=1.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["clip_bucket_select"] == 1


# ---------------------------------------------------------------------------
# the server's faults, snapshots and checkpoints, and the scoring endpoint
# ---------------------------------------------------------------------------

def _serve_plan(rule, radius=5.0):
    from repro_torch.api import (AggregatorSpec, ClipSpec, ScheduleSpec,
                                 ServerPlan)

    return ServerPlan(aggregate=AggregatorSpec(rule, byz_bound=2),
                      clip=ClipSpec(radius=radius) if radius else None,
                      schedule=ScheduleSpec(placement="naive",
                                            backend="auto"))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["krum", "centered_clip"])
def test_cuda_mid_round_snapshot_restores_bitwise(card, rule, tmp_path):
    """A card server parked mid-round, saved and restored into a fresh
    card server, closes the round bit for bit as the live one."""
    import numpy as np

    from repro_torch.serve import (AggregationServer, ServeConfig,
                                   restore_server, save_server)

    cfg = ServeConfig(n_slots=8, dim=300, cohort_size=6, chunk_size=3,
                      seed=4)
    rows = np.random.RandomState(1).randn(12, 300).astype(np.float32)
    live = AggregationServer(_serve_plan(rule), cfg, device=card)
    for slot in range(6):
        live.submit(slot, rows[slot])
    assert len(live.pump()) == 1
    for slot in (6, 7, 0, 1):
        live.submit(slot, rows[slot + 4])
    assert live.pump() == []
    save_server(live, str(tmp_path))
    clone = AggregationServer(_serve_plan(rule), cfg, device=card)
    assert restore_server(clone, str(tmp_path))[0] == 1
    for mine, theirs in zip(clone._builder.state(), live._builder.state()):
        assert mine.is_cuda and mine.data_ptr() != theirs.data_ptr()
        assert torch.equal(mine, theirs)
    for srv in (live, clone):
        srv.submit(2, rows[2] * 0.5)
        srv.submit(3, rows[3] * 0.5)
    a, b = live.pump(), clone.pump()
    assert len(a) == len(b) == 1 and not a[0].degraded
    np.testing.assert_array_equal(a[0].aggregate, b[0].aggregate)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_onto_the_card(card, tmp_path):
    from repro_torch import checkpoint

    g = torch.Generator(device=card).manual_seed(3)
    tree = {"x": torch.randn(5, 7, device=card, generator=g),
            "h": [torch.randn(9, device=card, generator=g).bfloat16()]}
    checkpoint.save(str(tmp_path), 2, tree)
    template = {"x": torch.zeros(5, 7, device=card),
                "h": [torch.zeros(9, device=card, dtype=torch.bfloat16)]}
    got = checkpoint.restore(str(tmp_path), 2, template)
    assert got["x"].is_cuda and got["h"][0].dtype == torch.bfloat16
    assert torch.equal(got["x"], tree["x"])
    assert torch.equal(got["h"][0].view(torch.int16),
                       tree["h"][0].view(torch.int16))


@pytest.mark.cuda
def test_cuda_injected_crash_degrades_and_kernels_still_count(card):
    import numpy as np

    from repro_torch.serve import (AggregationServer, FaultInjector,
                                   FaultPlan, ServeConfig)

    srv = AggregationServer(_serve_plan("krum"),
                            ServeConfig(n_slots=6, dim=64, cohort_size=4),
                            device=card)
    inj = FaultInjector(FaultPlan(executor_crash=1.0), srv)
    rows = np.random.RandomState(2).randn(4, 64).astype(np.float32)
    ops.reset_launch_counts()
    for slot in range(4):
        inj.submit(slot, rows[slot])
    closed = inj.pump()
    assert len(closed) == 1 and closed[0].degraded
    assert closed[0].fallback_reason == "executor_error:InjectedFault"
    assert srv.metrics.executor_faults == 1
    # the rows were folded into the Gram on the card; the close never ran
    assert ops.launch_counts() == dict(NO_LAUNCHES, cross_gram=1)


@pytest.mark.cuda
@pytest.mark.parametrize("rule,radius", [("krum", 5.0), ("cm", None)])
def test_cuda_scoring_step_matches_the_cpu(card, rule, radius):
    import numpy as np

    from repro_torch.launch.serve import make_scoring_step

    xs = np.random.RandomState(0).randn(3, 10, 200).astype(np.float32)
    xs[:, 8:] *= 100.0
    plan = _serve_plan(rule, radius)
    ops.reset_launch_counts()
    got = make_scoring_step(plan, card)(xs, key=2)
    counts = ops.launch_counts()
    want = make_scoring_step(plan, "cpu")(xs, key=2)
    for name, w in want.items():
        assert got[name].is_cuda
        torch.testing.assert_close(got[name].cpu(), w, **SUM_TOL)
    assert counts == (dict(NO_LAUNCHES, gram_matrix=3, select_row=3)
                      if rule == "krum"
                      else dict(NO_LAUNCHES, coordinate_median=3))


# ---------------------------------------------------------------------------
# the mesh arguments: factors= and reduce_fn, and plan.build(mesh)
# ---------------------------------------------------------------------------

def _double(t):
    return 2.0 * t


def _identity(t):
    return t


def _mesh_call(kind, xs, radius, mask, idx, factors, s, reduce_fn):
    gmk, krk = _gm_mods()[1], _krum_mod()
    cck = importlib.import_module("repro_torch.kernels.centered_clip")
    if kind in ("cm", "tm"):
        return ca.clip_then_aggregate(
            xs, radius, mask, idx, factors,
            trim_ratio=-1.0 if kind == "cm" else 0.1, bucket_s=s,
            reduce_fn=reduce_fn)
    if kind == "gm":
        return gmk.clip_then_geometric_median(xs, radius, mask, idx, factors,
                                              bucket_s=s, reduce_fn=reduce_fn)
    if kind == "cclip":
        return cck.clip_then_centered_clip(xs, radius, mask, idx, factors,
                                           tau=0.5, bucket_s=s,
                                           reduce_fn=reduce_fn)
    return krk.clip_then_krum(xs, radius, mask, idx, factors, byz_bound=1,
                              multi=kind == "multi_krum", bucket_s=s,
                              reduce_fn=reduce_fn)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cm", "tm", "gm", "cclip", "krum",
                                  "multi_krum"])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("reduce_fn", [None, _identity, _double],
                         ids=["none", "identity", "double"])
@pytest.mark.parametrize("with_factors", [False, True],
                         ids=["norms", "factors"])
def test_cuda_mesh_arguments_match_plain(card, kind, s, reduce_fn,
                                         with_factors):
    """Each on-path wrapper with ``factors=`` and with an identity and a
    doubling ``reduce_fn``, on the card against its plain version (the
    same call on CPU copies)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    n, d = 20, 5000
    xs = torch.randn(n, d, device=card, generator=g)
    mask = torch.rand(n, device=card, generator=g) > 0.3
    mask[0] = True
    idx = torch.randperm(n, device=card, generator=g) if s >= 2 else None
    factors = (0.2 + 0.8 * torch.rand(n, device=card, generator=g)
               if with_factors else None)
    radius = float(torch.linalg.vector_norm(xs, dim=1).median())
    got, norms = _mesh_call(kind, xs, radius, mask, idx, factors, s,
                            reduce_fn)
    cpu = [None if t is None else t.cpu() for t in (xs, mask, idx, factors)]
    want, wnorms = _mesh_call(kind, cpu[0], radius, cpu[1], cpu[2], cpu[3],
                              s, reduce_fn)
    tol = dict(rtol=0, atol=1e-5) if kind in ("gm", "cclip") else SUM_TOL
    torch.testing.assert_close(got.cpu(), want, **tol)
    assert (norms is None) == (wnorms is None) == with_factors
    if norms is not None:
        torch.testing.assert_close(norms.cpu(), wnorms, **SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rule,update,steps", [("gm", "gm_update", 8),
                                               ("cclip", "cclip_update", 5)])
@pytest.mark.parametrize("s", [1, 2])
def test_cuda_reduce_fn_takes_the_tiled_schedule(card, rule, update, steps,
                                                 s):
    """At a shape the resident kernel takes (n = 20, d = 40), any
    ``reduce_fn`` sends the call to the tiled kernels: 1 + steps updates,
    steps distance passes, one bucket-means pass under Bucketing."""
    xs = torch.randn(20, 40, device=card)
    idx = torch.randperm(20, device=card) if s >= 2 else None
    kind = "gm" if rule == "gm" else "cclip"
    for reduce_fn in (None, _identity):
        ops.reset_launch_counts()
        _mesh_call(kind, xs, 1.0, None, idx, None, s, reduce_fn)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if reduce_fn is None:
            assert counts == {"row_norms": 1, f"{rule}_resident": 1}
        else:
            want = {"row_norms": 1, "diff_row_ssq": steps,
                    update: steps + 1}
            if s >= 2:
                want["bucket_means"] = 1
            assert counts == want


@pytest.mark.cuda
def test_cuda_one_rank_nccl_mesh_runs_the_registry(card, tmp_path):
    """``plan.build(mesh)`` on a one-rank NCCL (1, 1) mesh, both
    placements, the whole registry clipped and unclipped, against the
    single-process plain path on CPU copies; every collective stays on
    the card (NCCL never takes gloo's host route)."""
    import os

    import torch.distributed as dist

    from repro_torch.api import (AggregatorSpec, BucketSpec, ScheduleSpec,
                                 ServerPlan)
    from repro_torch.api.mesh_exec import (collective_counts,
                                           naive_aggregate,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_debug_mesh

    g = torch.Generator(device="cuda").manual_seed(3)
    tree = {"w1": torch.randn(20, 784, 16, device=card, generator=g),
            "b1": torch.randn(20, 16, device=card, generator=g)}
    mask = torch.rand(20, device=card, generator=g) > 0.2
    perm = torch.randperm(20, device=card, generator=g)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp_path, "rdv"), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        reset_collective_counts()
        for agg in ("cm", "tm", "mean", "cclip", "rfa", "krum", "multi_krum",
                    "bucket_cm", "bucket_krum", "bucket_rfa"):
            rule, s = (agg[7:], 2) if agg.startswith("bucket_") else (agg, 0)
            for radius in (3.0, None):
                for placement in ("naive", "sharded"):
                    plan = ServerPlan(
                        aggregate=AggregatorSpec(rule, byz_bound=2),
                        bucket=BucketSpec(s=s) if s else None,
                        schedule=ScheduleSpec(placement=placement))
                    tree1 = (tree if placement == "naive"
                             else tree_map(lambda x: x[:1], tree))
                    m1 = mask if placement == "naive" else mask[:1]
                    k1 = perm if placement == "naive" else None
                    got = plan.build(mesh)(tree1, mask=m1, key=k1,
                                           radius=radius)
                    cpu = tree_map(lambda x: x.cpu(), tree1)
                    f = None
                    if radius is not None:
                        flat = torch.cat([x.reshape(x.shape[0], -1)
                                          for x in tree_leaves(cpu)], dim=1)
                        f = ca.clip_factor(
                            torch.linalg.vector_norm(flat, dim=1), radius)
                    want = naive_aggregate(
                        cpu, m1.cpu(), None if k1 is None else k1.cpu(),
                        agg=plan.build_aggregator(), factors=f)
                    for a, b in zip(tree_leaves(got), tree_leaves(want)):
                        assert a.is_cuda
                        torch.testing.assert_close(a.cpu(), b, rtol=1e-5,
                                                   atol=1e-5)
        routes = {c["route"] for c in collective_counts().values()}
        assert routes == {"device"}, collective_counts()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the model zoo: each smoke config on the card against the CPU
# ---------------------------------------------------------------------------

_ZOO = ("minitron_8b", "stablelm_12b", "mamba2_780m", "jamba_v01_52b",
        "hubert_xlarge", "deepseek_v3_671b", "llama32_vision_90b",
        "deepseek_7b", "yi_34b", "arctic_480b")
_ZOO_DECODABLE = ("minitron_8b", "yi_34b", "mamba2_780m", "jamba_v01_52b",
                  "deepseek_v3_671b", "llama32_vision_90b", "arctic_480b")


def _zoo_inputs(arch, dtype="float32", **overrides):
    """The smoke config (remat off), its params and a batch of 2 x 32,
    made on the CPU from seeds 0 and 1; the VLM's gates opened to 0.5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import init_params

    cfg = get_smoke_config(arch).replace(dtype=dtype, remat=False,
                                         **overrides)
    params = init_params(0, cfg, device="cpu")
    for pos, mixer in enumerate(cfg.mixer_pattern):
        if mixer == "cross":
            params["body"][pos]["mixer"]["gate"].fill_(0.5)
    return cfg, params, synthetic_batch(1, cfg, 2, 32, device="cpu")


def _zoo_to(tree, device):
    from repro_torch.core.tree_utils import tree_map

    return tree_map(lambda t: t.to(device), tree)


def _zoo_value_and_grad(params, cfg, batch):
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.models import apply_train

    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, aux = apply_train(tree_unflatten(treedef, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _zoo_close(got, want, rel):
    """max |got - want| within ``rel`` of max |want| (the leaf's scale)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert float((got - want).abs().max() if want.numel() else 0.0) \
        <= rel * max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _ZOO)
def test_cuda_smoke_model_matches_the_cpu(card, arch):
    """f32: loss and aux within rtol 1e-5, every gradient leaf and the
    prefill logits within 1e-4 of their max-abs, remat's gradients
    within 1e-6 of remat off's."""
    from repro_torch.models import apply_prefill

    cfg, params_cpu, batch_cpu = _zoo_inputs(arch)
    params, batch = _zoo_to(params_cpu, card), _zoo_to(batch_cpu, card)
    loss, aux, grads = _zoo_value_and_grad(params, cfg, batch)
    loss_cpu, aux_cpu, grads_cpu = _zoo_value_and_grad(params_cpu, cfg,
                                                       batch_cpu)
    assert float(loss) == pytest.approx(float(loss_cpu), rel=1e-5)
    for k in aux:
        assert float(aux[k]) == pytest.approx(float(aux_cpu[k]), rel=1e-5)
    for a, b in zip(grads, grads_cpu):
        assert a.is_cuda
        _zoo_close(a, b, 1e-4)
    _, _, remat = _zoo_value_and_grad(params, cfg.replace(remat=True), batch)
    for a, b in zip(remat, grads):
        _zoo_close(a, b, 1e-6)
    with torch.no_grad():
        _zoo_close(apply_prefill(params, cfg, batch),
                   apply_prefill(params_cpu, cfg, batch_cpu), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _ZOO_DECODABLE)
def test_cuda_smoke_decode_matches_prefill(card, arch):
    """12 decode steps from init_cache equal the prefill's last logits
    (capacity 8.0; atol 2e-3, rtol 2e-2, test_decode_matches_prefill's)."""
    from repro_torch.models import apply_decode, apply_prefill, init_cache

    cfg, params, batch = _zoo_inputs(arch, capacity_factor=8.0)
    params, batch = _zoo_to(params, card), _zoo_to(batch, card)
    cache = init_cache(cfg, 2, 12, device=card)
    with torch.no_grad():
        for t in range(12):
            step = {k: (v[:, t:t + 1] if k == "tokens" else v)
                    for k, v in batch.items()}
            logits, cache = apply_decode(params, cfg, step, cache, t)
        head = {k: (v[:, :12] if k == "tokens" else v)
                for k, v in batch.items()}
        want = apply_prefill(params, cfg, head)
    torch.testing.assert_close(logits, want, atol=2e-3, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _ZOO)
def test_cuda_smoke_model_bf16_step_is_finite(card, arch):
    cfg, params, batch = _zoo_inputs(arch, dtype="bfloat16")
    loss, _, grads = _zoo_value_and_grad(_zoo_to(params, card), cfg,
                                         _zoo_to(batch, card))
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    assert bool(torch.isfinite(loss)) and float(loss) != 0.0
    assert bool(torch.isfinite(norm)) and float(norm) > 0.0


# ---------------------------------------------------------------------------
# the mesh trainer and the decode launcher on the card against the CPU
# ---------------------------------------------------------------------------

def _trainer_run(device, init, steps):
    """4 steps of the (1, 1) trainer (the smoke minitron in f32, the
    default plan) on a tape (a full round, then three difference rounds)
    in a one-rank group of ``init``'s backend; returns the params and g
    leaves after every step, the launches and the collectives' routes."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (ByzTrainConfig, MeshTrainState,
                                          TrainTape, make_train_step,
                                          train_key, worker_grads)

    cfg, params, _ = _zoo_inputs("minitron_8b")
    params = _zoo_to(params, device)
    from repro_torch.data import synthetic_batch

    batches = [_zoo_to(synthetic_batch(k, cfg, 2, 32, device="cpu"), device)
               for k in range(steps + 1)]
    backend, path = init
    dist.init_process_group(backend, init_method="file://" + path, rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        g0 = tree_unflatten(tree_flatten(params)[1],
                            worker_grads(params, cfg, batches[0]))
        state = MeshTrainState(params, g0, train_key(0),
                               torch.zeros((), dtype=torch.int32))
        tape = TrainTape(c=np.array([True] + [False] * (steps - 1)),
                         sampled=np.ones((steps, 1), bool),
                         order=np.zeros((steps, 1), np.int64))
        step = make_train_step(cfg, mesh, ByzTrainConfig(gamma=0.1))
        ops.reset_launch_counts()
        reset_collective_counts()
        out = []
        for k in range(steps):
            state = step(state, batches[k + 1], tape)
            out.append([x.cpu() for x in tree_flatten(state.params)[0]
                        + tree_flatten(state.g)[0]])
        return (out, ops.launch_counts(),
                {c["route"] for c in collective_counts().values()})
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_one_rank_trainer_matches_the_cpu(card, tmp_path):
    """The trainer on a one-rank NCCL mesh launches rows 1-3 (the clip
    factors' sums, the clipped CM, the unclipped CM) and follows the CPU
    plain path on a gloo mesh within 1e-4 of each leaf's max-abs."""
    got, launches, routes = _trainer_run(card, ("nccl", str(tmp_path / "a")),
                                         4)
    want, _, _ = _trainer_run(torch.device("cpu"),
                              ("gloo", str(tmp_path / "b")), 4)
    for step_got, step_want in zip(got, want):
        for a, b in zip(step_got, step_want):
            _zoo_close(a, b, 1e-4)
    assert launches["coordinate_median"] > 0  # the full round
    assert launches["row_norms"] > 0 and launches["clip_bucket_select"] > 0
    assert routes == {"device"}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _ZOO_DECODABLE)
def test_cuda_serve_step_matches_the_cpu(card, arch):
    """``make_serve_step`` on the card against the CPU: the same greedy
    tokens (int32) and logits within 1e-4 of their max-abs over 6 steps,
    the cache updated in place."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.serve import decode_batch, make_serve_step
    from repro_torch.models import init_cache

    cfg, params, batch = _zoo_inputs(arch, capacity_factor=8.0)
    step = make_serve_step(cfg)
    caches = {dev: init_cache(cfg, 2, 6, device=dev) for dev in ("cpu", card)}
    gpu_params = _zoo_to(params, card)
    tok = batch["tokens"][:, :1]
    for t in range(6):
        want_tok, want, caches["cpu"] = step(params, decode_batch(cfg, tok),
                                             caches["cpu"], t)
        got_tok, got, cache = step(gpu_params,
                                   decode_batch(cfg, tok.to(card)),
                                   caches[card], t)
        assert got_tok.dtype == torch.int32
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
            tree_flatten(cache)[0], tree_flatten(caches[card])[0]))
        assert torch.equal(got_tok.cpu(), want_tok)
        _zoo_close(got, want, 1e-4)
        tok = want_tok[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("attack", ["bf", "sf", "lf", "alie", "ipm", "gauss"])
def test_cuda_tree_attack_stage_matches_the_cpu(card, attack):
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.scenarios import TreeAttackStage

    g = torch.Generator().manual_seed(4)
    tree = {"a": torch.randn(5, 6, 32, generator=g),
            "b": torch.randn(5, 17, generator=g).to(torch.bfloat16)}
    noise = [torch.randn(5, 192, generator=g), torch.randn(5, 17, generator=g)]
    good = torch.tensor([True, True, True, False, False])
    sampled = torch.tensor([True, False, True, True, True])
    stage = TreeAttackStage(attack)
    want = stage.corrupt_tree(tree, good_mask=good, sampled=sampled,
                              key=noise)
    got = stage.corrupt_tree(_zoo_to(tree, card), good_mask=good.to(card),
                             sampled=sampled.to(card), key=noise)
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert a.is_cuda and a.dtype == b.dtype
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)
