"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; this
file imports neither jax nor the reference package, so it runs on a
machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the coordinate median selects values and averages two with
the same f32 operations as the plain version, so it matches exactly when
both get the same clip factors; sums (row norms, trimmed means) agree to
f32 rtol 1e-5.
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
    assert ops.launch_counts() == {"row_norms": 1, "clip_bucket_select": 1,
                                   "coordinate_median": 1}


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
    assert counts == {"row_norms": diff_rounds, "clip_bucket_select": 41,
                      "coordinate_median": 0}
    cpu = logistic_problem(0, device="cpu", **fig1_problem_kwargs())
    _, ref = ByzVRMarinaPP(cpu, fig1_marina_pp(True), device="cpu").run(40)
    torch.testing.assert_close(met["loss"], ref["loss"], rtol=1e-5, atol=0)
