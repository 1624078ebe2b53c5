"""Krum / multi-Krum through the (n, n) Gram matrix, and the four kernels
of its d-sized passes.

Krum (Blanchard et al., 2017) scores every worker by the summed squared
distance to its cnt-B-2 nearest sampled neighbours and returns the best
row (multi-Krum: the mean of the best-scored rows).  The only d-sized
work in the pairwise distances is the Gram matrix, because
``||x_i - x_j||^2 = ||x_i||^2 + ||x_j||^2 - 2 <x_i, x_j>``; clipping and
Bucketing are (n, n) algebra on it:

  clip at lambda   G_c = f f^T o G  with  f_i = min{1, lambda/||x_i||},
                   the row norms being sqrt(diag G);
  Bucketing        G_b = M G M^T    with  M the (nb, n) mask-weighted
                   bucket-mean operator over the ``bucket_idx`` row order.

The selection is exposed as a two-phase contract: the Gram of the rows
(additive over any coordinate partition), then ``krum_select_from_gram``
once, then ``apply_row_selection`` per block of coordinates.
``clip_then_krum`` is that pipeline for one matrix.  Distance masking,
neighbour counting and tie-breaking are the torch ops below, shared by
every backend, so exact ties (duplicate rows, symmetric mutual nearest
neighbours: ``g_eff`` is kept exactly symmetric) resolve the same way
everywhere; ``argsort`` is stable and ``argmin`` takes the first minimum,
as in the reference.  The (n, n) products are written as sums of
elementwise products, so no TF32 setting can touch them.

The four kernels are in ``csrc/krum.cu``, each beside its plain PyTorch
version here:

  ``gram_matrix``       G = X X^T in f32; replaces ``_gram_kernel``.
  ``cross_gram``        A B^T, summed exactly as the Gram, so
                        ``cross_gram(x, x)`` equals ``gram_matrix(x)`` bit
                        for bit and both are exactly symmetric; replaces
                        ``_cross_gram_kernel``.
  ``weighted_row_sum``  sum_i w_i x_i, a zero weight adding exactly 0;
                        replaces ``_row_combine_kernel``.
  ``select_row``        x[winner] * scale, streaming only that row, with
                        the index and the scale read on the device; replaces
                        ``_select_row_kernel``.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.  The Gram kernels take at most
``GRAM_MAX_N`` rows, on either device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .centered_clip import pad_bucket_aux
from .clip_aggregate import clip_factor
from .coordinate_median import _row_vector, check_matrix

__all__ = ["LAUNCHES", "GRAM_MAX_N", "RowSelection", "gram_sub_coords",
           "gram_rounding_depth", "gram_matrix_plain", "gram_matrix",
           "cross_gram_plain",
           "cross_gram", "weighted_row_sum_plain", "weighted_row_sum",
           "select_row_plain", "select_row", "masked_pairwise_d2",
           "krum_scores", "multi_krum_selection", "selection_is_onehot",
           "krum_select_from_gram", "apply_row_selection_plain",
           "apply_row_selection", "clip_then_krum_plain", "clip_then_krum",
           "krum", "multi_krum"]

F32 = torch.float32
_BIG = 3.4e37
GRAM_MAX_N = 128
# the Gram kernels' cut (krum.cu): runs of 16 coordinates, about 1024
# sub-slices of a small d
GRAM_RUN, GRAM_TARGET_SLICES = 16, 1024
LAUNCHES = {"gram_matrix": 0, "cross_gram": 0, "weighted_row_sum": 0,
            "select_row": 0}
# the plain Gram sums (n, n, chunk) products of at most this many floats
_PLAIN_FLOATS = 1 << 20


def gram_sub_coords(n: int, d: int) -> int:
    """Coordinates of one sub-slice of the Gram kernels at (n, d), runs of
    ``GRAM_RUN`` dealt round-robin (the kernel's ``gram_sub_coords``; its
    launch refuses another count): a whole number of runs, at least one, at
    most 32 * ceil8(n) (the partial sums stay within 1/32 of the input),
    and fewer when d is small, so that about ``GRAM_TARGET_SLICES``
    sub-slices spread over the card."""
    cap = 32 * (-(-n // 8) * 8)
    want = GRAM_RUN * -(-d // (GRAM_RUN * GRAM_TARGET_SLICES))
    return min(cap, want)


def gram_rounding_depth(n: int, d: int) -> int:
    """The most roundings one product of a Gram entry passes through in
    the kernels' sum at (n, d): the sub-slice's fused multiply-adds, one a
    coordinate in order, the strided adds of the second pass (256
    threads), its five warp shuffles and its eight warps added in order."""
    sub = gram_sub_coords(n, d)
    slices = -(-d // sub)
    return sub + -(-slices // 256) + 5 + 8


def _check_gram(xs: torch.Tensor, what: str) -> None:
    check_matrix(xs, what)
    if xs.shape[0] > GRAM_MAX_N:
        raise ValueError(f"{what}: the Gram kernels take at most "
                         f"{GRAM_MAX_N} rows, got {xs.shape[0]}")


# ---------------------------------------------------------------------------
# the Gram kernels
# ---------------------------------------------------------------------------

def cross_gram_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, d), (n, d) -> (n, n) f32 A B^T as a fixed-order
    reduction (products summed over coordinate chunks whose width depends
    on n only, the chunks added in order), never a BLAS product, so that
    ``gram_matrix_plain(x)`` is exactly symmetric on the CPU."""
    n, d = a.shape
    a32, b32 = a.float(), b.float()
    chunk = 1
    while 2 * chunk * n * n <= _PLAIN_FLOATS:
        chunk *= 2
    out = torch.zeros(n, n, dtype=F32, device=a.device)
    for k0 in range(0, d, chunk):
        out = out + (a32[:, None, k0:k0 + chunk]
                     * b32[None, :, k0:k0 + chunk]).sum(dim=-1)
    return out


def gram_matrix_plain(xs: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, d) -> (n, n) f32 X X^T."""
    return cross_gram_plain(xs, xs)


def _launch_gram(a, b, sym: bool, what: str) -> torch.Tensor:
    n, d = a.shape
    slices = -(-d // gram_sub_coords(n, d))
    partial = torch.empty(n * n * slices, dtype=F32, device=a.device)
    out = torch.empty(n, n, dtype=F32, device=a.device)
    lib = _build.load("krum")
    with torch.cuda.device(a.device):
        rc = lib.krum_gram_launch(
            a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(),
            _build.dtype_code(a), n, d, slices, int(sym), _build.stream_ptr())
    _build.check(lib, what, rc)
    LAUNCHES[what] += 1
    return out


def gram_matrix(xs: torch.Tensor) -> torch.Tensor:
    """(n, d) f32/bf16 -> (n, n) f32 Gram matrix, exactly symmetric."""
    _check_gram(xs, "gram_matrix")
    if not xs.is_cuda:
        return gram_matrix_plain(xs)
    return _launch_gram(xs, xs, True, "gram_matrix")


def cross_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d), (n, d) -> (n, n) f32 A B^T, every entry summed in the
    Gram's order: ``cross_gram(x, x)`` is ``gram_matrix(x)`` bit for bit."""
    _check_gram(a, "cross_gram")
    check_matrix(b, "cross_gram")
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(
            f"cross_gram: operands differ: {tuple(a.shape)} {a.dtype} "
            f"{a.device} vs {tuple(b.shape)} {b.dtype} {b.device}")
    if not a.is_cuda:
        return cross_gram_plain(a, b)
    return _launch_gram(a, b, False, "cross_gram")


# ---------------------------------------------------------------------------
# the apply kernels
# ---------------------------------------------------------------------------

def weighted_row_sum_plain(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, d), (n,) -> (d,) f32 sum_i w_i x_i with the rows
    added in order, as the kernel adds them, and a row of weight 0 adding
    exactly 0 (never 0 * inf)."""
    w = w.float()
    acc = torch.zeros(xs.shape[1], dtype=F32, device=xs.device)
    for i in range(xs.shape[0]):
        acc = acc + torch.where(w[i] != 0, xs[i].float() * w[i], 0.0)
    return acc


def weighted_row_sum(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, d) rows, (n,) weights on the rows' device -> (d,) f32; the
    weights are read on the device."""
    check_matrix(xs, "weighted_row_sum")
    n, d = xs.shape
    w = _row_vector(w, n, xs.device, F32, "w")
    if not xs.is_cuda:
        return weighted_row_sum_plain(xs, w)
    out = torch.empty(d, dtype=F32, device=xs.device)
    lib = _build.load("krum")
    with torch.cuda.device(xs.device):
        rc = lib.weighted_row_sum_launch(
            xs.data_ptr(), w.data_ptr(), out.data_ptr(),
            _build.dtype_code(xs), n, d, _build.stream_ptr())
    _build.check(lib, "weighted_row_sum", rc)
    LAUNCHES["weighted_row_sum"] += 1
    return out


def _row_scalars(xs, winner, scale):
    if winner.shape != () or scale.shape != ():
        raise ValueError("select_row: winner and scale must be 0-d tensors")
    if winner.device != xs.device or scale.device != xs.device:
        raise ValueError(f"select_row: winner and scale must lie on "
                         f"{xs.device}")
    if winner.is_floating_point():
        raise TypeError("select_row: winner must be an integer tensor")
    return winner.to(torch.int32), scale.to(F32)


def select_row_plain(xs: torch.Tensor, winner: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Plain version: (d,) f32 x[clamp(winner, 0, n-1)] * scale, exactly 0
    when scale is 0."""
    row = winner.long().clamp(0, xs.shape[0] - 1).view(1)
    x = xs.index_select(0, row)[0].float()
    return torch.where(scale != 0, x * scale, 0.0)


def select_row(xs: torch.Tensor, winner: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """(n, d) rows, 0-d integer ``winner`` and 0-d ``scale`` on the rows'
    device -> (d,) f32 x[winner] * scale, reading only that row.  The
    index is clamped to [0, n-1]; both scalars are read on the device."""
    check_matrix(xs, "select_row")
    winner, scale = _row_scalars(xs, winner, scale)
    if not xs.is_cuda:
        return select_row_plain(xs, winner, scale)
    n, d = xs.shape
    out = torch.empty(d, dtype=F32, device=xs.device)
    lib = _build.load("krum")
    with torch.cuda.device(xs.device):
        rc = lib.select_row_launch(
            xs.data_ptr(), winner.data_ptr(), scale.data_ptr(),
            out.data_ptr(), _build.dtype_code(xs), n, d,
            _build.stream_ptr())
    _build.check(lib, "select_row", rc)
    LAUNCHES["select_row"] += 1
    return out


# ---------------------------------------------------------------------------
# the selection as (n, n) algebra
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for the small (n, n) algebra, as a sum of products."""
    return (a[:, :, None] * b[None, :, :]).sum(dim=1)


def masked_pairwise_d2(gram, sq, mask_b):
    """(n, n) squared distances from a Gram matrix; invalid pairs (either
    end unsampled, or the diagonal) pushed to +3.4e37."""
    n = gram.shape[0]
    d2 = (sq[:, None] + sq[None, :] - 2.0 * gram).clamp(min=0.0)
    eye = torch.eye(n, dtype=torch.bool, device=gram.device)
    pair_ok = mask_b[:, None] & mask_b[None, :] & ~eye
    return torch.where(pair_ok, d2, _BIG)


def krum_scores(d2, mask_b, byz_bound: Optional[int]):
    """Krum score per row: the sum of its cnt-B-2 smallest valid distances
    (at least 1); unsampled rows score +3.4e37.  The neighbour count
    stays on the device."""
    n = d2.shape[0]
    cnt = mask_b.sum()
    b = byz_bound if byz_bound is not None else 0
    d2_sorted = torch.sort(d2, dim=1).values
    csum = torch.cumsum(torch.where(d2_sorted >= _BIG, 0.0, d2_sorted), dim=1)
    # jnp.clip(cnt - b - 2, 1, n - 1), then jnp's wrap of index -1 at n = 1
    k_nb = torch.minimum(torch.clamp(cnt - b - 2, min=1),
                         torch.full_like(cnt, n - 1))
    col = torch.remainder(k_nb - 1, n).view(1, 1).expand(n, 1)
    return torch.where(mask_b, csum.gather(1, col)[:, 0], _BIG)


def multi_krum_selection(scores, mask_b, byz_bound: Optional[int],
                         m_select: int):
    """Boolean selection of the best-scored sampled rows; the size defaults
    to cnt - B - 2 (Damaskinos et al., 2019), clipped to [1, n]; ties keep
    the row order (a stable sort, as ``jnp.argsort``)."""
    n = scores.shape[0]
    cnt = mask_b.sum()
    b = byz_bound if byz_bound is not None else 0
    want = torch.full_like(cnt, m_select) if m_select else cnt - b - 2
    m_sel = torch.clamp(want, 1, n)
    order = torch.argsort(scores, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=scores.device)
    return (rank < m_sel) & mask_b


class RowSelection(NamedTuple):
    """The outcome of a Krum/multi-Krum selection, applied to any matrix
    that shares its rows.  ``weights``/``denom``: the row combination
    sum_i w_i x_i / denom (clip factors and bucket means folded in);
    ``winner``/``scale``: the argmin row and its clip factor, the same
    information for plain Krum, which ``select_row`` streams alone."""

    weights: torch.Tensor  # (n,) f32
    denom: torch.Tensor  # () f32
    winner: torch.Tensor  # () int32
    scale: torch.Tensor  # () f32


def _bucket_operator(bucket_idx, mask_f, factors, n_p: int, s: int):
    """The (nb, n_p) mask-weighted bucket-mean matrix M (clip factors
    folded in) and the per-bucket sampled counts."""
    nb = n_p // s
    idx_r = bucket_idx.long().view(nb, s)
    memb = F.one_hot(idx_r, n_p).float() * mask_f[idx_r][:, :, None]
    e = memb.sum(dim=1)  # (nb, n_p): membership * mask
    cnt = e.sum(dim=1)
    m_op = e * factors[None, :] / cnt.clamp(min=1.0)[:, None]
    return m_op, cnt


def selection_is_onehot(multi: bool, bucket_s: int) -> bool:
    """Whether the selection's row combination is one-hot (plain,
    unbucketed Krum): the one predicate that sends the apply pass to
    ``select_row``."""
    return (not multi) and bucket_s < 2


def krum_select_from_gram(gram, mask=None, radius=None, factors=None,
                          bucket_idx=None, *, byz_bound: Optional[int] = None,
                          m_select: int = 0, multi: bool = False,
                          bucket_s: int = 1, use_clip: bool = True):
    """Krum/multi-Krum selection from the (n, n) Gram of the messages (or
    the sum of Grams over any coordinate partition).  Clip factors come
    from ``factors`` if given, else from diag(gram) at ``radius``
    (``use_clip=False``: none); Bucketing is the M G M^T product over
    ``bucket_idx``.  Returns ``(RowSelection, row_norms (n,) or None)``;
    nothing is read back to the host."""
    n = gram.shape[0]
    dev = gram.device
    # a Gram summed across ranks may round G_ij and G_ji differently; its
    # symmetric part restores the exact ties of mutual nearest neighbours
    # (and is the Gram itself, bit for bit, when that is symmetric)
    gram = 0.5 * (gram + gram.T)
    mask_b = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
              else mask.to(device=dev, dtype=torch.bool))
    mask_f = mask_b.float()
    norms = None
    if use_clip:
        if factors is None:
            norms = torch.sqrt(torch.diagonal(gram).clamp(min=0.0))
            factors = clip_factor(norms, radius).float()
        else:
            factors = factors.float()
    else:
        factors = torch.ones(n, dtype=F32, device=dev)

    if bucket_s >= 2:
        mask_p, factors_p, idx = pad_bucket_aux(mask_f, factors, bucket_idx,
                                                n, bucket_s)
        n_p = mask_p.shape[0]
        if n_p > n:
            gram = F.pad(gram, (0, n_p - n, 0, n_p - n))
        m_op, cnt = _bucket_operator(idx, mask_p, factors_p, n_p, bucket_s)
        g_eff = _mm(_mm(m_op, gram), m_op.T)
        # the triple product is not exactly symmetric; argmin-first ties
        # between mutual nearest neighbours need d2[i, j] == d2[j, i]
        g_eff = 0.5 * (g_eff + g_eff.T)
        mask_eff = cnt > 0.5
    else:
        g_eff = gram * (factors[:, None] * factors[None, :])
        mask_eff = mask_b

    d2 = masked_pairwise_d2(g_eff, torch.diagonal(g_eff), mask_eff)
    scores = krum_scores(d2, mask_eff, byz_bound)
    one = torch.ones((), dtype=F32, device=dev)
    if not multi:
        winner = torch.argmin(scores)
        scale = factors.index_select(0, winner.clamp(max=n - 1).view(1))[0]
        if bucket_s < 2:
            # one-hot * factor: zero terms are exact, so the weighted sum
            # reproduces the row take bit for bit
            w_row = (torch.arange(n, device=dev) == winner).float() * scale
        else:
            # the winning bucket mean is a row of the bucket operator
            w_row = m_op.index_select(0, winner.view(1))[0, :n]
        return RowSelection(w_row, one, winner.to(torch.int32), scale), norms
    w_sel = multi_krum_selection(scores, mask_eff, byz_bound, m_select).float()
    denom = w_sel.sum().clamp(min=1.0)
    if bucket_s < 2:
        w_row = w_sel * factors
    else:
        # the selected bucket means as one combination of the raw rows
        w_row = (w_sel[:, None] * m_op).sum(dim=0)[:n]
    return RowSelection(w_row, denom, torch.argmin(scores).to(torch.int32),
                        one), norms


def _apply(xs, selection: RowSelection, onehot: bool, select_fn, wsum_fn):
    if onehot:
        out = select_fn(xs, selection.winner, selection.scale)
    else:
        out = wsum_fn(xs, selection.weights)
    return (out / selection.denom).to(xs.dtype)


def apply_row_selection_plain(xs, selection: RowSelection, *,
                              onehot: bool = False):
    """Plain version of ``apply_row_selection``."""
    return _apply(xs, selection, onehot, select_row_plain,
                  weighted_row_sum_plain)


def apply_row_selection(xs, selection: RowSelection, *, onehot: bool = False):
    """Apply a RowSelection to (n, d) rows: ``weighted_row_sum``, or for a
    one-hot selection (``selection_is_onehot``) ``select_row``, which reads
    only the winner row; then the division by ``denom``."""
    return _apply(xs, selection, onehot, select_row, weighted_row_sum)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _clip_then_krum(xs, radius, mask, bucket_idx, factors, gram_fn,
                    apply_fn, *, byz_bound, m_select, multi, bucket_s,
                    use_clip, reduce_fn):
    gram = gram_fn(xs)
    if reduce_fn is not None:
        gram = reduce_fn(gram)
    selection, norms = krum_select_from_gram(
        gram, mask, radius, factors, bucket_idx, byz_bound=byz_bound,
        m_select=m_select, multi=multi, bucket_s=bucket_s, use_clip=use_clip)
    out = apply_fn(xs, selection,
                   onehot=selection_is_onehot(multi, bucket_s))
    return out, norms


def clip_then_krum_plain(xs, radius, mask=None, bucket_idx=None,
                         factors=None, *, byz_bound: Optional[int] = None,
                         m_select: int = 0, multi: bool = False,
                         bucket_s: int = 1, use_clip: bool = True,
                         reduce_fn=None):
    """Plain version of ``clip_then_krum`` on any device."""
    return _clip_then_krum(xs, radius, mask, bucket_idx, factors,
                           gram_matrix_plain, apply_row_selection_plain,
                           byz_bound=byz_bound, m_select=m_select,
                           multi=multi, bucket_s=bucket_s, use_clip=use_clip,
                           reduce_fn=reduce_fn)


def clip_then_krum(xs, radius, mask=None, bucket_idx=None, factors=None, *,
                   byz_bound: Optional[int] = None, m_select: int = 0,
                   multi: bool = False, bucket_s: int = 1,
                   use_clip: bool = True, reduce_fn=None):
    """Krum/multi-Krum over per-row clipped messages: one Gram pass, the
    clip factors (from diag G, or ``factors`` when given) and Bucketing as
    (n, n) algebra, one apply pass.  ``reduce_fn`` sums the (n, n) Gram
    across coordinate shards before the selection, so that each rank's
    block of the rows selects as the whole rows would.  Returns
    ``(aggregated (d,) in xs.dtype, row_norms (n,) or None)``;
    ``use_clip=False`` aggregates the rows as they are."""
    return _clip_then_krum(xs, radius, mask, bucket_idx, factors,
                           gram_matrix, apply_row_selection,
                           byz_bound=byz_bound, m_select=m_select,
                           multi=multi, bucket_s=bucket_s, use_clip=use_clip,
                           reduce_fn=reduce_fn)


def krum(xs, mask=None, *, byz_bound: Optional[int] = None):
    """(n, d) -> (d,) plain (unclipped) Krum."""
    out, _ = clip_then_krum(xs, 0.0, mask, byz_bound=byz_bound,
                            use_clip=False)
    return out


def multi_krum(xs, mask=None, *, byz_bound: Optional[int] = None,
               m_select: int = 0):
    """(n, d) -> (d,) multi-Krum: the mean of the best-scored rows."""
    out, _ = clip_then_krum(xs, 0.0, mask, byz_bound=byz_bound,
                            m_select=m_select, multi=True, use_clip=False)
    return out
