"""Fused server-side clip -> (Bucketing) -> robust aggregate.

The Byz-VR-MARINA-PP server step (Algorithm 1) re-clips every received
message at radius lambda and aggregates the clipped (n, d) matrix with a
masked coordinate median or trimmed mean, optionally over Bucketing's
bucket means.  Two kernels do it without writing the clipped matrix:

  pass 1  ``row_norms``: ``csrc/row_norms.cu`` writes per-row partial
          sums of squares over column chunks; the wrapper sums them
          (``row_ssq``) and takes the square root, and ``clip_factor``
          gives the n scalar factors min{1, lambda/||x_i||}.  Replaces ``_rownorm_kernel``
          (``src/repro/kernels/clip_aggregate.py``).
  pass 2  ``clip_bucket_select``: ``csrc/clip_aggregate.cu`` applies the
          factors in registers, gathers the rows in Bucketing order,
          takes the s-row mask-weighted means and the masked CM/TM over
          them.  Replaces ``_clip_agg_kernel`` and
          ``_clip_bucket_agg_kernel``.

``bucketed_coordinate_median`` is Bucketing(s) o CM with an explicit
permutation of the n_p padded slots (the reference draws it from a key):
the same selection template with unit factors, through its own C entry
point and launch counter.  Replaces ``_bucket_cm_kernel``
(``src/repro/kernels/bucketing.py``).

Both read the n*d matrix once and are bound by bytes on the H100; the
design notes are in the two sources.  ``use_clip=False`` skips pass 1
(the full-gradient rounds).

Rows are padded to a multiple of s with empty slots (mask 0, factor 1,
never read); an index of ``bucket_idx`` outside [0, n) is an empty slot
too.  An empty bucket holds 3.4e37 and is not counted.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it.
"""
from __future__ import annotations

import torch

from . import _build
from .coordinate_median import (
    BIG,
    _row_vector,
    check_matrix,
    nb_cap,
    select_plain,
)

__all__ = ["EPS", "LAUNCHES", "clip_factor", "row_ssq_plain", "row_ssq",
           "row_norms_plain", "row_norms",
           "clip_bucket_select_plain", "clip_bucket_select",
           "clip_then_aggregate", "bucketed_cm_plain",
           "bucketed_coordinate_median"]

EPS = 1e-30
LAUNCHES = {"row_norms": 0, "clip_bucket_select": 0, "bucketed_cm": 0}
# shared-memory words a block may use for its slot table (48 KiB less the
# kernel's static words): 4 per row slot plus 2 per bucket
_SMEM_WORDS = (48 * 1024 - 64) // 4


def clip_factor(norm, radius):
    """min{1, radius/norm}, with a factor of 1 at norm 0: the one
    definition of the clip factor, shared by the kernels and the plain
    path (``repro_torch.core.clipping``)."""
    return torch.clamp(radius / torch.clamp(norm, min=EPS), max=1.0)


def row_ssq_plain(xs: torch.Tensor) -> torch.Tensor:
    """Plain version of pass 1's sums: (n, d) -> (n,) f32 sum_j x_ij^2."""
    x32 = xs.float()
    return (x32 * x32).sum(dim=1)


def row_ssq(xs: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n,) f32 per-row sums of squares (pass 1 without the
    square root; a mesh adds them up over a worker's leaves and ranks)."""
    check_matrix(xs, "row_norms")
    if not xs.is_cuda:
        return row_ssq_plain(xs)
    n, d = xs.shape
    lib = _build.load("row_norms")
    chunks = -(-d // lib.row_ssq_chunk())
    partial = torch.empty((n, chunks), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        rc = lib.row_ssq_launch(xs.data_ptr(), partial.data_ptr(),
                                _build.dtype_code(xs), n, d, chunks,
                                _build.stream_ptr())
    _build.check(lib, "row_norms", rc)
    LAUNCHES["row_norms"] += 1
    return partial.sum(dim=1)


def _ssq_norms(ssq, reduce_fn):
    """sqrt of the per-row sums of squares, reduced first by ``reduce_fn``
    (an all-reduce over the mesh axes that hold the rest of each row)."""
    if reduce_fn is not None:
        ssq = reduce_fn(ssq)
    return torch.sqrt(ssq)


def row_norms_plain(xs: torch.Tensor, reduce_fn=None) -> torch.Tensor:
    """Plain version of pass 1: (n, d) -> (n,) f32 row norms."""
    return _ssq_norms(row_ssq_plain(xs), reduce_fn)


def row_norms(xs: torch.Tensor, reduce_fn=None) -> torch.Tensor:
    """(n, d) -> (n,) f32 l2 norms of the rows (pass 1).  ``reduce_fn``
    takes the summed (n,) sums of squares before the square root: on a
    mesh it all-reduces them, so that a block of each row's coordinates
    gives the norms of the whole rows."""
    return _ssq_norms(row_ssq(xs), reduce_fn)


def _slots(n: int, s: int) -> tuple:
    n_p = n + (-n) % s
    nb = n_p // s
    cap = nb_cap(nb)
    if 4 * n_p + 2 * nb > _SMEM_WORDS:
        raise ValueError(
            f"clip_bucket_select keeps 4 words per row slot in 48 KiB of "
            f"shared memory: at most {(_SMEM_WORDS - 2 * nb) // 4} slots, "
            f"got {n_p}"
        )
    return n_p, nb, cap


def clip_bucket_select_plain(xs, factors, mask, bucket_idx, s: int,
                             trim_ratio: float) -> torch.Tensor:
    """Plain version of pass 2: (n, d) -> (d,) f32, the kernel's
    arithmetic.  ``bucket_idx`` None means rows in order."""
    n, d = xs.shape
    n_p, _, _ = _slots(n, s)
    x = xs.float() * factors[:, None]
    if s == 1:  # a row is in when its mask is > 0.5
        ok = mask > 0.5
        vals = torch.where(ok[:, None], x, BIG)
        return select_plain(vals, ok.sum(), trim_ratio)
    dev = xs.device
    idx = (torch.arange(n, device=dev) if bucket_idx is None
           else bucket_idx.long())
    idx = torch.cat([idx, torch.full((n_p - n,), n, device=dev)])
    return _bucket_select_plain(x, mask, idx, s, trim_ratio)


def _bucket_select_plain(x, mask, slots, s: int, trim_ratio: float):
    """The bucketed selection over (n, d) f32 rows ``x`` in the slot order
    ``slots`` (n_p,), an index outside [0, n) an empty slot."""
    n, d = x.shape
    nb = slots.shape[0] // s
    # one zero row with mask 0 (row n) stands for every empty slot
    idx = torch.where((slots >= 0) & (slots < n), slots, n)
    x = torch.cat([x, x.new_zeros(1, d)])[idx].view(nb, s, d)
    m = torch.cat([mask, mask.new_zeros(1)])[idx].view(nb, s)
    # slot by slot, in the kernel's order, so that the sums match any s
    acc = x.new_zeros(nb, d)
    cnt_b = m.new_zeros(nb)
    for t in range(s):
        acc = acc + x[:, t] * m[:, t, None]
        cnt_b = cnt_b + m[:, t]
    means = acc / cnt_b.clamp(min=1.0)[:, None]
    ok = cnt_b > 0.5
    vals = torch.where(ok[:, None], means, BIG)
    return select_plain(vals, ok.sum(), trim_ratio)


def clip_bucket_select(xs, factors, mask, bucket_idx, s: int,
                       trim_ratio: float) -> torch.Tensor:
    """Pass 2: (n, d) -> (d,) f32.  ``factors``/``mask`` are (n,) f32,
    ``bucket_idx`` an (n,) row gather or None."""
    check_matrix(xs, "clip_bucket_select")
    n, d = xs.shape
    if s < 1:
        raise ValueError(f"bucket size must be >= 1, got {s}")
    dev = xs.device
    factors = _row_vector(factors, n, dev, torch.float32, "factors")
    mask = _row_vector(mask, n, dev, torch.float32, "mask")
    if bucket_idx is not None:
        bucket_idx = _row_vector(bucket_idx, n, dev, torch.int32, "bucket_idx")
    if not xs.is_cuda:
        return clip_bucket_select_plain(xs, factors, mask, bucket_idx, s,
                                        trim_ratio)
    n_p, nb, cap = _slots(n, s)
    if s == 1:
        mask = (mask > 0.5).float()
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = _build.load("clip_aggregate")
    with torch.cuda.device(dev):
        rc = lib.clip_bucket_select_launch(
            xs.data_ptr(), factors.data_ptr(), mask.data_ptr(),
            None if bucket_idx is None else bucket_idx.data_ptr(),
            out.data_ptr(), _build.dtype_code(xs), n, n_p, d, s, nb,
            float(trim_ratio), cap, _build.stream_ptr(),
        )
    _build.check(lib, "clip_bucket_select", rc)
    LAUNCHES["clip_bucket_select"] += 1
    return out


def clip_then_aggregate(xs, radius, mask=None, bucket_idx=None,
                        factors=None, *, trim_ratio: float = -1.0,
                        bucket_s: int = 1, use_clip: bool = True,
                        reduce_fn=None):
    """Agg({clip_radius(x_i)}_{i in mask}) over the rows of (n, d).

    ``trim_ratio < 0`` is the coordinate median, else the trimmed mean.
    With ``bucket_s >= 2`` the clipped rows are averaged in buckets of
    ``bucket_s`` in the ``bucket_idx`` row order (rows in order when
    None) before the selection.  ``use_clip=False`` skips the norm pass
    (factors 1).  ``radius`` is a float or a 0-d tensor.  ``factors``
    (n,) also skips the norm pass and scales the rows by the given
    factors: a mesh computes them from each worker's whole message, which
    one block of it cannot see.  ``reduce_fn`` reduces pass 1's sums of
    squares across coordinate shards (``row_norms``); the selection is
    coordinate-wise and needs none.

    Returns ``(aggregated (d,) in xs.dtype, row_norms (n,) f32 or None)``.
    """
    check_matrix(xs, "clip_then_aggregate")
    n = xs.shape[0]
    dev = xs.device
    mask = (torch.ones(n, dtype=torch.float32, device=dev) if mask is None
            else mask)
    norms = None
    if not use_clip:
        factors = torch.ones(n, dtype=torch.float32, device=dev)
    elif factors is None:
        norms = row_norms(xs, reduce_fn)
        factors = clip_factor(norms, radius)
    s = bucket_s if bucket_s >= 2 else 1
    out = clip_bucket_select(xs, factors, mask,
                             bucket_idx if s >= 2 else None, s, trim_ratio)
    return out.to(xs.dtype), norms


def _check_perm(xs, perm, mask, s: int):
    n = xs.shape[0]
    if s < 2:
        raise ValueError(f"Bucketing needs bucket size s >= 2, got {s}")
    n_p = n + (-n) % s
    dev = xs.device
    mask = (torch.ones(n, dtype=torch.float32, device=dev) if mask is None
            else _row_vector(mask, n, dev, torch.float32, "mask"))
    return _row_vector(perm, n_p, dev, torch.int32, "perm"), mask, n_p


def bucketed_cm_plain(xs, perm, mask, s: int) -> torch.Tensor:
    """Plain version of ``bucketed_coordinate_median``: (d,) f32."""
    return _bucket_select_plain(xs.float(), mask, perm.long(), s, -1.0)


def bucketed_coordinate_median(xs, perm, mask=None, *, s: int = 2):
    """(n, d) -> (d,) in ``xs.dtype``: Bucketing(s) o masked coordinate
    median.  ``perm`` is the bucket order, a permutation of the n_p = n +
    ((-n) mod s) padded slots (slots n..n_p-1 are empty rows of mask 0);
    ``mask`` (n,) weighs the rows.  Empty buckets are left out of the
    numpy-style median."""
    check_matrix(xs, "bucketed_coordinate_median")
    perm, mask, n_p = _check_perm(xs, perm, mask, s)
    if not xs.is_cuda:
        return bucketed_cm_plain(xs, perm, mask, s).to(xs.dtype)
    n, d = xs.shape
    _, nb, cap = _slots(n, s)
    out = torch.empty(d, dtype=torch.float32, device=xs.device)
    lib = _build.load("clip_aggregate")
    with torch.cuda.device(xs.device):
        rc = lib.bucketed_cm_launch(
            xs.data_ptr(), mask.data_ptr(), perm.data_ptr(), out.data_ptr(),
            _build.dtype_code(xs), n, n_p, d, s, nb, cap, _build.stream_ptr())
    _build.check(lib, "bucketed_cm", rc)
    LAUNCHES["bucketed_cm"] += 1
    return out.to(xs.dtype)
