"""Plain PyTorch oracles of the kernels, written from the definitions
(sort, gather, pad, the Weiszfeld and CenteredClip fixed points, explicit
pairwise distances for Krum) and independent of the kernels' own plain
versions.
The tests sweep both against these and against ``repro.kernels.ref``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
_BIG = 3.4e37


def _mask_or_all(xs, mask):
    if mask is None:
        return torch.ones(xs.shape[0], dtype=torch.bool, device=xs.device)
    return mask.bool()


def coordinate_median_ref(xs, mask=None):
    """xs: (n, d) -> (d,) coordinate-wise median over rows with mask[i]."""
    mask = _mask_or_all(xs, mask)
    vals = torch.where(mask[:, None], xs.to(F32), _BIG)
    s = torch.sort(vals, dim=0).values
    cnt = int(mask.sum())
    lo = s[(cnt - 1) // 2]  # cnt = 0 reads the last row, as jnp.take does
    hi = s[cnt // 2]
    return (0.5 * (lo + hi)).to(xs.dtype)


def trimmed_mean_ref(xs, mask=None, trim_ratio=0.1):
    mask = _mask_or_all(xs, mask)
    n = xs.shape[0]
    vals = torch.where(mask[:, None], xs.to(F32), _BIG)
    s = torch.sort(vals, dim=0).values
    cnt = torch.tensor(int(mask.sum()))
    t = torch.minimum(torch.ceil(torch.tensor(trim_ratio, dtype=F32) * cnt)
                      .to(torch.int64), torch.div(cnt - 1, 2,
                                                  rounding_mode="floor"))
    idx = torch.arange(n)[:, None].to(xs.device)
    keep = (idx >= t) & (idx < cnt - t)
    denom = torch.clamp(cnt - 2 * t, min=1).to(F32)
    return (torch.where(keep, s, 0.0).sum(dim=0) / denom).to(xs.dtype)


def clipped_diff_ref(g_new, g_old, radius, keep_mask, scale):
    """Fused gradient difference -> RandK mask -> clip:
    d = (g_new - g_old) * keep_mask * scale, out = min(1, radius/||d||) d.
    Returns (clipped in g_new's dtype, norm)."""
    d = (g_new.to(F32) - g_old.to(F32)) * keep_mask.to(F32) * scale
    norm = torch.sqrt((d * d).sum())
    factor = torch.clamp(radius / torch.clamp(norm, min=1e-30), max=1.0)
    return (d * factor).to(g_new.dtype), norm


def centered_clip_ref(xs, tau, iters, mask=None):
    """CenteredClip fixed point: v <- v + mean_i clip_tau(x_i - v) over the
    masked rows, from the masked mean."""
    m = _mask_or_all(xs, mask).to(F32)
    x32 = xs.to(F32)
    denom = torch.clamp(m.sum(), min=1.0)
    v = (x32 * m[:, None]).sum(dim=0) / denom
    for _ in range(iters):
        diff = x32 - v[None]
        nrm = torch.sqrt((diff * diff).sum(dim=1) + 1e-30)
        scale = torch.clamp(tau / nrm, max=1.0)
        v = v + (diff * (scale * m)[:, None]).sum(dim=0) / denom
    return v.to(xs.dtype)


def _clip_rows_ref(xs, radius, mask):
    """Shared oracle front half: per-row clip -> (clipped, norms)."""
    x32 = xs.to(F32)
    norms = torch.sqrt((x32 * x32).sum(dim=1))
    factors = torch.clamp(radius / torch.clamp(norms, min=1e-30), max=1.0)
    return (x32 * factors[:, None]).to(xs.dtype), norms


def _bucket_means_ref(vals, mask, bucket_idx, s):
    """Explicit-order mask-weighted bucket means (empty buckets masked
    out).  Returns (means, bucket_mask)."""
    n = vals.shape[0]
    if bucket_idx is None:
        bucket_idx = torch.arange(n, device=vals.device)
    m = mask.to(F32)
    xp = vals.to(F32)[bucket_idx.long()]
    mp = m[bucket_idx.long()]
    pad = (-n) % s
    if pad:
        xp = F.pad(xp, (0, 0, 0, pad))
        mp = F.pad(mp, (0, pad))
    nb = xp.shape[0] // s
    xb = xp.view(nb, s, -1)
    mb = mp.view(nb, s, 1)
    cnt = mb.sum(dim=1)
    means = (xb * mb).sum(dim=1) / torch.clamp(cnt, min=1.0)
    return means.to(vals.dtype), cnt[:, 0] > 0.5


def _clip_bucket_then_ref(inner, xs, radius, mask, bucket_idx, bucket_s):
    """clip rows -> optional Bucketing -> ``inner(vals, mask)``."""
    if mask is None:
        mask = torch.ones(xs.shape[0], dtype=torch.bool, device=xs.device)
    clipped, norms = _clip_rows_ref(xs, radius, mask)
    if bucket_s < 2:
        return inner(clipped, mask), norms
    means, bucket_ok = _bucket_means_ref(clipped, mask, bucket_idx, bucket_s)
    return inner(means, bucket_ok), norms


def clip_then_aggregate_ref(xs, radius, mask=None, bucket_idx=None, *,
                            trim_ratio=-1.0, bucket_s=1):
    """Oracle of the fused clip -> (Bucketing) -> CM/TM kernels.
    Returns (aggregated (d,), row_norms (n,))."""
    def inner(vals, m):
        if trim_ratio < 0:
            return coordinate_median_ref(vals, m)
        return trimmed_mean_ref(vals, m, trim_ratio=trim_ratio)

    return _clip_bucket_then_ref(inner, xs, radius, mask, bucket_idx,
                                 bucket_s)


def geometric_median_ref(xs, iters=8, eps=1e-8, mask=None):
    """Smoothed Weiszfeld fixed point: eps inside the sqrt, an eps-guarded
    weight sum, z0 = the masked mean sum x*m / max(sum m, 1)."""
    mask = _mask_or_all(xs, mask)
    m = mask.to(F32)
    x32 = xs.to(F32)
    z = (x32 * m[:, None]).sum(dim=0) / torch.clamp(m.sum(), min=1.0)
    for _ in range(iters):
        dist = torch.sqrt(((x32 - z[None]) ** 2).sum(dim=1) + eps)
        w = m / dist
        z = (x32 * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=eps)
    return z.to(xs.dtype)


def clip_then_geometric_median_ref(xs, radius, mask=None, bucket_idx=None, *,
                                   iters=8, eps=1e-8, bucket_s=1):
    """Oracle of the fused clip -> (Bucketing) -> Weiszfeld GM kernels.
    Returns (aggregated (d,), row_norms (n,))."""
    return _clip_bucket_then_ref(
        lambda vals, m: geometric_median_ref(vals, iters, eps, mask=m),
        xs, radius, mask, bucket_idx, bucket_s)


def _krum_scores_ref(xs, mask, byz_bound):
    """Krum scores from EXPLICIT pairwise distances, independent of the
    Gram algebra and the selection helpers of the kernels.  Returns
    (scores, bool mask)."""
    n = xs.shape[0]
    m = _mask_or_all(xs, mask)
    x32 = xs.to(F32)
    d2 = ((x32[:, None, :] - x32[None, :, :]) ** 2).sum(dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=xs.device)
    d2 = torch.where(m[:, None] & m[None, :] & ~eye, d2, _BIG)
    cnt = int(m.sum())
    b = byz_bound if byz_bound is not None else 0
    d2_sorted = torch.sort(d2, dim=1).values
    csum = torch.cumsum(torch.where(d2_sorted >= _BIG, 0.0, d2_sorted), dim=1)
    k_nb = min(max(cnt - b - 2, 1), n - 1)
    return torch.where(m, csum[:, k_nb - 1], _BIG), m


def krum_ref(xs, mask=None, byz_bound=None):
    """Krum (Blanchard et al., 2017): the row minimizing the summed squared
    distance to its cnt-B-2 nearest sampled neighbours."""
    scores, _ = _krum_scores_ref(xs, mask, byz_bound)
    return xs[int(torch.argmin(scores))]


def multi_krum_ref(xs, mask=None, byz_bound=None, m_select=0):
    """Multi-Krum: the mean of the best-Krum-scored sampled rows."""
    n = xs.shape[0]
    scores, m = _krum_scores_ref(xs, mask, byz_bound)
    b = byz_bound if byz_bound is not None else 0
    m_sel = min(max(m_select if m_select else int(m.sum()) - b - 2, 1), n)
    rank = torch.empty(n, dtype=torch.long)
    rank[torch.argsort(scores, stable=True)] = torch.arange(n)
    w = ((rank.to(xs.device) < m_sel) & m).to(F32)
    return ((xs.to(F32) * w[:, None]).sum(dim=0)
            / torch.clamp(w.sum(), min=1.0)).to(xs.dtype)


def clip_then_krum_ref(xs, radius, mask=None, bucket_idx=None, *,
                       byz_bound=None, m_select=0, multi=False, bucket_s=1):
    """Oracle of clip -> (Bucketing) -> Krum/multi-Krum over explicit
    bucket means.  Returns (aggregated (d,), row_norms (n,))."""

    def inner(vals, m):
        if multi:
            return multi_krum_ref(vals, m, byz_bound, m_select)
        return krum_ref(vals, m, byz_bound)

    return _clip_bucket_then_ref(inner, xs, radius, mask, bucket_idx,
                                 bucket_s)


def clip_then_centered_clip_ref(xs, radius, mask=None, bucket_idx=None, *,
                                tau=10.0, iters=5, bucket_s=1):
    """Oracle of the fused clip -> (Bucketing) -> CenteredClip kernels.
    Returns (aggregated (d,), row_norms (n,))."""
    return _clip_bucket_then_ref(
        lambda vals, m: centered_clip_ref(vals, tau, iters, mask=m),
        xs, radius, mask, bucket_idx, bucket_s)


def bucketed_cm_ref(xs, perm, mask=None, s=2):
    """Bucketing(s) o CM with an explicit permutation of the padded rows:
    mask-weighted bucket means, empty buckets left out of the median."""
    n = xs.shape[0]
    m = (torch.ones(n, dtype=F32, device=xs.device) if mask is None
         else mask.to(F32))
    pad = (-n) % s
    xp = F.pad(xs.to(F32), (0, 0, 0, pad))[perm.long()]
    mp = F.pad(m, (0, pad))[perm.long()]
    nb = xp.shape[0] // s
    xb = xp.view(nb, s, -1)
    mb = mp.view(nb, s, 1)
    cnt = mb.sum(dim=1)
    means = (xb * mb).sum(dim=1) / torch.clamp(cnt, min=1.0)
    return coordinate_median_ref(means.to(xs.dtype), cnt[:, 0] > 0.5)
