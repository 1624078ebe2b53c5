"""Fused clip -> (Bucketing) -> smoothed Weiszfeld geometric median (RFA).

The geometric median (Pillutla et al., 2022) iterates

    z <- sum_i w_i x_i / max(sum_i w_i, eps),   w_i = m_i / sqrt(||x_i - z||^2 + eps)

from the masked mean z0 = sum_i m_i x_i / max(sum_i m_i, 1), over the
clipped rows x_i f_i or their bucket means: the semantics of
``repro.core.aggregators._geometric_median`` (eps inside the sqrt, an
eps-guarded weight sum).  ``run_clip_then_iterative`` (centered_clip.py)
does pass 1 and picks one of two schedules by the card's shared memory:

  resident  ``gm_resident``: one launch clips, takes the bucket means, forms
            z0 and runs all ``iters`` steps in one block's shared memory.
            Replaces ``_gm_resident_kernel``.
  tiled     ``gm_tiled``: z0 through ``gm_update`` with the weights m, then
            per step one ``diff_row_ssq`` pass, the n weights and their sum
            on the device, and one ``gm_update`` pass; under Bucketing one
            ``bucket_means`` pass first.  ``gm_update`` replaces
            ``_gm_update_kernel``.

The kernels are in ``csrc/geometric_median.cu``.  On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
PyTorch version beside it.
"""
from __future__ import annotations

import torch

from . import _build
from .centered_clip import (
    _check_aux,
    _reduced,
    bucket_means_plain,
    diff_row_ssq,
    diff_row_ssq_plain,
    resident_smem_bytes,
    run_clip_then_iterative,
    smem_budget,
)
from .coordinate_median import _row_vector, check_matrix

__all__ = ["LAUNCHES", "gm_resident_plain", "gm_resident",
           "gm_update_plain", "gm_update", "gm_tiled_plain", "gm_tiled",
           "clip_then_geometric_median_plain", "clip_then_geometric_median",
           "geometric_median"]

LAUNCHES = {"gm_resident": 0, "gm_update": 0}


def gm_resident_plain(xs, mask, factors, bucket_idx, s: int, *, iters: int,
                      eps: float) -> torch.Tensor:
    """Plain version of the resident kernel: (d,) f32."""
    if s >= 2:
        x, m = bucket_means_plain(xs, mask, factors, bucket_idx, s)
    else:
        x, m = xs.float() * factors[:, None], mask
    z = (x * m[:, None]).sum(dim=0) / m.sum().clamp(min=1.0)
    for _ in range(iters):
        w = m / torch.sqrt(((x - z[None]) ** 2).sum(dim=1) + eps)
        z = (x * w[:, None]).sum(dim=0) / w.sum().clamp(min=eps)
    return z


def gm_resident(xs, mask, factors, bucket_idx, s: int, *, iters: int = 8,
                eps: float = 1e-8) -> torch.Tensor:
    """(n, d) rows and (n_p,) padded auxiliaries -> (d,) f32 geometric
    median of the clipped rows (s = 1) or of their bucket means, in one
    launch.  Raises when it does not fit the card's shared memory."""
    check_matrix(xs, "gm_resident")
    mask, factors, bucket_idx = _check_aux(xs, mask, factors, bucket_idx, s)
    if not xs.is_cuda:
        return gm_resident_plain(xs, mask, factors, bucket_idx, s,
                                 iters=iters, eps=eps)
    n, d = xs.shape
    smem = resident_smem_bytes(mask.shape[0] // s, d)
    budget = smem_budget(xs.device)  # once per card: lets the kernel take it
    if smem > budget:
        raise ValueError(f"gm_resident needs {smem} bytes of shared memory, "
                         f"the card allows {budget}")
    out = torch.empty(d, dtype=torch.float32, device=xs.device)
    lib = _build.load("geometric_median")
    with torch.cuda.device(xs.device):
        rc = lib.gm_resident_launch(
            xs.data_ptr(), factors.data_ptr(), mask.data_ptr(),
            bucket_idx.data_ptr(), out.data_ptr(), _build.dtype_code(xs), n,
            mask.shape[0], d, s, iters, float(eps), smem,
            _build.stream_ptr())
    _build.check(lib, "gm_resident", rc)
    LAUNCHES["gm_resident"] += 1
    return out


def gm_update_plain(x, w, factors, wsum) -> torch.Tensor:
    """Plain version: (d,) f32 sum_i (x_i f_i) w_i / wsum."""
    x32 = x.float()
    if factors is not None:
        x32 = x32 * factors[:, None]
    return (x32 * w[:, None]).sum(dim=0) / wsum


def gm_update(x, w, factors, wsum) -> torch.Tensor:
    """(n, d) rows, (n,) f32 weights, (n,) f32 factors or None for 1, a 0-d
    f32 ``wsum`` on the rows' device -> (d,) f32 weighted mean."""
    check_matrix(x, "gm_update")
    n, d = x.shape
    dev = x.device
    w = _row_vector(w, n, dev, torch.float32, "w")
    if factors is not None:
        factors = _row_vector(factors, n, dev, torch.float32, "factors")
    if wsum.shape != () or wsum.device != dev:
        raise ValueError(f"wsum must be a 0-d tensor on {dev}")
    wsum = wsum.float()
    if not x.is_cuda:
        return gm_update_plain(x, w, factors, wsum)
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = _build.load("geometric_median")
    with torch.cuda.device(dev):
        rc = lib.gm_update_launch(
            x.data_ptr(), None if factors is None else factors.data_ptr(),
            w.data_ptr(), wsum.data_ptr(), out.data_ptr(),
            _build.dtype_code(x), n, d, _build.stream_ptr())
    _build.check(lib, "gm_update", rc)
    LAUNCHES["gm_update"] += 1
    return out


def _tiled(x, mask, factors, iters, eps, ssq_fn, update_fn):
    mask = mask.float()
    z = update_fn(x, mask, factors, mask.sum().clamp(min=1.0))
    for _ in range(iters):
        w = mask / torch.sqrt(ssq_fn(x, z, factors) + eps)
        z = update_fn(x, w, factors, w.sum().clamp(min=eps))
    return z


def gm_tiled_plain(x, mask, factors, *, iters: int = 8, eps: float = 1e-8,
                   reduce_fn=None) -> torch.Tensor:
    """Plain version of ``gm_tiled``, composed the same way."""
    return _tiled(x, mask, factors, iters, eps,
                  _reduced(diff_row_ssq_plain, reduce_fn), gm_update_plain)


def gm_tiled(x, mask, factors, *, iters: int = 8, eps: float = 1e-8,
             reduce_fn=None) -> torch.Tensor:
    """The streaming schedule over (rows, d) ``x`` with (rows,) weights
    ``mask`` and factors (None for 1): 1 + ``iters`` launches of
    ``gm_update`` and ``iters`` of ``diff_row_ssq``; the weights stay on
    the device.  ``reduce_fn`` reduces each Weiszfeld step's (rows,)
    squared distances across coordinate shards.  Returns (d,) f32."""
    return _tiled(x, mask, factors, iters, eps,
                  _reduced(diff_row_ssq, reduce_fn), gm_update)


def clip_then_geometric_median_plain(xs, radius, mask=None, bucket_idx=None,
                                     factors=None, *, iters: int = 8,
                                     eps: float = 1e-8, bucket_s: int = 1,
                                     use_clip: bool = True, reduce_fn=None):
    """Plain version of ``clip_then_geometric_median`` on any device: the
    plain versions of its kernels, with the same dispatch and
    composition."""

    def resident(x, m, f, idx, s):
        return gm_resident_plain(x, m, f, idx, s, iters=iters, eps=eps)

    def tiled(x, m, f):
        return gm_tiled_plain(x, m, f, iters=iters, eps=eps,
                              reduce_fn=reduce_fn)

    return run_clip_then_iterative(
        xs, radius, mask, bucket_idx, factors, bucket_s=bucket_s,
        use_clip=use_clip, resident_fn=resident, tiled_fn=tiled, plain=True,
        reduce_fn=reduce_fn)


def clip_then_geometric_median(xs, radius, mask=None, bucket_idx=None,
                               factors=None, *, iters: int = 8,
                               eps: float = 1e-8, bucket_s: int = 1,
                               use_clip: bool = True, reduce_fn=None):
    """Per-row clip at ``radius`` -> (Bucketing over ``bucket_idx`` when
    ``bucket_s >= 2``) -> Weiszfeld geometric median over the rows of
    (n, d).  ``use_clip=False`` skips pass 1; ``factors`` and
    ``reduce_fn`` as in ``run_clip_then_iterative`` (centered_clip.py).
    Returns ``(aggregated (d,) in xs.dtype, row_norms (n,) f32 or
    None)``."""

    def resident(x, m, f, idx, s):
        return gm_resident(x, m, f, idx, s, iters=iters, eps=eps)

    def tiled(x, m, f):
        return gm_tiled(x, m, f, iters=iters, eps=eps, reduce_fn=reduce_fn)

    return run_clip_then_iterative(
        xs, radius, mask, bucket_idx, factors, bucket_s=bucket_s,
        use_clip=use_clip, resident_fn=resident, tiled_fn=tiled,
        reduce_fn=reduce_fn)


def geometric_median(xs, mask=None, *, iters: int = 8, eps: float = 1e-8):
    """(n, d) -> (d,) smoothed Weiszfeld geometric median (mask-aware)."""
    out, _ = clip_then_geometric_median(xs, 0.0, mask, iters=iters, eps=eps,
                                        use_clip=False)
    return out
