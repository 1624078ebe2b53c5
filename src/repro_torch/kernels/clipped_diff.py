"""The worker-side message of Algorithm 1, line 8, fused: the gradient
difference, RandK's keep mask and scale, then the clip.

    d   = (g_new - g_old) * keep * scale      stored in g's dtype
    out = d * min(1, radius / max(||d||, 1e-30))

``clipped_diff`` (the counterpart of ``repro.kernels.clipped_diff``) runs
two kernels of ``csrc/clipped_diff.cu`` over the flattened tensors:

  ``clipped_diff_ssq``    d and one partial sum of d^2 per block (the f32 d,
                          before it is rounded to g's dtype).  Replaces
                          ``_diff_kernel``.
  ``clipped_diff_scale``  d times the clip factor.  Replaces
                          ``_scale_kernel``.

Between them the wrapper sums the partials, takes the norm and the factor
(``clip_factor``) on the device: no host sync, no atomics.  In bf16 d is
rounded before the clip, as the reference stores it.  Any shape and any
length are taken as they are (flat views, no padding copy).  ``keep_mask``
is a bool tensor (read as bytes) or numbers, which are cast to g's dtype
as the reference casts them.

On a CUDA tensor the wrapper launches the kernels or raises; on a CPU
tensor it runs the plain PyTorch version beside it, whose elementwise ops
come in the same order, so given the same factor the two agree bit for
bit.
"""
from __future__ import annotations

import torch

from . import _build
from .clip_aggregate import clip_factor

__all__ = ["LAUNCHES", "clipped_diff_ssq_plain", "clipped_diff_ssq",
           "clipped_diff_scale_plain", "clipped_diff_scale",
           "clipped_diff_plain", "clipped_diff"]

LAUNCHES = {"clipped_diff_ssq": 0, "clipped_diff_scale": 0}


def _check(g_new, g_old, keep_mask):
    if g_new.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"clipped_diff: need float32 or bfloat16, got "
                        f"{g_new.dtype}")
    for what, t in (("g_old", g_old), ("keep_mask", keep_mask)):
        if t.shape != g_new.shape or t.device != g_new.device:
            raise ValueError(f"clipped_diff: {what} has shape "
                             f"{tuple(t.shape)} on {t.device}, g_new "
                             f"{tuple(g_new.shape)} on {g_new.device}")
    if g_old.dtype != g_new.dtype:
        raise TypeError(f"clipped_diff: g_old is {g_old.dtype}, g_new "
                        f"{g_new.dtype}")
    if g_new.numel() < 1:
        raise ValueError("clipped_diff: empty input")


def _flat(t):
    return t.contiguous().view(-1)


def clipped_diff_ssq_plain(g_new, g_old, keep, scale):
    """Plain version of pass 1 over flat vectors: (d in g's dtype, (1,)
    f32 sum of the f32 d^2)."""
    dt = g_new.dtype
    d = ((g_new.float() - g_old.float()) * keep.to(dt).float()
         * torch.as_tensor(scale, dtype=torch.float32, device=g_new.device))
    return d.to(dt), (d * d).sum().view(1)


def clipped_diff_ssq(g_new, g_old, keep, scale):
    """Pass 1 over flat (len,) vectors, ``keep`` bool or g's dtype: (d in
    g's dtype, (blocks,) f32 partial sums of the f32 d^2)."""
    if not g_new.is_cuda:
        return clipped_diff_ssq_plain(g_new, g_old, keep, scale)
    length = g_new.numel()
    lib = _build.load("clipped_diff")
    d = torch.empty_like(g_new)
    partial = torch.empty(lib.clipped_diff_blocks(length),
                          dtype=torch.float32, device=g_new.device)
    with torch.cuda.device(g_new.device):
        rc = lib.clipped_diff_ssq_launch(
            g_new.data_ptr(), g_old.data_ptr(), keep.data_ptr(), float(scale),
            d.data_ptr(), partial.data_ptr(), _build.dtype_code(g_new),
            int(keep.dtype == torch.bool), length, _build.stream_ptr())
    _build.check(lib, "clipped_diff_ssq", rc)
    LAUNCHES["clipped_diff_ssq"] += 1
    return d, partial


def clipped_diff_scale_plain(d, factor):
    """Plain version of pass 2: d * factor in d's dtype."""
    return (d.float() * factor).to(d.dtype)


def clipped_diff_scale(d, factor):
    """Pass 2 over an f32/bf16 ``d``, contiguous on a card: d * factor,
    ``factor`` a 0-d f32 tensor on d's device (read there).  The result
    lies as far past a 16-byte boundary as ``d`` (a view into a slightly
    longer buffer when ``d`` is not on one)."""
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"clipped_diff_scale: need float32 or bfloat16, got "
                        f"{d.dtype}")
    if factor.shape != () or factor.device != d.device:
        raise ValueError(f"factor must be a 0-d tensor on {d.device}")
    factor = factor.float()
    if not d.is_cuda:
        return clipped_diff_scale_plain(d, factor)
    if not d.is_contiguous():
        raise ValueError("clipped_diff_scale: the CUDA kernel needs a "
                         "contiguous d")
    # out lies as far past a 16-byte boundary as d, so that the kernel's
    # loads and stores are whole 16-byte words alike
    past = d.data_ptr() % 16 // d.element_size()
    out = torch.empty_like(d) if past == 0 else torch.empty(
        d.numel() + past, dtype=d.dtype, device=d.device)[past:].view(d.shape)
    lib = _build.load("clipped_diff")
    with torch.cuda.device(d.device):
        rc = lib.clipped_diff_scale_launch(
            d.data_ptr(), factor.data_ptr(), out.data_ptr(),
            _build.dtype_code(d), d.numel(), _build.stream_ptr())
    _build.check(lib, "clipped_diff_scale", rc)
    LAUNCHES["clipped_diff_scale"] += 1
    return out


def _compose(g_new, g_old, radius, keep_mask, scale, ssq_fn, scale_fn):
    _check(g_new, g_old, keep_mask)
    keep = keep_mask if keep_mask.dtype == torch.bool \
        else keep_mask.to(g_new.dtype)
    d, partial = ssq_fn(_flat(g_new), _flat(g_old), _flat(keep), scale)
    norm = torch.sqrt(partial.sum())
    # the radius as a 0-d f32 tensor, so that the factor divides in f32
    factor = clip_factor(norm, torch.as_tensor(radius, dtype=torch.float32,
                                               device=norm.device))
    return scale_fn(d, factor).view(g_new.shape), norm


def clipped_diff_plain(g_new, g_old, radius, keep_mask, scale):
    """Plain version of ``clipped_diff`` on any device, composed the same
    way."""
    return _compose(g_new, g_old, radius, keep_mask, scale,
                    clipped_diff_ssq_plain, clipped_diff_scale_plain)


def clipped_diff(g_new, g_old, radius, keep_mask, scale):
    """clip_radius((g_new - g_old) * keep_mask * scale) over tensors of any
    shape: ``keep_mask`` is RandK's keep pattern (bool, or numbers cast
    to g's dtype), ``scale`` its unbiasedness factor d/k, ``radius`` a
    float or 0-d tensor.  Returns ``(clipped (g_new's shape and dtype),
    norm () f32)``."""
    return _compose(g_new, g_old, radius, keep_mask, scale, clipped_diff_ssq,
                    clipped_diff_scale)
