"""Masked coordinate-wise median / trimmed mean over workers.

``coordinate_median(xs, mask, trim_ratio=...)`` maps (n, d) to (d,): the
numpy median of the rows with ``mask[i]`` (``trim_ratio < 0``) or their
symmetric trimmed mean.  On a CUDA tensor it launches the selection
kernel of ``csrc/select.cuh`` with s = 1, rows in order and no clip
factors, through the C entry point of ``csrc/clip_aggregate.cu`` that
pass 2 of the fused server step uses too; it replaces ``_cm_kernel`` /
``_tm_kernel`` of ``src/repro/kernels/coordinate_median.py`` and counts
its launches apart from pass 2's.  On a CPU tensor it runs the plain
PyTorch version beside it, which repeats the kernel's arithmetic.

The kernel is bound by bytes: it reads the kept rows once (4 bytes a
value in f32).  Each thread owns one coordinate and holds its values in
registers as sort keys.  At the widths of ``networks.EXACT`` (n = 20 and
16) the median sorts only the kept values, with a network made for their
count that reaches just the two middle positions, and the trimmed mean
sorts all n slots with a network of exactly n wires; other n take a
bitonic network over the least of ``NB_CAPS`` (16, 32, 64 or 128) that
holds them.  More than ``MAX_SLOTS`` rows raise ValueError.

Masked rows are pushed to +3.4e37 and sort last; a NaN sorts after
them, as ``torch.sort`` orders it.  The median of cnt
valid rows is the mean of sorted positions (cnt-1)//2 and cnt//2; with
cnt = 0 both are position 0, so the result is 3.4e37, as in the jnp
reference (the TPU kernel returns 1.7e37 there).  The trimmed mean drops
t = min(ceil(r*cnt), (cnt-1)//2) sorted values at each end and sums the
rest in ascending order.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["BIG", "NB_CAPS", "MAX_SLOTS", "LAUNCHES", "select_plain",
           "coordinate_median_plain", "coordinate_median", "nb_cap",
           "check_matrix"]

BIG = 3.4e37  # +inf stand-in: 3.4e37 * 0 stays 0
NB_CAPS = (16, 32, 64, 128)
MAX_SLOTS = NB_CAPS[-1]
LAUNCHES = {"coordinate_median": 0}


def nb_cap(nb: int) -> int:
    """The kernel's compile-time slot count for ``nb`` values."""
    for cap in NB_CAPS:
        if nb <= cap:
            return cap
    raise ValueError(
        f"the selection kernels hold at most {MAX_SLOTS} values per "
        f"coordinate (rows, or buckets under Bucketing); got {nb}"
    )


def check_matrix(xs: torch.Tensor, what: str) -> None:
    """Raise unless ``xs`` is a 2-D f32/bf16 matrix the kernels take."""
    if xs.ndim != 2 or xs.shape[0] < 1 or xs.shape[1] < 1:
        raise ValueError(f"{what}: need a non-empty (n, d) matrix, got "
                         f"shape {tuple(xs.shape)}")
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: need float32 or bfloat16, got {xs.dtype}")
    if xs.is_cuda and not xs.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel needs a contiguous matrix")


def _row_vector(v, n: int, device, dtype, what: str) -> torch.Tensor:
    if v.shape != (n,):
        raise ValueError(f"{what} must have shape ({n},), got {tuple(v.shape)}")
    if v.device != device:
        raise ValueError(f"{what} is on {v.device}, the matrix on {device}")
    return v.to(dtype).contiguous()


def select_plain(vals: torch.Tensor, cnt: torch.Tensor,
                 trim_ratio: float) -> torch.Tensor:
    """Order statistics over the rows of (m, d) f32 ``vals`` whose invalid
    rows hold 3.4e37; ``cnt`` is the 0-d count of valid rows.  The
    kernel's selection, written with ``torch.sort``."""
    s = torch.sort(vals, dim=0).values
    half_lo = torch.div(cnt - 1, 2, rounding_mode="floor")
    if trim_ratio < 0:
        lo = half_lo.clamp(min=0).view(1)
        hi = (cnt // 2).view(1)
        return 0.5 * (s.index_select(0, lo)[0] + s.index_select(0, hi)[0])
    ratio = torch.tensor(trim_ratio, dtype=torch.float32, device=vals.device)
    t = torch.minimum(torch.ceil(ratio * cnt.float()).long(), half_lo)
    k = torch.arange(s.shape[0], device=vals.device)[:, None]
    keep = (k >= t) & (k < cnt - t)
    denom = (cnt - 2 * t).clamp(min=1).float()
    return torch.where(keep, s, 0.0).sum(dim=0) / denom


def coordinate_median_plain(xs: torch.Tensor, mask=None,
                            trim_ratio: float = -1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (n, d) -> (d,) f32."""
    n = xs.shape[0]
    m = torch.ones(n, device=xs.device) if mask is None else mask.float()
    ok = m > 0.5
    vals = torch.where(ok[:, None], xs.float(), BIG)
    return select_plain(vals, ok.sum(), trim_ratio)


def coordinate_median(xs: torch.Tensor, mask=None, *,
                      trim_ratio: float = -1.0) -> torch.Tensor:
    """(n, d) -> (d,) in ``xs.dtype``: masked CM (``trim_ratio < 0``) or
    trimmed mean.  CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    check_matrix(xs, "coordinate_median")
    n, d = xs.shape
    cap = nb_cap(n)
    if mask is not None:  # a row is in when its mask is > 0.5
        mask = (_row_vector(mask, n, xs.device, torch.float32, "mask")
                > 0.5).float()
    if not xs.is_cuda:
        return coordinate_median_plain(xs, mask, trim_ratio).to(xs.dtype)
    if mask is None:
        mask = torch.ones(n, dtype=torch.float32, device=xs.device)
    out = torch.empty(d, dtype=torch.float32, device=xs.device)
    lib = _build.load("clip_aggregate")
    with torch.cuda.device(xs.device):
        # s = 1: n_p = nb = n; null factors and null row gather
        rc = lib.clip_bucket_select_launch(
            xs.data_ptr(), None, mask.data_ptr(), None, out.data_ptr(),
            _build.dtype_code(xs), n, n, d, 1, n, float(trim_ratio), cap,
            _build.stream_ptr(),
        )
    _build.check(lib, "coordinate_median", rc)
    LAUNCHES["coordinate_median"] += 1
    return out.to(xs.dtype)
