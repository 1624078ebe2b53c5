"""CenteredClip and the machinery the iterative rules share with the
Weiszfeld geometric median (``geometric_median.py``).

``run_clip_then_iterative`` runs the fused clip -> (Bucketing) ->
iterative aggregation for every such rule, the counterpart of the
function of that name in ``src/repro/kernels/centered_clip.py``: pass 1
(``row_norms``) and ``clip_factor`` give the per-row clip factors, the row
auxiliaries are padded to a multiple of the bucket size s, and the work
goes to one of two schedules:

  resident  the whole problem in one block's shared memory: one launch of
            the rule's resident kernel clips, takes the bucket means and
            runs every iteration;
  tiled     coordinate-tiled: (s >= 2) one ``bucket_means`` pass writes the
            nb bucket means, then the rule's tiled function streams the
            rows (or the means) twice per iteration through
            ``diff_row_ssq`` and its update kernel, with the O(n) weights
            computed on the device between launches (no host sync).

**Dispatch rule.**  With a ``reduce_fn`` (a mesh's all-reduce of the
per-row statistics across coordinate shards) the tiled schedule runs
whatever the shared memory allows: the resident kernel runs every step
inside one launch and cannot host a collective between steps (the
reference's rule).  Otherwise, a rule's resident kernel keeps ``rows``
f32 rows of width d (rows = n for s = 1, n_p / s bucket means for
s >= 2), the iterate z and its per-row scratch in dynamic shared memory,
``resident_smem_bytes(rows, d, rule)`` bytes; it runs iff that fits the
card's opt-in shared memory per block
(``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 232,448 bytes = 227 KB on an
H100).  On a CPU tensor the plain versions take the same decision against
the H100's 227 KB, so a CPU run takes the schedule an H100 run takes.
(The reference's rule, ``(n_p + 2) * d <= 2^20`` elements of TPU VMEM, is
not used.)  Both rules' kernels share one layout (``csrc/resident.cuh``):
two per-row weights (GM: m and w; CenteredClip: m and the scales s) and
the warp sums of each row, so at n = 20 both admit d <= 2,750 unbucketed
and d <= 5,266 under Bucketing(2).

**CenteredClip** (Karimireddy et al., 2021) iterates

    v <- v + sum_i s_i (x_i - v) / den,  s_i = m_i min(1, tau / sqrt(||x_i - v||^2 + 1e-30))

from v0 = sum_i m_i x_i / den, den = max(sum_i m_i, 1), over the clipped
rows x_i f_i or their bucket means (``repro.core.aggregators
._centered_clip``):

  resident  ``cclip_resident``: one launch clips, takes the bucket means,
            forms v0 and runs all ``iters`` steps.  Replaces
            ``_cclip_resident_kernel``.
  tiled     ``cclip_tiled``: v0 through ``cclip_update`` with s = m from
            z = 0, then per step one ``diff_row_ssq`` pass, the n scales on
            the device and one ``cclip_update`` pass; under Bucketing one
            ``bucket_means`` pass first.  ``cclip_update`` replaces
            ``_cclip_update_kernel``.

Row padding (``pad_bucket_aux``): the auxiliaries are padded to n_p, a
multiple of s, with mask 0, factor 1 and row indices n..n_p-1; an index
outside [0, n) is an empty slot, which the kernels never read, so the
matrix itself is never padded.

Kernels here: ``diff_row_ssq`` (replaces ``_diff_ssq_kernel``) and
``bucket_means`` (replaces ``_bucket_means_kernel``), both in
``csrc/geometric_median.cu``, and ``cclip_resident`` and ``cclip_update``
in ``csrc/centered_clip.cu``.  On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs the plain PyTorch version
beside it.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .clip_aggregate import clip_factor, row_norms, row_norms_plain
from .coordinate_median import _row_vector, check_matrix

__all__ = ["LAUNCHES", "H100_SMEM_OPTIN", "resident_smem_bytes",
           "smem_budget", "pad_bucket_aux", "diff_row_ssq_plain",
           "diff_row_ssq", "bucket_means_plain", "bucket_means",
           "bucket_means_tiled", "run_clip_then_iterative",
           "cclip_resident_plain", "cclip_resident", "cclip_update_plain",
           "cclip_update", "cclip_tiled_plain", "cclip_tiled",
           "clip_then_centered_clip_plain", "clip_then_centered_clip",
           "centered_clip"]

LAUNCHES = {"diff_row_ssq": 0, "bucket_means": 0, "cclip_resident": 0,
            "cclip_update": 0}
H100_SMEM_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin, H100
_RES_WARPS = 16  # kResRedWords of csrc/resident.cuh: warp sums a row
# each rule's resident kernel: (its library and opt-in entry point, the
# f32 words of per-row scratch beside the rows and the iterate)
_RESIDENT = {
    "gm": ("geometric_median", "gm_smem_optin", _RES_WARPS + 2),  # m, spare
    "cclip": ("centered_clip", "cclip_smem_optin", _RES_WARPS + 2),
}


def resident_smem_bytes(rows: int, d: int, rule: str = "gm") -> int:
    """Dynamic shared memory of ``rule``'s resident kernel (the rows, z,
    the per-row weights and the warp sums of each row), as
    ``resident_smem_floats`` (csrc/resident.cuh) counts it for both rules:
    the launch takes this count and refuses one that differs."""
    return 4 * (rows * d + d + rows * _RESIDENT[rule][2])


def smem_budget(device: torch.device, rule: str = "gm") -> int:
    """The opt-in shared memory per block that ``rule``'s resident kernel
    must fit: the card's own, or the H100's for a CPU tensor.  The first
    call on a card also lets that kernel take that much there."""
    if device.type != "cuda":
        return H100_SMEM_OPTIN
    index = device.index
    return _card_smem_budget(torch.cuda.current_device() if index is None
                             else index, rule)


@functools.cache
def _card_smem_budget(index: int, rule: str) -> int:
    lib, optin, _ = _RESIDENT[rule]
    with torch.cuda.device(index):
        budget = getattr(_build.load(lib), optin)()
    if budget <= 0:
        raise _build.KernelError(
            "cudaDevAttrMaxSharedMemoryPerBlockOptin failed")
    return budget


def pad_bucket_aux(mask, factors, bucket_idx, n: int, s: int):
    """Pad the (n,) row auxiliaries to n_p = n rounded up to a multiple of
    s: mask with 0, factors with 1, the row order (rows in order when
    None) with n..n_p-1.  Returns (mask, factors, bucket_idx int32)."""
    dev = mask.device
    idx = (torch.arange(n, device=dev) if bucket_idx is None
           else bucket_idx)
    idx = idx.to(torch.int32)
    pad = (-n) % s if s >= 2 else 0
    if pad:
        mask = torch.cat([mask, mask.new_zeros(pad)])
        factors = torch.cat([factors, factors.new_ones(pad)])
        idx = torch.cat([idx, torch.arange(n, n + pad, dtype=torch.int32,
                                           device=dev)])
    return mask.contiguous(), factors.contiguous(), idx.contiguous()


def diff_row_ssq_plain(x, z, factors=None) -> torch.Tensor:
    """Plain version: (n, d), (d,) -> (n,) f32 sum_j (x_ij f_i - z_j)^2."""
    x32 = x.float()
    if factors is not None:
        x32 = x32 * factors[:, None]
    return ((x32 - z[None]) ** 2).sum(dim=1)


def diff_row_ssq(x, z, factors=None) -> torch.Tensor:
    """(n, d) rows, (d,) f32 point, (n,) f32 factors or None for 1 ->
    (n,) f32 squared distances of the scaled rows to z."""
    check_matrix(x, "diff_row_ssq")
    n, d = x.shape
    z = _row_vector(z, d, x.device, torch.float32, "z")
    if factors is not None:
        factors = _row_vector(factors, n, x.device, torch.float32, "factors")
    if not x.is_cuda:
        return diff_row_ssq_plain(x, z, factors)
    lib = _build.load("geometric_median")
    chunks = -(-d // lib.diff_row_ssq_chunk())
    partial = torch.empty((n, chunks), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.diff_row_ssq_launch(
            x.data_ptr(), None if factors is None else factors.data_ptr(),
            z.data_ptr(), partial.data_ptr(), _build.dtype_code(x), n, d,
            chunks, _build.stream_ptr())
    _build.check(lib, "diff_row_ssq", rc)
    LAUNCHES["diff_row_ssq"] += 1
    return partial.sum(dim=1)


def _check_aux(xs, mask, factors, bucket_idx, s):
    n = xs.shape[0]
    n_p = mask.shape[0]
    if s < 1 or n_p % s or n_p < n or n_p - n >= max(s, 1):
        raise ValueError(f"need (n_p,) auxiliaries with n_p = {n} rounded up "
                         f"to a multiple of s = {s}, got n_p = {n_p}")
    dev = xs.device
    return (_row_vector(mask, n_p, dev, torch.float32, "mask"),
            _row_vector(factors, n_p, dev, torch.float32, "factors"),
            _row_vector(bucket_idx, n_p, dev, torch.int32, "bucket_idx"))


def _slot_rows(bucket_idx, n: int) -> torch.Tensor:
    """The row of each slot, with n (a zero row of mask 0) for an empty
    slot, i.e. an index outside [0, n)."""
    idx = bucket_idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _slot_masks(mask, bucket_idx, n: int, s: int) -> torch.Tensor:
    """(nb, s) f32 mask of each bucket's slots."""
    m = torch.cat([mask[:n].float(), mask.new_zeros(1).float()])
    return m[_slot_rows(bucket_idx, n)].view(-1, s)


def bucket_means_plain(xs, mask, factors, bucket_idx, s: int):
    """Plain version: the s-row mask-weighted means of the scaled rows in
    the order ``bucket_idx`` (an index outside [0, n) is an empty slot).
    Returns (means (nb, d) f32, bucket mask (nb,) f32)."""
    n, d = xs.shape
    x = torch.cat([xs.float() * factors[:n, None], xs.new_zeros(1, d).float()])
    xb = x[_slot_rows(bucket_idx, n)].view(-1, s, d)
    mb = _slot_masks(mask, bucket_idx, n, s)
    cnt = mb.sum(dim=1)
    means = (xb * mb[:, :, None]).sum(dim=1) / cnt.clamp(min=1.0)[:, None]
    return means, (cnt > 0.5).float()


def bucket_means(xs, mask, factors, bucket_idx, s: int) -> torch.Tensor:
    """(n, d) rows and (n_p,) padded auxiliaries -> (nb, d) f32 bucket
    means (the kernel; the bucket mask is ``bucket_means_tiled``'s)."""
    check_matrix(xs, "bucket_means")
    mask, factors, bucket_idx = _check_aux(xs, mask, factors, bucket_idx, s)
    if not xs.is_cuda:
        return bucket_means_plain(xs, mask, factors, bucket_idx, s)[0]
    n, d = xs.shape
    nb = mask.shape[0] // s
    out = torch.empty((nb, d), dtype=torch.float32, device=xs.device)
    lib = _build.load("geometric_median")
    with torch.cuda.device(xs.device):
        rc = lib.bucket_means_launch(
            xs.data_ptr(), factors.data_ptr(), mask.data_ptr(),
            bucket_idx.data_ptr(), out.data_ptr(), _build.dtype_code(xs), n,
            d, s, nb, _build.stream_ptr())
    _build.check(lib, "bucket_means", rc)
    LAUNCHES["bucket_means"] += 1
    return out


def bucket_means_tiled(xs, mask, factors, bucket_idx, s: int):
    """Streaming bucket means with the clip factors applied in registers:
    (means (nb, d) f32, bucket mask (nb,) f32, 1 where a bucket holds a
    sampled row)."""
    means = bucket_means(xs, mask, factors, bucket_idx, s)
    cnt = _slot_masks(mask, bucket_idx, xs.shape[0], s).sum(dim=1)
    return means, (cnt > 0.5).float()


def run_clip_then_iterative(xs, radius, mask, bucket_idx, factors=None, *,
                            bucket_s: int, use_clip: bool, resident_fn,
                            tiled_fn, plain: bool = False, rule: str = "gm",
                            reduce_fn=None):
    """The fused clip -> (Bucketing) -> iterative aggregation that the
    iterative rules share (module docstring); ``rule`` ("gm" or "cclip")
    names the resident kernel whose shared memory decides the schedule.

    ``resident_fn(xs, mask, factors, bucket_idx, s)`` -> (d,) f32, the
    one-launch schedule over the (n_p,) padded auxiliaries;
    ``tiled_fn(x, mask, factors)`` -> (d,) f32, the streaming schedule over
    the rows (factors (n,)) or over the bucket means (factors None).
    ``factors`` (n,) skips pass 1 and scales the rows by the given
    factors (a mesh's factors from each worker's whole message).
    ``reduce_fn`` reduces pass 1's sums of squares across coordinate
    shards and forces the tiled schedule, whose ``tiled_fn`` then reduces
    every step's distances with it too.
    ``plain=True`` takes pass 1 and the bucket means from their plain
    versions whatever the device, for a rule's plain twin.
    Returns ``(aggregated (d,) in xs.dtype, row_norms (n,) f32 or None)``.
    """
    check_matrix(xs, "run_clip_then_iterative")
    n, d = xs.shape
    dev = xs.device
    mask = (torch.ones(n, dtype=torch.float32, device=dev) if mask is None
            else _row_vector(mask, n, dev, torch.float32, "mask"))
    if bucket_idx is not None:
        bucket_idx = _row_vector(bucket_idx, n, dev, torch.int32,
                                 "bucket_idx")
    norms = None
    if not use_clip:
        factors = torch.ones(n, dtype=torch.float32, device=dev)
    elif factors is None:
        norms = (row_norms_plain if plain else row_norms)(xs, reduce_fn)
        factors = clip_factor(norms, radius)
    else:
        factors = _row_vector(factors, n, dev, torch.float32, "factors")
    s = bucket_s if bucket_s >= 2 else 1
    mask, factors, bucket_idx = pad_bucket_aux(mask, factors, bucket_idx, n,
                                               s)
    rows = mask.shape[0] // s
    if (reduce_fn is None
            and resident_smem_bytes(rows, d, rule) <= smem_budget(dev, rule)):
        out = resident_fn(xs, mask, factors, bucket_idx, s)
    elif s >= 2:
        means_fn = bucket_means_plain if plain else bucket_means_tiled
        means, bucket_ok = means_fn(xs, mask, factors, bucket_idx, s)
        out = tiled_fn(means, bucket_ok, None)
    else:
        out = tiled_fn(xs, mask, factors)
    return out.to(xs.dtype), norms


# ---------------------------------------------------------------------------
# CenteredClip
# ---------------------------------------------------------------------------

def _cclip_scale(tau: float, ssq, m):
    """s_i = m_i min(1, tau / sqrt(ssq_i + 1e-30)), tau divided in f32."""
    nrm = torch.sqrt(ssq + 1e-30)
    return torch.clamp(nrm.new_tensor(tau) / nrm, max=1.0) * m


def cclip_resident_plain(xs, mask, factors, bucket_idx, s: int, *,
                         iters: int, tau: float) -> torch.Tensor:
    """Plain version of the resident kernel: (d,) f32."""
    if s >= 2:
        x, m = bucket_means_plain(xs, mask, factors, bucket_idx, s)
    else:
        x, m = xs.float() * factors[:, None], mask
    den = m.sum().clamp(min=1.0)
    v = (x * m[:, None]).sum(dim=0) / den
    for _ in range(iters):
        diff = x - v[None]
        sc = _cclip_scale(tau, (diff * diff).sum(dim=1), m)
        v = v + (diff * sc[:, None]).sum(dim=0) / den
    return v


def cclip_resident(xs, mask, factors, bucket_idx, s: int, *, iters: int = 5,
                   tau: float = 10.0) -> torch.Tensor:
    """(n, d) rows and (n_p,) padded auxiliaries -> (d,) f32 CenteredClip
    of the clipped rows (s = 1) or of their bucket means, in one launch.
    Raises when it does not fit the card's shared memory."""
    check_matrix(xs, "cclip_resident")
    mask, factors, bucket_idx = _check_aux(xs, mask, factors, bucket_idx, s)
    if not xs.is_cuda:
        return cclip_resident_plain(xs, mask, factors, bucket_idx, s,
                                    iters=iters, tau=tau)
    n, d = xs.shape
    smem = resident_smem_bytes(mask.shape[0] // s, d, "cclip")
    budget = smem_budget(xs.device, "cclip")  # once per card: the opt-in
    if smem > budget:
        raise ValueError(f"cclip_resident needs {smem} bytes of shared "
                         f"memory, the card allows {budget}")
    out = torch.empty(d, dtype=torch.float32, device=xs.device)
    lib = _build.load("centered_clip")
    with torch.cuda.device(xs.device):
        rc = lib.cclip_resident_launch(
            xs.data_ptr(), factors.data_ptr(), mask.data_ptr(),
            bucket_idx.data_ptr(), out.data_ptr(), _build.dtype_code(xs), n,
            mask.shape[0], d, s, iters, float(tau), smem,
            _build.stream_ptr())
    _build.check(lib, "cclip_resident", rc)
    LAUNCHES["cclip_resident"] += 1
    return out


def cclip_update_plain(x, sc, factors, z, den) -> torch.Tensor:
    """Plain version: (d,) f32 z + sum_i (x_i f_i - z) s_i / den, z None
    for 0."""
    x32 = x.float()
    if factors is not None:
        x32 = x32 * factors[:, None]
    if z is None:
        z = x32.new_zeros(x32.shape[1])
    return z + ((x32 - z[None]) * sc[:, None]).sum(dim=0) / den


def cclip_update(x, sc, factors, z, den) -> torch.Tensor:
    """(n, d) rows, (n,) f32 scales, (n,) f32 factors or None for 1, the
    (d,) f32 iterate or None for 0, a 0-d f32 ``den`` on the rows' device
    -> (d,) f32 next iterate."""
    check_matrix(x, "cclip_update")
    n, d = x.shape
    dev = x.device
    sc = _row_vector(sc, n, dev, torch.float32, "sc")
    if factors is not None:
        factors = _row_vector(factors, n, dev, torch.float32, "factors")
    if z is not None:
        z = _row_vector(z, d, dev, torch.float32, "z")
    if den.shape != () or den.device != dev:
        raise ValueError(f"den must be a 0-d tensor on {dev}")
    den = den.float()
    if not x.is_cuda:
        return cclip_update_plain(x, sc, factors, z, den)
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = _build.load("centered_clip")
    with torch.cuda.device(dev):
        rc = lib.cclip_update_launch(
            x.data_ptr(), None if factors is None else factors.data_ptr(),
            sc.data_ptr(), None if z is None else z.data_ptr(),
            den.data_ptr(), out.data_ptr(), _build.dtype_code(x), n, d,
            _build.stream_ptr())
    _build.check(lib, "cclip_update", rc)
    LAUNCHES["cclip_update"] += 1
    return out


def _reduced(ssq_fn, reduce_fn):
    """``ssq_fn`` with its (n,) output reduced by ``reduce_fn`` (None: as
    it is)."""
    if reduce_fn is None:
        return ssq_fn
    return lambda x, z, factors: reduce_fn(ssq_fn(x, z, factors))


def _cclip_tiled(x, mask, factors, tau, iters, ssq_fn, update_fn):
    mask = mask.float()
    den = mask.sum().clamp(min=1.0)
    v = update_fn(x, mask, factors, None, den)  # v0: the masked mean
    for _ in range(iters):
        sc = _cclip_scale(tau, ssq_fn(x, v, factors), mask)
        v = update_fn(x, sc, factors, v, den)
    return v


def cclip_tiled_plain(x, mask, factors, *, iters: int = 5,
                      tau: float = 10.0, reduce_fn=None) -> torch.Tensor:
    """Plain version of ``cclip_tiled``, composed the same way."""
    return _cclip_tiled(x, mask, factors, tau, iters,
                        _reduced(diff_row_ssq_plain, reduce_fn),
                        cclip_update_plain)


def cclip_tiled(x, mask, factors, *, iters: int = 5, tau: float = 10.0,
                reduce_fn=None) -> torch.Tensor:
    """The streaming schedule over (rows, d) ``x`` with (rows,) weights
    ``mask`` and factors (None for 1): 1 + ``iters`` launches of
    ``cclip_update`` and ``iters`` of ``diff_row_ssq``; the scales stay on
    the device.  ``reduce_fn`` reduces each step's (rows,) squared
    distances across coordinate shards.  Returns (d,) f32."""
    return _cclip_tiled(x, mask, factors, tau, iters,
                        _reduced(diff_row_ssq, reduce_fn), cclip_update)


def clip_then_centered_clip_plain(xs, radius, mask=None, bucket_idx=None,
                                  factors=None, *, tau: float = 10.0,
                                  iters: int = 5, bucket_s: int = 1,
                                  use_clip: bool = True, reduce_fn=None):
    """Plain version of ``clip_then_centered_clip`` on any device: the
    plain versions of its kernels, with the same dispatch and
    composition."""

    def resident(x, m, f, idx, s):
        return cclip_resident_plain(x, m, f, idx, s, iters=iters, tau=tau)

    def tiled(x, m, f):
        return cclip_tiled_plain(x, m, f, iters=iters, tau=tau,
                                 reduce_fn=reduce_fn)

    return run_clip_then_iterative(
        xs, radius, mask, bucket_idx, factors, bucket_s=bucket_s,
        use_clip=use_clip, resident_fn=resident, tiled_fn=tiled, plain=True,
        rule="cclip", reduce_fn=reduce_fn)


def clip_then_centered_clip(xs, radius, mask=None, bucket_idx=None,
                            factors=None, *, tau: float = 10.0,
                            iters: int = 5, bucket_s: int = 1,
                            use_clip: bool = True, reduce_fn=None):
    """Per-row clip at ``radius`` -> (Bucketing over ``bucket_idx`` when
    ``bucket_s >= 2``) -> CenteredClip(tau, iters) over the rows of (n, d).
    ``use_clip=False`` skips pass 1; ``factors`` and ``reduce_fn`` as in
    ``run_clip_then_iterative``.  Returns ``(aggregated (d,) in
    xs.dtype, row_norms (n,) f32 or None)``."""

    def resident(x, m, f, idx, s):
        return cclip_resident(x, m, f, idx, s, iters=iters, tau=tau)

    def tiled(x, m, f):
        return cclip_tiled(x, m, f, iters=iters, tau=tau, reduce_fn=reduce_fn)

    return run_clip_then_iterative(
        xs, radius, mask, bucket_idx, factors, bucket_s=bucket_s,
        use_clip=use_clip, resident_fn=resident, tiled_fn=tiled,
        rule="cclip", reduce_fn=reduce_fn)


def centered_clip(xs, mask=None, *, tau: float = 10.0, iters: int = 5):
    """(n, d) -> (d,) CenteredClip aggregate (mask-aware)."""
    out, _ = clip_then_centered_clip(xs, 0.0, mask, tau=tau, iters=iters,
                                     use_clip=False)
    return out
