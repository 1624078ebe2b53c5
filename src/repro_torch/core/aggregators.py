"""(delta, c)-robust aggregation rules (Definition 2.1) and Bucketing:
the slice's part of ``repro.core.aggregators``.

Every rule maps a stacked (n, d) matrix ``xs`` (one row per worker) to
(d,), with an optional (n,) ``mask`` of the sampled cohort S_k
(``None`` = all rows).  A dict of worker-stacked tensors is flattened
into one (n, d) matrix first.

``make_aggregator(..., backend=)`` chooses what backs a rule:
``"torch"`` the plain rules below on any device, ``"cuda"`` the kernels
of ``repro_torch.kernels`` (raising on a CPU tensor), ``"auto"`` the
kernels iff the tensor is on CUDA.  ``"jnp"``/``"pallas"`` are read as
``"torch"``/``"cuda"``.  Ported rules: mean, cm, trimmed_mean and rfa
(the geometric median), each optionally over Bucketing; krum, multi_krum
and centered_clip raise NotImplementedError until their ROADMAP items.

Bucketing's ``key`` is the row order source: an explicit permutation
(an (n,) integer tensor, e.g. replayed from a recorded run), a
``torch.Generator`` to draw one from, or None (a generator seeded 0).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as _kops
from .clipping import clip_factor
from .tree_utils import tree_batch_ravel

__all__ = ["Aggregator", "mean", "coordinate_median", "trimmed_mean",
           "geometric_median", "bucketing", "make_aggregator",
           "resolve_backend", "RULE_ALIASES"]

_BIG = 3.4e37  # +inf stand-in that survives arithmetic


def _full_mask(xs, mask):
    if mask is None:
        return torch.ones(xs.shape[0], dtype=torch.bool, device=xs.device)
    return mask.bool()


# ---------------------------------------------------------------------------
# plain rules ("torch" backend)
# ---------------------------------------------------------------------------

def _mean(xs, mask=None, key=None):
    m = _full_mask(xs, mask).to(xs.dtype)
    return (xs * m[:, None]).sum(dim=0) / m.sum().clamp(min=1.0)


def _masked_sorted(xs, mask):
    """Columns sorted ascending with un-sampled rows pushed to +3.4e37;
    returns (sorted (n, d) f32, 0-d count of sampled rows)."""
    m = _full_mask(xs, mask)
    vals = torch.where(m[:, None], xs.float(), _BIG)
    return torch.sort(vals, dim=0).values, m.sum()


def _coordinate_median(xs, mask=None, key=None):
    """Coordinate-wise median over the sampled rows (numpy semantics)."""
    s, cnt = _masked_sorted(xs, mask)
    lo = torch.div(cnt - 1, 2, rounding_mode="floor").clamp(min=0).view(1)
    hi = (cnt // 2).view(1)
    v = s.index_select(0, lo)[0] + s.index_select(0, hi)[0]
    return (0.5 * v).to(xs.dtype)


def _trimmed_mean(xs, mask=None, key=None, *, trim_ratio: float = 0.1):
    """Drop ceil(trim_ratio*cnt) smallest and largest values per
    coordinate, average the rest."""
    s, cnt = _masked_sorted(xs, mask)
    ratio = torch.tensor(trim_ratio, dtype=torch.float32, device=xs.device)
    t = torch.minimum(torch.ceil(ratio * cnt).long(),
                      torch.div(cnt - 1, 2, rounding_mode="floor"))
    idx = torch.arange(s.shape[0], device=xs.device)[:, None]
    keep = (idx >= t) & (idx < cnt - t)
    denom = (cnt - 2 * t).clamp(min=1)
    return (torch.where(keep, s, 0.0).sum(dim=0) / denom).to(xs.dtype)


def _geometric_median(xs, mask=None, key=None, *, iters: int = 8,
                      eps: float = 1e-8):
    """Geometric median via smoothed Weiszfeld fixed-point iterations
    (Pillutla et al., 2022 — "RFA"): eps inside the sqrt, an eps-guarded
    weight sum.  F_A = 1 (it stays in the convex hull)."""
    m = _full_mask(xs, mask).float()
    x32 = xs.float()
    z = (x32 * m[:, None]).sum(dim=0) / m.sum().clamp(min=1.0)
    for _ in range(iters):
        dist = torch.sqrt(((x32 - z[None]) ** 2).sum(dim=1) + eps)
        w = m / dist
        z = (x32 * w[:, None]).sum(dim=0) / w.sum().clamp(min=eps)
    return z.to(xs.dtype)


# ---------------------------------------------------------------------------
# Bucketing (Algorithm 2, Karimireddy et al., 2022)
# ---------------------------------------------------------------------------

def _bucket_order(key, mask, n: int, device) -> torch.Tensor:
    """The row order Bucketing aggregates in: a permutation, stably
    re-sorted so that sampled rows come first (dense buckets).  ``key``
    is the permutation itself or a generator to draw it from.  Shared by
    the plain and the kernel paths."""
    if key is None or isinstance(key, torch.Generator):
        gen = key if key is not None else torch.Generator().manual_seed(0)
        key = torch.randperm(n, generator=gen, device=gen.device)
    perm = key.to(device=device, dtype=torch.long)
    m = _full_mask(perm, mask)
    order = torch.argsort((~m[perm]).to(torch.int8), stable=True)
    return perm[order]


def _bucketing(xs, mask=None, key=None, *, s: int = 2, inner=None):
    """Permute rows, average buckets of ``s`` over their sampled members,
    apply ``inner`` with empty buckets masked out."""
    n = xs.shape[0]
    m = _full_mask(xs, mask)
    idx = _bucket_order(key, mask, n, xs.device)
    n_buckets = -(-n // s)
    pad = n_buckets * s - n
    xb = F.pad(xs[idx], (0, 0, 0, pad)).view(n_buckets, s, -1)
    mb = F.pad(m[idx].to(xs.dtype), (0, pad)).view(n_buckets, s)
    cntb = mb.sum(dim=1)
    means = (xb * mb[:, :, None]).sum(dim=1) / cntb.clamp(min=1.0)[:, None]
    return inner(means, mask=cntb > 0)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Aggregator:
    """A named aggregation rule with its theory constants.

    ``f_a(d)``: the Assumption-2.3 bound ||A(x_1..x_n)|| <= F_A max||x_i||.
    ``is_aragg``: satisfies Def 2.1 agnostically (possibly via Bucketing).
    ``fn``: the plain rule.  ``backend``: "torch", "cuda" or "auto";
    ``kernel_fn``/``fused_clip_fn`` are the kernel-backed aggregate and
    clip -> aggregate, set for the two kernel backends.
    """

    name: str
    fn: Callable
    f_a: Callable[[int], float]
    is_aragg: bool
    c_const: float  # the c in (delta, c)-RAgg (literature values)
    backend: str = "torch"
    kernel_fn: Optional[Callable] = None
    fused_clip_fn: Optional[Callable] = None

    def _use_kernels(self, xs) -> bool:
        if self.backend == "torch":
            return False
        if xs.is_cuda:
            return True
        if self.backend == "cuda":
            raise ValueError(
                f"aggregator {self.name!r} has backend 'cuda' but got a "
                f"tensor on {xs.device}; use backend 'torch' or 'auto' there")
        return False

    def __call__(self, xs, mask=None, key=None):
        if isinstance(xs, dict):
            mat, unravel_row = tree_batch_ravel(xs)
            return unravel_row(self(mat, mask=mask, key=key))
        fn = self.kernel_fn if self._use_kernels(xs) else self.fn
        return fn(xs, mask=mask, key=key)

    def clip_then_aggregate(self, xs, radius, mask=None, key=None):
        """Agg over per-row l2-clipped messages (the Algorithm-1 server
        step of difference rounds); fused on the kernel backends."""
        if isinstance(xs, dict):
            mat, unravel_row = tree_batch_ravel(xs)
            return unravel_row(self.clip_then_aggregate(
                mat, radius, mask=mask, key=key))
        if self._use_kernels(xs):
            return self.fused_clip_fn(xs, radius, mask=mask, key=key)
        factors = clip_factor(torch.linalg.vector_norm(xs.float(), dim=1),
                              radius)
        clipped = xs * factors[:, None].to(xs.dtype)
        return self.fn(clipped, mask=mask, key=key)


def mean() -> Aggregator:
    return Aggregator("mean", _mean, lambda d: 1.0, False, 0.0)


def coordinate_median() -> Aggregator:
    return Aggregator("cm", _coordinate_median, lambda d: math.sqrt(d),
                      False, 1.0)


def trimmed_mean(trim_ratio: float = 0.1) -> Aggregator:
    return Aggregator(f"tm{trim_ratio}",
                      partial(_trimmed_mean, trim_ratio=trim_ratio),
                      lambda d: math.sqrt(d), True, 1.0)


def geometric_median(iters: int = 8) -> Aggregator:
    return Aggregator("rfa", partial(_geometric_median, iters=iters),
                      lambda d: 1.0, False, 1.0)


def bucketing(inner: Aggregator, s: int = 2) -> Aggregator:
    """Bucketing o inner: upgrades CM to a (delta, c)-ARAgg."""
    return Aggregator(
        f"bucket{s}_{inner.name}",
        partial(_bucketing, s=s, inner=inner.fn),
        inner.f_a,  # bucket means stay in the hull
        True,
        inner.c_const if inner.c_const > 0 else 1.0,
    )


_DEFAULT_TRIM = 0.1

# legacy mesh-config spellings -> canonical registry names
RULE_ALIASES = {"tm": "trimmed_mean", "cclip": "centered_clip", "gm": "rfa"}

_FACTORY = {
    "mean": lambda **kw: mean(),
    "cm": lambda **kw: coordinate_median(),
    "trimmed_mean": lambda **kw: trimmed_mean(
        float(kw.get("trim_ratio", _DEFAULT_TRIM))),
    "rfa": lambda **kw: geometric_median(int(kw.get("iters", 8))),
    "geometric_median": lambda **kw: geometric_median(
        int(kw.get("iters", 8))),
}

# rules of the reference registry that later slices port
_UNPORTED = {
    "krum": "ROADMAP queue 1 item 2 and queue 2 items 6-7",
    "multi_krum": "ROADMAP queue 1 item 2 and queue 2 items 6-7",
    "centered_clip": "ROADMAP queue 1 item 2 and queue 2 items 4-5",
}

_BACKEND_ALIASES = {"jnp": "torch", "pallas": "cuda"}


def resolve_backend(backend: str) -> str:
    """Normalize a backend name to "torch", "cuda" or "auto"."""
    resolved = _BACKEND_ALIASES.get(backend, backend)
    if resolved not in ("torch", "cuda", "auto"):
        raise ValueError(
            f"unknown backend {backend!r}; have 'torch', 'cuda', 'auto' "
            "(and the aliases 'jnp', 'pallas')")
    return resolved


def _kernel_fns(kernel_fn, bucket_s: int, **kernel_kwargs):
    """Kernel-backed (aggregate, fused clip -> aggregate) pair from one of
    the ``clip_then_*`` kernel functions, optionally over Bucketing in the
    shared ``_bucket_order``.  ``kernel_fn(xs, radius, mask, bucket_idx, *,
    bucket_s, use_clip, **kw) -> (out, norms)``."""

    def _idx(key, mask, xs):
        if bucket_s < 2:
            return None
        return _bucket_order(key, mask, xs.shape[0], xs.device)

    def aggregate(xs, mask=None, key=None):
        out, _ = kernel_fn(xs, 0.0, mask, _idx(key, mask, xs),
                           bucket_s=max(bucket_s, 1), use_clip=False,
                           **kernel_kwargs)
        return out

    def fused_clip(xs, radius, mask=None, key=None):
        out, _ = kernel_fn(xs, radius, mask, _idx(key, mask, xs),
                           bucket_s=max(bucket_s, 1), use_clip=True,
                           **kernel_kwargs)
        return out

    return aggregate, fused_clip


def _cm_kernel_fns(trim_ratio: float, bucket_s: int):
    """CM/TM/mean: the unbucketed, unclipped aggregate goes to the
    standalone CM/TM kernel (no factor pass at all)."""
    bucketed, fused_clip = _kernel_fns(_kops.clip_then_aggregate, bucket_s,
                                       trim_ratio=trim_ratio)

    def aggregate(xs, mask=None, key=None):
        if bucket_s >= 2:
            return bucketed(xs, mask=mask, key=key)
        if trim_ratio >= 0:
            return _kops.trimmed_mean(xs, mask, trim_ratio)
        return _kops.coordinate_median(xs, mask)

    return aggregate, fused_clip


def make_aggregator(name: str, bucket_s: int = 0, backend: str = "torch",
                    **kwargs) -> Aggregator:
    """Build an aggregator by name, optionally over Bucketing
    (``bucket_s >= 2``), backed by ``backend`` (module docstring)."""
    name = RULE_ALIASES.get(name, name)
    if name in _UNPORTED:
        raise NotImplementedError(
            f"aggregator {name!r} is not ported yet ({_UNPORTED[name]})")
    if name not in _FACTORY:
        raise ValueError(
            f"unknown aggregator {name!r}; have "
            f"{sorted(set(_FACTORY) | set(_UNPORTED))}")
    resolved = resolve_backend(backend)
    agg = _FACTORY[name](**kwargs)
    if bucket_s and bucket_s >= 2:
        agg = bucketing(agg, s=bucket_s)
    if resolved == "torch":
        return agg
    bs = bucket_s if bucket_s else 0
    if name in ("rfa", "geometric_median"):
        kernel_fn, fused = _kernel_fns(_kops.clip_then_geometric_median, bs,
                                       iters=int(kwargs.get("iters", 8)))
    else:
        # mean == trimmed mean with t = ceil(0 * cnt) = 0 dropped rows
        trim = {"cm": -1.0, "mean": 0.0}.get(
            name, float(kwargs.get("trim_ratio", _DEFAULT_TRIM)))
        kernel_fn, fused = _cm_kernel_fns(trim, bs)
    return dataclasses.replace(agg, backend=resolved, kernel_fn=kernel_fn,
                               fused_clip_fn=fused)
