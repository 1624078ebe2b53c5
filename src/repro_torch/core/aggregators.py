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
``"torch"``/``"cuda"``.  Rules: mean, cm, trimmed_mean, rfa (the
geometric median), krum, multi_krum and centered_clip, each optionally
over Bucketing: the whole registry of the reference.

Krum and multi-Krum are (n, n) algebra on the Gram matrix of the rows
(``repro_torch.kernels.krum``) on every backend, Bucketing included, and
they also expose the TWO-PHASE contract, for callers that see the rows
in several coordinate blocks or as they stream in:

    stats = agg.accumulate_stats(blocks)      # the (n, n) Gram, additive
    sel   = agg.finalize(stats, mask=..., key=..., radius=...)
    outs  = agg.apply_selection(blocks, sel)

Every rule takes a ``reduce_fn``, as the reference's do: on a mesh each
rank holds a block of every row's coordinates, and ``reduce_fn``
all-reduces a rule's row statistics (squared distances, the Gram) across
the ranks that hold the rest.  The coordinate-wise rules accept it and
leave it unused; Bucketing passes it to its inner rule.

``update_stats`` folds a chunk of newly arrived rows into running stats
(``repro_torch.serve``); ``supports_two_phase`` says whether a rule has
the contract.  A clipped ``clip_then_aggregate`` takes the clip factors
from diag(G) on every backend, as the fused one-shot kernels do.

Bucketing's ``key`` is the row order source: an explicit permutation
(an (n,) integer tensor, e.g. replayed from a recorded run), a
``torch.Generator`` to draw one from, or None (a generator seeded 0).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from importlib import import_module
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as _kops
from ..kernels.krum import RowSelection
from .clipping import clip_rows
from .tree_utils import tree_batch_ravel

# the module: the package binds the name ``krum`` to the function
_kkrum = import_module("repro_torch.kernels.krum")

__all__ = ["Aggregator", "RowSelection", "mean", "coordinate_median",
           "trimmed_mean", "geometric_median", "krum", "multi_krum",
           "centered_clip", "bucketing", "make_aggregator", "resolve_backend",
           "RULE_ALIASES"]

_BIG = 3.4e37  # +inf stand-in that survives arithmetic


def _full_mask(xs, mask):
    if mask is None:
        return torch.ones(xs.shape[0], dtype=torch.bool, device=xs.device)
    return mask.bool()


# ---------------------------------------------------------------------------
# plain rules ("torch" backend)
# ---------------------------------------------------------------------------

def _mean(xs, mask=None, key=None, reduce_fn=None):
    m = _full_mask(xs, mask).to(xs.dtype)
    return (xs * m[:, None]).sum(dim=0) / m.sum().clamp(min=1.0)


def _masked_sorted(xs, mask):
    """Columns sorted ascending with un-sampled rows pushed to +3.4e37;
    returns (sorted (n, d) f32, 0-d count of sampled rows)."""
    m = _full_mask(xs, mask)
    vals = torch.where(m[:, None], xs.float(), _BIG)
    return torch.sort(vals, dim=0).values, m.sum()


def _coordinate_median(xs, mask=None, key=None, reduce_fn=None):
    """Coordinate-wise median over the sampled rows (numpy semantics)."""
    s, cnt = _masked_sorted(xs, mask)
    lo = torch.div(cnt - 1, 2, rounding_mode="floor").clamp(min=0).view(1)
    hi = (cnt // 2).view(1)
    v = s.index_select(0, lo)[0] + s.index_select(0, hi)[0]
    return (0.5 * v).to(xs.dtype)


def _trimmed_mean(xs, mask=None, key=None, reduce_fn=None, *,
                  trim_ratio: float = 0.1):
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


def _reduce(ssq, reduce_fn):
    return ssq if reduce_fn is None else reduce_fn(ssq)


def _geometric_median(xs, mask=None, key=None, reduce_fn=None, *,
                      iters: int = 8, eps: float = 1e-8):
    """Geometric median via smoothed Weiszfeld fixed-point iterations
    (Pillutla et al., 2022 — "RFA"): eps inside the sqrt, an eps-guarded
    weight sum.  F_A = 1 (it stays in the convex hull).  ``reduce_fn``
    reduces the per-row squared distances across coordinate shards."""
    m = _full_mask(xs, mask).float()
    x32 = xs.float()
    z = (x32 * m[:, None]).sum(dim=0) / m.sum().clamp(min=1.0)
    for _ in range(iters):
        ssq = _reduce(((x32 - z[None]) ** 2).sum(dim=1), reduce_fn)
        dist = torch.sqrt(ssq + eps)
        w = m / dist
        z = (x32 * w[:, None]).sum(dim=0) / w.sum().clamp(min=eps)
    return z.to(xs.dtype)


def _centered_clip(xs, mask=None, key=None, reduce_fn=None, *,
                   tau: float = 10.0, iters: int = 5):
    """CenteredClip (Karimireddy et al., 2021): from the masked mean v0,
    ``iters`` steps of v <- v + sum_i m_i min(1, tau/||x_i - v||)(x_i - v)
    / max(sum m, 1), the norm taken as sqrt(||x_i - v||^2 + 1e-30)."""
    m = _full_mask(xs, mask).float()
    x32 = xs.float()
    denom = m.sum().clamp(min=1.0)
    v = (x32 * m[:, None]).sum(dim=0) / denom
    for _ in range(iters):
        diff = x32 - v[None]
        nrm = torch.sqrt(_reduce((diff * diff).sum(dim=1), reduce_fn)
                         + 1e-30)
        scale = torch.clamp(nrm.new_tensor(tau) / nrm, max=1.0)  # f32 divide
        v = v + (diff * (scale * m)[:, None]).sum(dim=0) / denom
    return v.to(xs.dtype)


def _krum(xs, mask=None, key=None, reduce_fn=None, *,
          byz_bound: Optional[int] = None, m_select: int = 0,
          multi: bool = False, bucket_s: int = 0):
    """Krum (Blanchard et al., 2017), or multi-Krum (Damaskinos et al.,
    2019) with ``multi``: the row, or the mean of the m rows, with the
    best summed squared distance to the cnt-B-2 nearest sampled
    neighbours; over Bucketing's bucket means when ``bucket_s >= 2``
    (the M G M^T algebra, ``key`` the row order).  ``reduce_fn`` sums the
    Gram across coordinate shards.  F_A = 1."""
    idx = (_bucket_order(key, mask, xs.shape[0], xs.device)
           if bucket_s >= 2 else None)
    out, _ = _kkrum.clip_then_krum_plain(
        xs, 0.0, mask, idx, byz_bound=byz_bound, m_select=m_select,
        multi=multi, bucket_s=max(bucket_s, 1), use_clip=False,
        reduce_fn=reduce_fn)
    return out


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


def _bucketing(xs, mask=None, key=None, reduce_fn=None, *, s: int = 2,
               inner=None):
    """Permute rows, average buckets of ``s`` over their sampled members,
    apply ``inner`` with empty buckets masked out.  The bucket means are
    linear, so exact on a coordinate shard: only ``inner`` takes
    ``reduce_fn``."""
    n = xs.shape[0]
    m = _full_mask(xs, mask)
    idx = _bucket_order(key, mask, n, xs.device)
    n_buckets = -(-n // s)
    pad = n_buckets * s - n
    xb = F.pad(xs[idx], (0, 0, 0, pad)).view(n_buckets, s, -1)
    mb = F.pad(m[idx].to(xs.dtype), (0, pad)).view(n_buckets, s)
    cntb = mb.sum(dim=1)
    means = (xb * mb[:, :, None]).sum(dim=1) / cntb.clamp(min=1.0)[:, None]
    return inner(means, mask=cntb > 0, reduce_fn=reduce_fn)


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
    clip -> aggregate, set for the two kernel backends.  ``clip_fn``: the
    plain clip -> aggregate of a rule that clips its own way (Krum, by the
    norms on diag G); None: clip the rows, then ``fn``.
    ``stats_fn``/``finalize_fn``/``apply_fn``/``update_stats_fn``: the
    two-phase contract (module docstring), None for rules without one.
    """

    name: str
    fn: Callable
    f_a: Callable[[int], float]
    is_aragg: bool
    c_const: float  # the c in (delta, c)-RAgg (literature values)
    backend: str = "torch"
    kernel_fn: Optional[Callable] = None
    fused_clip_fn: Optional[Callable] = None
    clip_fn: Optional[Callable] = None
    stats_fn: Optional[Callable] = None
    finalize_fn: Optional[Callable] = None
    apply_fn: Optional[Callable] = None
    update_stats_fn: Optional[Callable] = None

    @property
    def supports_two_phase(self) -> bool:
        """Whether accumulate_stats/finalize/apply_selection are usable."""
        return self.stats_fn is not None

    def uses_kernels(self, xs) -> bool:
        """Whether this rule runs its kernels on ``xs``' device (backend
        "cuda" raises on a CPU tensor)."""
        if self.backend == "torch":
            return False
        if xs.is_cuda:
            return True
        if self.backend == "cuda":
            raise ValueError(
                f"aggregator {self.name!r} has backend 'cuda' but got a "
                f"tensor on {xs.device}; use backend 'torch' or 'auto' there")
        return False

    def _runs_kernels(self, xs) -> bool:
        """``uses_kernels``, refusing a tensor that records a gradient:
        the kernels build no autograd graph, so their result would lack
        one (differentiate through
        ``repro_torch.scenarios.differentiable_aggregate``)."""
        if not self.uses_kernels(xs):
            return False
        if xs.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                f"aggregator {self.name!r} runs CUDA kernels, which build no "
                "autograd graph; differentiate through "
                "repro_torch.scenarios.differentiable_aggregate")
        return True

    def __call__(self, xs, mask=None, key=None, reduce_fn=None):
        """``reduce_fn`` reduces the rule's row statistics across
        coordinate shards (module docstring)."""
        if isinstance(xs, dict):
            mat, unravel_row = tree_batch_ravel(xs)
            return unravel_row(self(mat, mask=mask, key=key,
                                    reduce_fn=reduce_fn))
        fn = self.kernel_fn if self._runs_kernels(xs) else self.fn
        return fn(xs, mask=mask, key=key, reduce_fn=reduce_fn)

    def clip_then_aggregate(self, xs, radius, mask=None, key=None,
                            factors=None, reduce_fn=None):
        """Agg over per-row l2-clipped messages (the Algorithm-1 server
        step of difference rounds); fused on the kernel backends.
        ``factors`` (n,) scales the rows by the given clip factors instead
        of clipping by their own norms: a mesh computes them from each
        worker's whole message, which one block of it cannot see.
        ``reduce_fn`` as in ``__call__``."""
        if isinstance(xs, dict):
            mat, unravel_row = tree_batch_ravel(xs)
            return unravel_row(self.clip_then_aggregate(
                mat, radius, mask=mask, key=key, factors=factors,
                reduce_fn=reduce_fn))
        if self._runs_kernels(xs):
            return self.fused_clip_fn(xs, radius, mask=mask, key=key,
                                      factors=factors, reduce_fn=reduce_fn)
        if self.clip_fn is not None:
            return self.clip_fn(xs, radius, mask=mask, key=key,
                                factors=factors, reduce_fn=reduce_fn)
        if factors is not None:
            clipped = (xs * factors[:, None]).to(xs.dtype)
        else:
            clipped = clip_rows(xs, radius)
        return self.fn(clipped, mask=mask, key=key, reduce_fn=reduce_fn)

    # -- two-phase selection (one decision over many blocks) --

    def _two_phase(self, xs):
        if self.stats_fn is None:
            raise NotImplementedError(
                f"aggregator {self.name!r} has no two-phase selection form")
        blocks = xs if isinstance(xs, (list, tuple)) else [xs]
        for block in blocks[:1]:  # backend "cuda" refuses a CPU tensor
            self.uses_kernels(block)

    def accumulate_stats(self, xs, reduce_fn=None):
        """Phase 1: the (n, n) Gram of one (n, d) block, or summed in list
        order over a list of coordinate chunks; additive over any
        coordinate partition, so a caller sums it over its blocks.
        ``reduce_fn`` makes a rank's block's Gram global (a mesh's
        all-reduce)."""
        self._two_phase(xs)
        return _kops.accumulate_stats_blocks(self.stats_fn, xs, reduce_fn)

    def update_stats(self, stats, buffer, chunk_emb, chunk_mask):
        """Phase 1 for rows that stream in: fold a chunk into the running
        (n, n) stats.  ``buffer`` is the (n, d) row buffer with the chunk
        in it, ``chunk_emb`` the chunk at its slot rows of a zero (n, d)
        matrix, ``chunk_mask`` the (n,) chunk membership.  The cross-Gram
        runs at the full (n, d) shape and the entries the chunk touches are
        replaced, so once every row is in, the stats equal the one-shot
        Gram of the buffer bit for bit (the Gram being exactly symmetric)."""
        self._two_phase(buffer)
        return self.update_stats_fn(stats, buffer, chunk_emb, chunk_mask)

    def finalize(self, stats, mask=None, key=None, radius=None,
                 factors=None):
        """Phase 2: the selection from the accumulated stats, clipping at
        ``factors`` or, else, at ``radius`` by the norms on diag(stats)
        (neither: no clip).  Returns a RowSelection for apply_selection."""
        if self.finalize_fn is None:
            raise NotImplementedError(
                f"aggregator {self.name!r} has no two-phase selection form")
        return self.finalize_fn(stats, mask=mask, key=key, radius=radius,
                                factors=factors)

    def apply_selection(self, xs, selection):
        """Phase 3: the selection's row combination over one (n, d) block,
        or the per-chunk outputs over a list."""
        self._two_phase(xs)
        return _kops.apply_selection_blocks(self.apply_fn, xs, selection)


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


def krum(byz_bound: Optional[int] = None) -> Aggregator:
    return Aggregator("krum", partial(_krum, byz_bound=byz_bound),
                      lambda d: 1.0, False, 1.0)


def multi_krum(byz_bound: Optional[int] = None,
               m_select: int = 0) -> Aggregator:
    return Aggregator(
        "multikrum",
        partial(_krum, byz_bound=byz_bound, m_select=m_select, multi=True),
        lambda d: 1.0,  # the mean of input rows stays in the hull
        False, 1.0)


def centered_clip(tau: float = 10.0, iters: int = 5) -> Aggregator:
    return Aggregator("cclip", partial(_centered_clip, tau=tau, iters=iters),
                      lambda d: 1.0,  # v0 in the hull, each step moves <= tau
                      True, 1.0)


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
    "krum": lambda **kw: krum(kw.get("byz_bound")),
    "multi_krum": lambda **kw: multi_krum(kw.get("byz_bound"),
                                          int(kw.get("m_select", 0))),
    "centered_clip": lambda **kw: centered_clip(float(kw.get("tau", 10.0)),
                                                int(kw.get("iters", 5))),
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
    shared ``_bucket_order``.  ``kernel_fn(xs, radius, mask, bucket_idx,
    factors, *, bucket_s, use_clip, reduce_fn, **kw) -> (out, norms)``."""

    def _idx(key, mask, xs):
        if bucket_s < 2:
            return None
        return _bucket_order(key, mask, xs.shape[0], xs.device)

    def aggregate(xs, mask=None, key=None, reduce_fn=None):
        out, _ = kernel_fn(xs, 0.0, mask, _idx(key, mask, xs),
                           bucket_s=max(bucket_s, 1), use_clip=False,
                           reduce_fn=reduce_fn, **kernel_kwargs)
        return out

    def fused_clip(xs, radius, mask=None, key=None, factors=None,
                   reduce_fn=None):
        out, _ = kernel_fn(xs, radius, mask, _idx(key, mask, xs), factors,
                           bucket_s=max(bucket_s, 1), use_clip=True,
                           reduce_fn=reduce_fn, **kernel_kwargs)
        return out

    return aggregate, fused_clip


def _cm_kernel_fns(trim_ratio: float, bucket_s: int):
    """CM/TM/mean: the unbucketed, unclipped aggregate goes to the
    standalone CM/TM kernel (no factor pass at all)."""
    bucketed, fused_clip = _kernel_fns(_kops.clip_then_aggregate, bucket_s,
                                       trim_ratio=trim_ratio)

    def aggregate(xs, mask=None, key=None, reduce_fn=None):
        # reduce_fn unused: CM/TM are coordinate-wise (exact per shard)
        if bucket_s >= 2:
            return bucketed(xs, mask=mask, key=key)
        if trim_ratio >= 0:
            return _kops.trimmed_mean(xs, mask, trim_ratio)
        return _kops.coordinate_median(xs, mask)

    return aggregate, fused_clip


def _krum_two_phase_fns(*, byz_bound, m_select, multi, bucket_s, kernels):
    """(stats_fn, finalize_fn, apply_fn, update_stats_fn) of krum or
    multi-Krum.  The selection is the one ``krum_select_from_gram`` on
    every backend; the Gram, cross-Gram and apply are the kernel wrappers
    (``kernels``; their plain versions on a CPU tensor) or the plain
    versions on any device."""
    bs = max(bucket_s, 1)
    onehot = _kkrum.selection_is_onehot(multi, bs)
    if kernels:
        stats_fn, cross_fn = _kkrum.gram_matrix, _kkrum.cross_gram
        apply_fn = partial(_kkrum.apply_row_selection, onehot=onehot)
    else:
        stats_fn, cross_fn = _kkrum.gram_matrix_plain, _kkrum.cross_gram_plain
        apply_fn = partial(_kkrum.apply_row_selection_plain, onehot=onehot)

    def update_stats_fn(stats, buffer, chunk_emb, chunk_mask):
        cm = chunk_mask.bool()
        # the chunk's rows at their slots against the whole buffer: the
        # one-shot Gram's operand shapes, so every entry sums alike
        blk = cross_fn(chunk_emb, buffer)
        touch = cm[:, None] | cm[None, :]
        # replace (never add) the entries the chunk touches, so a
        # resubmitted row and -0.0 payloads stay bit-faithful
        return torch.where(touch, torch.where(cm[:, None], blk, blk.T), stats)

    def finalize_fn(stats, mask=None, key=None, radius=None, factors=None):
        n = stats.shape[0]
        idx = _bucket_order(key, mask, n, stats.device) if bs >= 2 else None
        sel, _ = _kkrum.krum_select_from_gram(
            stats, mask, radius, factors, idx, byz_bound=byz_bound,
            m_select=m_select, multi=multi, bucket_s=bs,
            use_clip=factors is not None or radius is not None)
        return sel

    return stats_fn, finalize_fn, apply_fn, update_stats_fn


def _krum_aggregator(agg: Aggregator, backend: str, bucket_s: int,
                     **selection) -> Aggregator:
    """Krum or multi-Krum on ``backend``.  Bucketing and clipping are the
    (n, n) algebra inside the rule on every backend, as in the two-phase
    finalize, so the one-shot and the two-phase forms select alike."""
    sfn, ffn, afn, ufn = _krum_two_phase_fns(
        bucket_s=bucket_s, kernels=backend != "torch", **selection)
    _, clip_fn = _kernel_fns(_kkrum.clip_then_krum_plain, bucket_s,
                             **selection)
    agg = dataclasses.replace(
        agg, fn=partial(_krum, bucket_s=bucket_s, **selection), backend=backend,
        clip_fn=clip_fn, stats_fn=sfn, finalize_fn=ffn, apply_fn=afn,
        update_stats_fn=ufn)
    if backend == "torch":
        return agg
    kernel_fn, fused = _kernel_fns(_kops.clip_then_krum, bucket_s, **selection)
    return dataclasses.replace(agg, kernel_fn=kernel_fn, fused_clip_fn=fused)


def make_aggregator(name: str, bucket_s: int = 0, backend: str = "torch",
                    **kwargs) -> Aggregator:
    """Build an aggregator by name, optionally over Bucketing
    (``bucket_s >= 2``), backed by ``backend`` (module docstring)."""
    name = RULE_ALIASES.get(name, name)
    if name not in _FACTORY:
        raise ValueError(
            f"unknown aggregator {name!r}; have {sorted(_FACTORY)}")
    resolved = resolve_backend(backend)
    agg = _FACTORY[name](**kwargs)
    bs = bucket_s if bucket_s and bucket_s >= 2 else 0
    if bs:
        agg = bucketing(agg, s=bs)
    if name in ("krum", "multi_krum"):
        return _krum_aggregator(
            agg, resolved, bs, byz_bound=kwargs.get("byz_bound"),
            m_select=int(kwargs.get("m_select", 0)),
            multi=name == "multi_krum")
    if resolved == "torch":
        return agg
    if name in ("rfa", "geometric_median"):
        kernel_fn, fused = _kernel_fns(_kops.clip_then_geometric_median, bs,
                                       iters=int(kwargs.get("iters", 8)))
    elif name == "centered_clip":
        kernel_fn, fused = _kernel_fns(_kops.clip_then_centered_clip, bs,
                                       tau=float(kwargs.get("tau", 10.0)),
                                       iters=int(kwargs.get("iters", 5)))
    else:
        # mean == trimmed mean with t = ceil(0 * cnt) = 0 dropped rows
        trim = {"cm": -1.0, "mean": 0.0}.get(
            name, float(kwargs.get("trim_ratio", _DEFAULT_TRIM)))
        kernel_fn, fused = _cm_kernel_fns(trim, bs)
    return dataclasses.replace(agg, backend=resolved, kernel_fn=kernel_fn,
                               fused_clip_fn=fused)
