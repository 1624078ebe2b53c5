"""Public dispatch wrappers around the port's CUDA kernels.

Every wrapper decides by the device of the tensor it is given: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the kernel's
plain PyTorch version.  Nothing falls back from one to the other.

Each kernel counts its launches in a plain int (``LAUNCHES`` of its
module), raised by one where the wrapper launches and nowhere else;
``launch_counts()`` reads them all and ``reset_launch_counts()`` sets
them to 0, so that a run can show which kernels its path went through.

The backend contract (``repro_torch.core.aggregators.make_aggregator``):
``"torch"`` runs the plain aggregation rules on any device, ``"cuda"``
runs these kernels and raises on a CPU tensor, and ``"auto"`` runs the
kernels iff the tensor is on CUDA.  ``"jnp"`` and ``"pallas"`` are read as
``"torch"`` and ``"cuda"``.
"""
from __future__ import annotations

from . import centered_clip as _cc
from . import clip_aggregate as _ca
from . import clipped_diff as _cd
from . import coordinate_median as _cm
from . import geometric_median as _gm
from . import krum as _kr
from . import ref  # noqa: F401  (re-exported, as the reference's ops)
from .centered_clip import (  # noqa: F401
    bucket_means_tiled,
    centered_clip,
    clip_then_centered_clip,
    diff_row_ssq,
)
from .clip_aggregate import (  # noqa: F401
    bucketed_coordinate_median,
    clip_then_aggregate,
    row_norms,
)
from .clipped_diff import clipped_diff  # noqa: F401
from .geometric_median import (  # noqa: F401
    clip_then_geometric_median,
    geometric_median,
)
from .krum import (  # noqa: F401
    RowSelection,
    clip_then_krum,
    krum,
    krum_select_from_gram,
    multi_krum,
    select_row,
    selection_is_onehot,
    weighted_row_sum,
)

__all__ = ["coordinate_median", "trimmed_mean", "clip_then_aggregate",
           "row_norms", "clip_then_geometric_median", "geometric_median",
           "diff_row_ssq", "bucket_means_tiled", "clip_then_centered_clip",
           "centered_clip", "clipped_diff", "bucketed_coordinate_median",
           "clip_then_krum", "krum",
           "multi_krum", "krum_gram", "krum_cross_gram",
           "krum_select_from_gram", "krum_apply", "select_row",
           "weighted_row_sum", "selection_is_onehot", "RowSelection",
           "accumulate_stats_blocks", "apply_selection_blocks",
           "ref", "launch_counts", "reset_launch_counts"]

_COUNTERS = (_ca.LAUNCHES, _cm.LAUNCHES, _cc.LAUNCHES, _gm.LAUNCHES,
             _kr.LAUNCHES, _cd.LAUNCHES)


def coordinate_median(xs, mask=None):
    return _cm.coordinate_median(xs, mask, trim_ratio=-1.0)


def trimmed_mean(xs, mask=None, trim_ratio: float = 0.1):
    return _cm.coordinate_median(xs, mask, trim_ratio=trim_ratio)


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    out = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0


def accumulate_stats_blocks(stats_fn, xs, reduce_fn=None):
    """Phase 1 of the two-phase contract over one (n, d) block, or summed
    in list order over a list of coordinate chunks.  ``reduce_fn`` (a
    mesh's all-reduce across coordinate shards) makes each block's stats
    global before they are summed."""

    def one(block):
        stats = stats_fn(block)
        return stats if reduce_fn is None else reduce_fn(stats)

    if isinstance(xs, (list, tuple)):
        if not xs:
            raise ValueError("accumulate_stats: empty chunk list")
        stats = one(xs[0])
        for block in xs[1:]:
            stats = stats + one(block)
        return stats
    return one(xs)


def apply_selection_blocks(apply_fn, xs, selection):
    """Phase 3 over one block, or per chunk over a list (the per-chunk
    outputs)."""
    if isinstance(xs, (list, tuple)):
        return [apply_fn(block, selection) for block in xs]
    return apply_fn(xs, selection)


def krum_gram(xs, reduce_fn=None):
    """(n, d) -> (n, n) f32 Gram (one ``gram_matrix`` launch per block of a
    chunk list, summed in order): phase 1 of the two-phase Krum contract.
    ``reduce_fn`` sums each block's Gram across coordinate shards."""
    return accumulate_stats_blocks(_kr.gram_matrix, xs, reduce_fn)


def krum_cross_gram(a, b):
    """(n, d), (n, d) -> (n, n) f32 A B^T, bitwise ``krum_gram(a)`` when
    b is a: the streaming server folds each chunk of rows in with it."""
    return _kr.cross_gram(a, b)


def krum_apply(xs, selection, *, onehot: bool = False):
    """Apply a RowSelection to a block (or per chunk of a list); a one-hot
    selection streams only the winner row."""
    return apply_selection_blocks(
        lambda block, sel: _kr.apply_row_selection(block, sel, onehot=onehot),
        xs, selection)
