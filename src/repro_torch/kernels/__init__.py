"""Hand-written CUDA kernels for the aggregation hot spot, each beside its
plain PyTorch version (see ops.py for the dispatch contract).

The package re-exports the reference's names (``repro.kernels``), so
``krum``, ``centered_clip``, ``clipped_diff``, ``geometric_median`` and
``coordinate_median`` here are the functions; their modules are reached
by ``importlib.import_module("repro_torch.kernels.krum")`` (or
``from repro_torch.kernels.krum import ...``)."""
from .ops import (  # noqa: F401
    RowSelection,
    bucketed_coordinate_median,
    centered_clip,
    clip_then_aggregate,
    clip_then_centered_clip,
    clip_then_geometric_median,
    clip_then_krum,
    clipped_diff,
    coordinate_median,
    geometric_median,
    krum,
    krum_apply,
    krum_gram,
    krum_select_from_gram,
    launch_counts,
    multi_krum,
    reset_launch_counts,
    row_norms,
    select_row,
    trimmed_mean,
    weighted_row_sum,
)
