"""Hand-written CUDA kernels for the aggregation hot spot, each beside its
plain PyTorch version (see ops.py for the dispatch contract)."""
from .ops import (  # noqa: F401
    clip_then_aggregate,
    clip_then_geometric_median,
    coordinate_median,
    launch_counts,
    reset_launch_counts,
    row_norms,
    trimmed_mean,
)
