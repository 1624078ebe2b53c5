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
from . import coordinate_median as _cm
from . import geometric_median as _gm
from .centered_clip import bucket_means_tiled, diff_row_ssq  # noqa: F401
from .clip_aggregate import clip_then_aggregate, row_norms  # noqa: F401
from .geometric_median import (  # noqa: F401
    clip_then_geometric_median,
    geometric_median,
)

__all__ = ["coordinate_median", "trimmed_mean", "clip_then_aggregate",
           "row_norms", "clip_then_geometric_median", "geometric_median",
           "diff_row_ssq", "bucket_means_tiled", "launch_counts",
           "reset_launch_counts"]

_COUNTERS = (_ca.LAUNCHES, _cm.LAUNCHES, _cc.LAUNCHES, _gm.LAUNCHES)


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
