"""PyTorch/CUDA port of the Byz-VR-MARINA-PP reproduction.

The JAX package ``repro`` is the reference; this package keeps its layout
and names.  Its entry points run on the card (``device=None`` means
"cuda") and raise where there is none, unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.

The ServerPlan surface is re-exported here lazily, as ``repro`` does it,
so ``import repro_torch`` imports nothing further until a name is used.
"""

__version__ = "1.1.0"

# the public ServerPlan surface, lazily resolved from repro_torch.api
_API_EXPORTS = (
    "ServerPlan",
    "ServerStep",
    "ClipSpec",
    "CompressSpec",
    "BucketSpec",
    "AggregatorSpec",
    "ScenarioSpec",
    "ScheduleSpec",
    "PlanError",
    "PlanWarning",
    "PLAN_VERSION",
)

__all__ = ["__version__", *_API_EXPORTS]


def __getattr__(name):
    if name in _API_EXPORTS:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API_EXPORTS))
