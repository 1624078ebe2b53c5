"""The declarative server-step API (``ServerPlan``)."""
from .plan import (  # noqa: F401
    PLAN_VERSION,
    AggregatorSpec,
    BucketSpec,
    ClipSpec,
    CompressSpec,
    PlanError,
    PlanWarning,
    ScheduleSpec,
    ServerPlan,
    ServerStep,
)
