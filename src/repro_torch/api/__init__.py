"""The declarative server-step API (``ServerPlan``) and the adversarial
scenario beside it (``ScenarioSpec``)."""
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
from .scenario import ADAPTIVE_ATTACKS, ScenarioSpec  # noqa: F401
