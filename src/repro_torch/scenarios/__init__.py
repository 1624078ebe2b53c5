"""The adversarial scenario engine, the counterpart of
``repro.scenarios``:

- :mod:`repro_torch.scenarios.stage`: the attack stage (``make_context``,
  ``AttackStage`` over the engines' (n, d) message matrix,
  ``TreeAttackStage`` over the mesh trainer's worker-stacked tree, and
  the host-side ``SyntheticCohort`` of the streaming server);
- :mod:`repro_torch.scenarios.adaptive`: the gradient-ascent adversary
  against the differentiable view of a ``ServerPlan`` (plain rules
  directly, the CUDA kernels through a ``torch.autograd.Function`` with
  the plain shadow's backward), with a step budget;
- :mod:`repro_torch.scenarios.matrix`: the resilience matrix, attack x
  rule x clip x participation x byzantine fraction reduced to
  breakdown points.

Scenarios are declared with :class:`repro_torch.api.ScenarioSpec` and
consumed by both engines, the mesh trainer and the streaming launcher.
"""
from .adaptive import (  # noqa: F401
    ADAPTIVE_OBJECTIVES,
    differentiable_aggregate,
    jnp_shadow_plan,
    make_adaptive_attack,
    torch_shadow_plan,
)
from .matrix import (  # noqa: F401
    SMOKE_GRID,
    MatrixGrid,
    append_resilience,
    breakdown_points,
    collect_resilience,
    run_cell,
)
from .stage import (  # noqa: F401
    AttackStage,
    SyntheticCohort,
    TreeAttackStage,
    make_context,
)

__all__ = [
    "ADAPTIVE_OBJECTIVES",
    "AttackStage",
    "MatrixGrid",
    "SMOKE_GRID",
    "SyntheticCohort",
    "TreeAttackStage",
    "append_resilience",
    "breakdown_points",
    "collect_resilience",
    "differentiable_aggregate",
    "jnp_shadow_plan",
    "make_adaptive_attack",
    "make_context",
    "run_cell",
    "torch_shadow_plan",
]
