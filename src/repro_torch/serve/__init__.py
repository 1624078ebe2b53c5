"""Streaming cohort ingestion: a continuous-batching aggregation service
on top of :class:`repro_torch.api.ServerPlan`, the ported part of
``repro.serve``.

- :mod:`repro_torch.serve.cohort`: per-round cohort assembly on the
  device (chunked ingest, the incremental Gram of the selection rules,
  the per-plan executor cache);
- :mod:`repro_torch.serve.server`: the request-queue -> plan-executor ->
  response-fan-out loop with cohort-size and deadline triggers, the
  stale-row and duplicate policies, ingest validation, per-slot
  quarantine, the clipping-only fallback close and per-round counters.

The fault injector, recovery and checkpoints are not ported yet (ROADMAP
queue 1, "serve faults, recovery and checkpoints").
The CLI entry point is ``python -m repro_torch.launch.serve --mode
stream``.
"""
from .cohort import (  # noqa: F401
    CohortBuilder,
    PlanExecutor,
    executor_cache_clear,
    executor_cache_info,
    get_executor,
    validate_serve_plan,
)
from .server import (  # noqa: F401
    AggregationServer,
    RoundResult,
    RowError,
    ServeConfig,
    ServeMetrics,
    Ticket,
    round_key,
)
