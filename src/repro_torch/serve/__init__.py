"""Streaming cohort ingestion: a continuous-batching aggregation service
on top of :class:`repro_torch.api.ServerPlan`, the counterpart of
``repro.serve``.

- :mod:`repro_torch.serve.cohort`: per-round cohort assembly on the
  device (chunked ingest, the incremental Gram of the selection rules,
  the per-plan executor cache);
- :mod:`repro_torch.serve.server`: the request-queue -> plan-executor ->
  response-fan-out loop with cohort-size and deadline triggers, the
  stale-row and duplicate policies, ingest validation, per-slot
  quarantine, the clipping-only fallback close and per-round counters;
- :mod:`repro_torch.serve.faults`: the deterministic, JSON-replayable
  fault injector (:class:`FaultPlan`, :class:`FaultInjector`);
- :mod:`repro_torch.serve.recovery`: crash-safe checkpoint and resume of
  the full mid-stream server state through ``repro_torch.checkpoint``.

The CLI entry point is ``python -m repro_torch.launch.serve --mode
stream`` (``--fault-json`` injects a fault plan, ``--ckpt-dir`` and
``--resume`` survive a SIGKILL).
"""
from .cohort import (  # noqa: F401
    CohortBuilder,
    PlanExecutor,
    executor_cache_clear,
    executor_cache_info,
    get_executor,
    validate_serve_plan,
)
from .faults import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    InjectedFault,
    canonical_fault_plan,
    load_fault_plan,
)
from .recovery import (  # noqa: F401
    ServerCheckpointer,
    restore_server,
    save_server,
    server_state,
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

__all__ = [
    "AggregationServer",
    "CohortBuilder",
    "FaultInjector",
    "FaultPlan",
    "InjectedFault",
    "PlanExecutor",
    "RoundResult",
    "RowError",
    "ServeConfig",
    "ServeMetrics",
    "ServerCheckpointer",
    "Ticket",
    "canonical_fault_plan",
    "executor_cache_clear",
    "executor_cache_info",
    "get_executor",
    "load_fault_plan",
    "restore_server",
    "round_key",
    "save_server",
    "server_state",
    "validate_serve_plan",
]
