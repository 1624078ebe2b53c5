"""The continuous-batching aggregation server, the counterpart of
``repro.serve.server``.

Request queue -> plan executor -> response fan-out:

- clients ``submit(slot, row)`` and get back a :class:`Ticket`;
- ``pump()`` drains the queue into the current round's
  :class:`~repro_torch.serve.cohort.CohortBuilder` (chunked ingest, each
  chunk copied to the device once) and closes the round when a trigger
  fires:
  ``cohort_size`` distinct rows arrived, or ``deadline`` seconds
  elapsed since the round opened (with at least one row);
- closing resolves every ticket of the round with the same
  :class:`RoundResult` (the aggregate is computed once and fanned out).

Rows that arrive for an already-closed round are STALE.  Policy
``"drop"`` rejects them (the ticket resolves unfulfilled); ``"defer"``
folds them into the current round scaled by
``stale_discount ** staleness`` — the delayed-momentum heuristic: a
late update still carries signal, but geometrically less of it the
longer it sat in flight.

The clock is injectable (``clock=``) so deadline behaviour is exactly
testable; ``pump()`` is synchronous — a driving loop (or test) decides
when work happens, and per-round counters (:class:`ServeMetrics`) make
the behaviour observable without logs.

Graceful degradation (the server assumes a HOSTILE world, matching the
paper's threat model at the infrastructure level):

- **ingest-time validation** — a wrong-shape or non-finite row resolves
  its ticket with a structured :class:`RowError` instead of poisoning
  the cohort buffer / incremental Gram;
- **per-slot quarantine** — ``quarantine_after`` rejected rows in a row
  quarantines the slot for ``quarantine_rounds`` rounds, doubling per
  repeat offense up to ``quarantine_cap`` (bounded backoff);
- **duplicate policy** — a second row for an already-arrived slot
  follows ``duplicate_policy``: ``last_wins`` (overwrite, the
  continuous-batching default), ``first_wins`` (ignore the retry — any
  interleaving of duplicated wire batches then closes like the in-order
  stream), or ``reject`` (resolve the retry's ticket with an error);
- **underfull fallback** — a deadline close with fewer than
  ``min_fill`` rows, an executor exception, or a non-finite aggregate
  closes the round with the clipping-only heuristic aggregate (mean of
  the statically clipped arrived rows — the paper's safety net: clipping
  alone bounds the harm of any round) and ``RoundResult.degraded=True``.
  A closed round therefore ALWAYS carries a finite aggregate.  A kernel
  that does not build or launch (``KernelError``) or a CUDA error is a
  fault of the server, not of the round: it propagates out of ``pump()``
  and is never hidden behind the fallback.

``on_close(result, state)``, when given, sees every closed round with the
streaming state it was computed from (buffer, arrived mask, stats) before
the next round opens: an audit hook, e.g. to hold a close against the
plan's one-shot step.

The server runs on the card unless the caller passes ``device="cpu"``.
A round's Bucketing order comes from :func:`round_key`, a
``torch.Generator`` seeded from (``seed``, round id), so a server
restored from a snapshot (:mod:`repro_torch.serve.recovery`) needs no
generator state.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..api import ServerPlan
from ..core.clipping import clip_rows
from ..kernels._build import KernelError
from .cohort import CohortBuilder, PlanExecutor

__all__ = ["AggregationServer", "RoundResult", "RowError", "ServeConfig",
           "ServeMetrics", "Ticket", "round_key"]

_STALE_POLICIES = ("drop", "defer")
_DUPLICATE_POLICIES = ("first_wins", "last_wins", "reject")
# errors the close never degrades on: faults of the kernels or the card
_DEVICE_FAULTS = (KernelError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def round_key(seed: int, round_id: int) -> torch.Generator:
    """A fresh CPU ``torch.Generator`` for round ``round_id`` of a server
    seeded ``seed``: Bucketing's row order of that round."""
    state = np.random.SeedSequence([int(seed), int(round_id)])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Geometry and scheduling knobs of one aggregation service.

    ``cohort_size`` — close the round once this many DISTINCT slots have
    a row (default: every slot, i.e. ``n_slots``).
    ``deadline`` — close a non-empty round this many seconds after it
    opened, even if underfull (None: no deadline; the round waits).
    ``stale_policy`` / ``stale_discount`` — see the module docstring.
    ``chunk_size`` — the most rows one ingest step folds in (one
    cross-Gram launch per chunk for the selection rules).
    ``duplicate_policy`` — what a second row for an already-arrived slot
    does to the round: ``last_wins`` / ``first_wins`` / ``reject``.
    ``min_fill`` — a deadline close below this fill degrades to the
    clipping-only fallback aggregate (1: any non-empty round runs the
    full rule, the pre-fault-tolerance behaviour).
    ``quarantine_after`` — consecutive rejected rows before a slot is
    quarantined (0 disables quarantine); ``quarantine_rounds`` is the
    first quarantine span in rounds, doubled per repeat offense and
    capped at ``quarantine_cap`` (bounded backoff).
    """

    n_slots: int
    dim: int
    cohort_size: Optional[int] = None
    deadline: Optional[float] = None
    stale_policy: str = "drop"
    stale_discount: float = 0.5
    chunk_size: int = 8
    seed: int = 0
    duplicate_policy: str = "last_wins"
    min_fill: int = 1
    quarantine_after: int = 3
    quarantine_rounds: int = 1
    quarantine_cap: int = 8

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1; got {self.n_slots}")
        if self.dim < 1:
            raise ValueError(f"dim must be >= 1; got {self.dim}")
        cs = self.resolved_cohort_size
        if not 1 <= cs <= self.n_slots:
            raise ValueError(
                f"cohort_size must lie in [1, n_slots={self.n_slots}]; "
                f"got {cs}"
            )
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline must be > 0; got {self.deadline}")
        if self.stale_policy not in _STALE_POLICIES:
            raise ValueError(
                f"unknown stale_policy {self.stale_policy!r}; have "
                f"{_STALE_POLICIES}"
            )
        if not 0.0 < self.stale_discount <= 1.0:
            raise ValueError(
                f"stale_discount must lie in (0, 1]; got "
                f"{self.stale_discount}"
            )
        if self.chunk_size < 1:
            raise ValueError(
                f"chunk_size must be >= 1; got {self.chunk_size}"
            )
        if self.duplicate_policy not in _DUPLICATE_POLICIES:
            raise ValueError(
                f"unknown duplicate_policy {self.duplicate_policy!r}; "
                f"have {_DUPLICATE_POLICIES}"
            )
        if not 1 <= self.min_fill <= self.n_slots:
            raise ValueError(
                f"min_fill must lie in [1, n_slots={self.n_slots}]; got "
                f"{self.min_fill}"
            )
        if self.quarantine_after < 0:
            raise ValueError(
                f"quarantine_after must be >= 0 (0 disables quarantine); "
                f"got {self.quarantine_after}"
            )
        if self.quarantine_rounds < 1:
            raise ValueError(
                f"quarantine_rounds must be >= 1; got "
                f"{self.quarantine_rounds}"
            )
        if self.quarantine_cap < self.quarantine_rounds:
            raise ValueError(
                f"quarantine_cap must be >= quarantine_rounds="
                f"{self.quarantine_rounds}; got {self.quarantine_cap}"
            )

    @property
    def resolved_cohort_size(self) -> int:
        return self.n_slots if self.cohort_size is None else self.cohort_size


@dataclasses.dataclass
class RowError:
    """Structured rejection attached to a ticket that never made it into
    a cohort.  ``code`` is machine-checkable:

      wrong_shape      row is not a finite-width (dim,) float vector
      non_finite       row carries NaN/Inf coordinates
      bad_slot         slot id outside [0, n_slots)
      duplicate        slot already arrived this round (policy 'reject')
      quarantined      slot is serving a quarantine backoff
      stale_underflow  defer weight underflowed to zero (row too stale
                       to carry any signal)
    """

    code: str
    detail: str
    slot: int
    round_id: Optional[int] = None


@dataclasses.dataclass
class RoundResult:
    """What every ticket of a closed round resolves to.

    ``degraded=True`` marks a round closed by the clipping-only fallback
    (underfull deadline close, executor fault, or a non-finite full-rule
    aggregate); ``fallback_reason`` says which.  The aggregate of a
    closed round is always finite."""

    round_id: int
    aggregate: np.ndarray
    cohort_fill: int
    close_reason: str  # "fill" | "deadline"
    latency: float  # seconds from round open to close
    degraded: bool = False
    fallback_reason: Optional[str] = None


@dataclasses.dataclass
class Ticket:
    """A submitted row's handle.  ``status`` moves queued -> ingested ->
    done (round closed), or to dropped_stale / deferred for late rows,
    duplicate for a first-wins retry, or rejected (see ``error``)."""

    round_id: int  # the round the row was INGESTED into (or targeted)
    slot: int
    status: str = "queued"
    result: Optional[RoundResult] = None
    submitted_at: float = 0.0
    resolved_at: float = 0.0
    error: Optional[RowError] = None

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-resolution seconds (None while pending)."""
        if (self.result is None
                and self.status not in ("dropped_stale", "rejected")):
            return None
        return self.resolved_at - self.submitted_at


@dataclasses.dataclass
class ServeMetrics:
    """Per-server counters; ``snapshot()`` is the observability surface."""

    rows_ingested: int = 0
    chunks_ingested: int = 0
    rows_dropped_stale: int = 0
    rows_deferred: int = 0
    rounds_closed: int = 0
    closes_by_fill: int = 0
    closes_by_deadline: int = 0
    last_cohort_fill: int = 0
    last_round_latency: float = 0.0
    max_queue_depth: int = 0
    queue_depth: int = 0
    rows_rejected: int = 0
    rows_quarantined: int = 0
    quarantines: int = 0
    rounds_degraded: int = 0
    executor_faults: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Pending:
    slot: int
    row: np.ndarray
    round_id: Optional[int]  # None: whichever round ingests it
    ticket: Ticket


class AggregationServer:
    """One served plan + one cohort geometry on one device (the card
    unless ``device="cpu"``); see the module docstring."""

    def __init__(self, plan: ServerPlan, config: ServeConfig, *,
                 clock: Optional[Callable[[], float]] = None, device=None,
                 on_close: Optional[Callable] = None):
        self.plan = plan
        self.config = config
        self.device = resolve_device(device)
        self.metrics = ServeMetrics()
        self._clock = clock or time.monotonic
        self._on_close = on_close
        self._builder = CohortBuilder(
            plan, config.n_slots, config.dim, chunk_size=config.chunk_size,
            device=self.device)
        self._queue: deque[_Pending] = deque()
        self._round_id = 0
        self._round_opened_at = self._clock()
        self._round_tickets: list[Ticket] = []
        # host-side mirror of the builder's arrived mask: lets the pump
        # stop a wire batch exactly at the round boundary (rows beyond
        # the cohort trigger roll into the NEXT round) without a device
        # round-trip per row
        self._arrived_slots: set[int] = set()
        # per-slot quarantine bookkeeping: consecutive rejects, current
        # backoff exponent, and the first round the slot is heard again
        self._strikes: dict[int, int] = {}
        self._quarantine_level: dict[int, int] = {}
        self._quarantine_until: dict[int, int] = {}

    # -- request side --------------------------------------------------------

    @property
    def round_id(self) -> int:
        return self._round_id

    @property
    def executor(self) -> PlanExecutor:
        """The shared plan executor this server's rounds run on."""
        return self._builder.executor

    def quarantined_until(self, slot: int) -> Optional[int]:
        """First round id that will hear ``slot`` again (None: not
        quarantined)."""
        until = self._quarantine_until.get(int(slot))
        return until if until is not None and until > self._round_id else None

    def _reject(self, t: Ticket, code: str, detail: str, *,
                quarantined: bool = False) -> Ticket:
        t.status = "rejected"
        t.error = RowError(code=code, detail=detail, slot=t.slot,
                           round_id=t.round_id)
        t.resolved_at = self._clock()
        self.metrics.rows_rejected += 1
        if quarantined:
            self.metrics.rows_quarantined += 1
        return t

    def _strike(self, slot: int) -> None:
        """One more bad submission from ``slot``; quarantine with bounded
        exponential backoff once the strike budget is spent."""
        cfg = self.config
        if cfg.quarantine_after <= 0:
            return
        strikes = self._strikes.get(slot, 0) + 1
        self._strikes[slot] = strikes
        if strikes < cfg.quarantine_after:
            return
        level = self._quarantine_level.get(slot, 0)
        span = min(cfg.quarantine_rounds * (2 ** level), cfg.quarantine_cap)
        self._quarantine_until[slot] = self._round_id + span
        self._quarantine_level[slot] = level + 1
        self._strikes[slot] = 0
        self.metrics.quarantines += 1

    def submit(self, slot: int, row, round_id: Optional[int] = None) -> Ticket:
        """Enqueue one client row.  Returns the ticket the round's result
        fans out to.

        ``round_id=None`` (the continuous-batching default) means
        "whichever round ingests it": a backlogged row rolls into a
        later round instead of going stale.  An explicit ``round_id``
        pins the row to that round — arriving after it closed makes the
        row STALE and subject to the configured stale policy.

        Malformed input never raises past this point: a wrong-shape /
        non-finite row (or one from a quarantined or out-of-range slot)
        returns a ``rejected`` ticket with a structured ``error`` and is
        never ingested — the cohort buffer and the incremental Gram only
        ever see validated rows."""
        cfg = self.config
        try:
            slot = int(slot)
        except (TypeError, ValueError):
            return self._reject(
                Ticket(round_id=self._round_id, slot=-1,
                       submitted_at=self._clock()),
                "bad_slot", f"slot id {slot!r} is not an integer",
            )
        target = round_id if round_id is None else int(round_id)
        if target is not None and target > self._round_id:
            raise ValueError(
                f"round {target} has not opened yet (current round is "
                f"{self._round_id})"
            )
        t = Ticket(round_id=self._round_id if target is None else target,
                   slot=slot, submitted_at=self._clock())
        if not 0 <= slot < cfg.n_slots:
            return self._reject(
                t, "bad_slot",
                f"slot {slot} outside [0, {cfg.n_slots})",
            )
        until = self.quarantined_until(slot)
        if until is not None:
            return self._reject(
                t, "quarantined",
                f"slot {slot} is quarantined until round {until}",
                quarantined=True,
            )
        try:
            arr = np.asarray(row, dtype=np.float32)
        except (TypeError, ValueError) as e:
            self._strike(slot)
            return self._reject(
                t, "wrong_shape", f"row does not coerce to float32 ({e})"
            )
        if arr.shape != (cfg.dim,):
            self._strike(slot)
            return self._reject(
                t, "wrong_shape",
                f"row shape {arr.shape} != ({cfg.dim},)",
            )
        if not np.all(np.isfinite(arr)):
            self._strike(slot)
            return self._reject(
                t, "non_finite",
                "row carries NaN/Inf coordinates",
            )
        self._strikes[slot] = 0  # an accepted row clears the strike count
        self._queue.append(_Pending(slot, arr, target, t))
        self.metrics.queue_depth = len(self._queue)
        self.metrics.max_queue_depth = max(
            self.metrics.max_queue_depth, len(self._queue)
        )
        return t

    # -- serve loop ----------------------------------------------------------

    def pump(self) -> list[RoundResult]:
        """Drain the queue, fire any due trigger; returns the rounds
        closed by this call (usually 0 or 1, more under backlog)."""
        closed: list[RoundResult] = []
        cfg = self.config
        while self._queue:
            batch_rows, batch_ids = [], []
            while self._queue:
                p = self._queue.popleft()
                if p.round_id is None:
                    p.ticket.round_id = self._round_id
                staleness = (
                    0 if p.round_id is None else self._round_id - p.round_id
                )
                if staleness > 0:
                    if cfg.stale_policy == "drop":
                        self.metrics.rows_dropped_stale += 1
                        p.ticket.status = "dropped_stale"
                        p.ticket.resolved_at = self._clock()
                        continue
                    # defer: fold into the CURRENT round, geometrically
                    # discounted by how many rounds the row missed.  The
                    # weight can underflow to exactly 0.0 for extreme
                    # staleness / tiny discounts — folding a zero row in
                    # would mark the slot arrived while contributing
                    # nothing, distorting coordinate-wise rules, so a
                    # vanished weight degrades to a drop instead.
                    weight = cfg.stale_discount ** staleness
                    if not np.isfinite(weight) or weight <= 0.0:
                        self.metrics.rows_dropped_stale += 1
                        p.ticket.status = "dropped_stale"
                        p.ticket.error = RowError(
                            code="stale_underflow",
                            detail=(
                                f"defer weight {cfg.stale_discount}**"
                                f"{staleness} underflowed to zero"
                            ),
                            slot=p.slot, round_id=p.round_id,
                        )
                        p.ticket.resolved_at = self._clock()
                        continue
                    p.row = p.row * weight
                    self.metrics.rows_deferred += 1
                    p.ticket.status = "deferred"
                if p.slot in self._arrived_slots:
                    # a second row for an already-arrived slot: the
                    # duplicate policy decides whether the retry
                    # overwrites, is ignored, or is an error
                    if cfg.duplicate_policy == "reject":
                        self.metrics.rows_rejected += 1
                        p.ticket.status = "rejected"
                        p.ticket.error = RowError(
                            code="duplicate",
                            detail=(
                                f"slot {p.slot} already arrived in round "
                                f"{self._round_id}"
                            ),
                            slot=p.slot, round_id=self._round_id,
                        )
                        p.ticket.resolved_at = self._clock()
                        continue
                    if cfg.duplicate_policy == "first_wins":
                        # ignore the retry's payload; the ticket still
                        # resolves with the round its slot is part of
                        p.ticket.status = "duplicate"
                        self._round_tickets.append(p.ticket)
                        continue
                batch_rows.append(p.row)
                batch_ids.append(p.slot)
                self._round_tickets.append(p.ticket)
                self._arrived_slots.add(p.slot)
                if len(batch_rows) == cfg.chunk_size:
                    break
                if len(self._arrived_slots) >= cfg.resolved_cohort_size:
                    # the round is full: leave the rest of the queue for
                    # the next round instead of overfilling this one
                    break
            if batch_rows:
                self.metrics.chunks_ingested += self._builder.ingest(
                    np.stack(batch_rows), np.asarray(batch_ids)
                )
                self.metrics.rows_ingested += len(batch_rows)
                for t in self._round_tickets[-len(batch_rows):]:
                    if t.status == "queued":
                        t.status = "ingested"
            self.metrics.queue_depth = len(self._queue)
            if len(self._arrived_slots) >= cfg.resolved_cohort_size:
                closed.append(self._close_round("fill"))
        result = self._maybe_deadline_close()
        if result is not None:
            closed.append(result)
        return closed

    def _maybe_deadline_close(self) -> Optional[RoundResult]:
        cfg = self.config
        if cfg.deadline is None:
            return None
        if self._clock() - self._round_opened_at < cfg.deadline:
            return None
        if not self._arrived_slots:
            # nothing arrived: an empty round has no aggregate — re-arm
            # instead of fanning out a degenerate result
            self._round_opened_at = self._clock()
            return None
        return self._close_round("deadline")

    def _fallback_aggregate(self) -> np.ndarray:
        """The clipping-only heuristic aggregate — the paper's safety
        net: clip every arrived row to the plan's static radius (rows
        pass through unclipped for plans without one) and average, on
        the buffer's device.  Plain torch ops on validated-finite rows,
        so it is deterministic, always finite, and independent of the
        (possibly faulted) plan executor."""
        rows = self._builder.buffer[self._builder.arrived]
        if rows.shape[0] == 0:
            return np.zeros((self.config.dim,), np.float32)
        clip = self.plan.clip
        if clip is not None and clip.radius is not None:
            rows = clip_rows(rows, clip.radius)
        return rows.mean(dim=0).cpu().numpy()

    def _close_round(self, reason: str) -> RoundResult:
        now = self._clock()
        cfg = self.config
        fill = len(self._arrived_slots)
        key = round_key(cfg.seed, self._round_id)
        aggregate, degraded, fallback_reason = None, False, None
        if reason == "deadline" and fill < cfg.min_fill:
            # starved round: the full rule has too few rows to offer its
            # robustness guarantee — close with the clipping-only
            # heuristic instead of fanning out a fragile aggregate
            degraded, fallback_reason = True, "underfull"
        else:
            try:
                aggregate = self._builder.close(key).cpu().numpy()
                if not np.all(np.isfinite(aggregate)):
                    aggregate = None
                    degraded, fallback_reason = True, "non_finite"
            except _DEVICE_FAULTS:
                raise
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                self.metrics.executor_faults += 1
                degraded = True
                fallback_reason = f"executor_error:{type(e).__name__}"
        if aggregate is None:
            aggregate = self._fallback_aggregate()
        result = RoundResult(
            round_id=self._round_id,
            aggregate=aggregate,
            cohort_fill=fill,
            close_reason=reason,
            latency=max(0.0, now - self._round_opened_at),
            degraded=degraded,
            fallback_reason=fallback_reason,
        )
        for t in self._round_tickets:
            t.result = result
            t.resolved_at = now
            if t.status in ("queued", "ingested"):
                t.status = "done"
        m = self.metrics
        m.rounds_closed += 1
        m.closes_by_fill += reason == "fill"
        m.closes_by_deadline += reason == "deadline"
        m.rounds_degraded += degraded
        m.last_cohort_fill = result.cohort_fill
        m.last_round_latency = result.latency
        if self._on_close is not None:
            self._on_close(result, self._builder.state())
        self._round_tickets = []
        self._arrived_slots = set()
        self._round_id += 1
        self._round_opened_at = now
        self._builder.reset()
        return result
