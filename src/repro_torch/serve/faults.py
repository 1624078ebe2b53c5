"""Deterministic fault injection for the streaming aggregation server, the
counterpart of ``repro.serve.faults``.

A :class:`FaultPlan` is a frozen, seeded, JSON-serializable description
of the infrastructure faults to inject (the same version-1 document the
reference reads), and a :class:`FaultInjector` wraps an
:class:`~repro_torch.serve.server.AggregationServer` to apply them
between the clients and the server:

- **dropout**: a submission is lost on the wire;
- **delay / reorder**: a submission is held back for a random number of
  pumps and released later, in shuffled order;
- **duplicate / conflict**: a client retries its submission; a
  conflicting retry carries a different payload;
- **nan_payload / wrong_shape**: malformed rows (NaN/Inf coordinates,
  truncated or extended vectors), which the server's validation rejects;
- **clock_skew**: the server's clock jitters by up to ``clock_skew``
  seconds per reading;
- **executor_crash**: the round close raises :class:`InjectedFault`,
  which the server degrades to its clipping-only fallback close.  An
  injected crash is not one of the server's device faults: a
  ``KernelError`` or a CUDA error still propagates out of ``pump()``.

Every decision comes from three ``numpy.RandomState`` streams seeded from
``FaultPlan.seed`` (wire faults, crashes, clock skew), drawn in the
reference's order, so the same plan driven by the same submissions fires
the same faults in both packages: a failing chaos run is an exact repro,
shareable as one JSON document (``--fault-json`` on
``repro_torch.launch.serve``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from .server import AggregationServer, RoundResult, Ticket

__all__ = [
    "FaultPlan",
    "FaultInjector",
    "InjectedFault",
    "canonical_fault_plan",
    "load_fault_plan",
]

FAULT_PLAN_VERSION = 1


class InjectedFault(RuntimeError):
    """The failure raised by fault-plan executor crashes."""


_PROB_FIELDS = ("dropout", "delay", "duplicate", "conflict", "nan_payload",
                "wrong_shape", "executor_crash")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One replayable chaos scenario (see the module docstring).

    The fields in ``_PROB_FIELDS`` are per-event probabilities in [0, 1];
    ``conflict`` is conditional on ``duplicate`` firing.
    ``max_delay_pumps`` bounds how many pumps a held-back row waits;
    ``clock_skew`` is the clock jitter amplitude in seconds.
    """

    seed: int = 0
    dropout: float = 0.0
    delay: float = 0.0
    max_delay_pumps: int = 3
    duplicate: float = 0.0
    conflict: float = 0.0
    nan_payload: float = 0.0
    wrong_shape: float = 0.0
    clock_skew: float = 0.0
    executor_crash: float = 0.0

    def __post_init__(self):
        for name in _PROB_FIELDS:
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"FaultPlan.{name} is a probability in [0, 1]; got {v}")
        if self.max_delay_pumps < 1:
            raise ValueError(
                f"max_delay_pumps must be >= 1; got {self.max_delay_pumps}")
        if self.clock_skew < 0.0:
            raise ValueError(
                f"clock_skew must be >= 0 seconds; got {self.clock_skew}")

    @property
    def active(self) -> bool:
        """True when any fault can actually fire."""
        return any(getattr(self, f) > 0 for f in _PROB_FIELDS) \
            or self.clock_skew > 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = FAULT_PLAN_VERSION
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        d = dict(d)
        version = d.pop("version", FAULT_PLAN_VERSION)
        if version != FAULT_PLAN_VERSION:
            raise ValueError(
                f"unsupported fault-plan version {version!r}; this reader "
                f"understands version {FAULT_PLAN_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown fault-plan fields {sorted(unknown)}; "
                             f"have {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s) -> "FaultPlan":
        try:
            d = json.loads(s) if isinstance(s, (str, bytes)) else dict(s)
        except (json.JSONDecodeError, TypeError) as e:
            raise ValueError(f"not a fault-plan JSON document: {e}") from e
        return cls.from_dict(d)


def canonical_fault_plan(seed: int = 0) -> FaultPlan:
    """The reference chaos scenario (``benchmarks/fault_canonical.json``):
    20% dropout, ~10% malformed rows (NaN/Inf and wrong shape), duplicates
    and conflicts, and delivery delay."""
    return FaultPlan(seed=seed, dropout=0.20, delay=0.15, max_delay_pumps=3,
                     duplicate=0.20, conflict=0.25, nan_payload=0.05,
                     wrong_shape=0.05, executor_crash=0.0)


def load_fault_plan(doc: str) -> Optional[FaultPlan]:
    """Parse a ``--fault-json`` value: inline JSON or a path to a JSON
    file; '' or None disable fault injection (returns None)."""
    if not doc:
        return None
    if os.path.exists(doc):
        with open(doc) as f:
            doc = f.read()
    return FaultPlan.from_json(doc)


@dataclasses.dataclass
class FaultStats:
    """What the injector actually did."""

    submitted: int = 0
    dropped: int = 0
    delayed: int = 0
    released: int = 0
    duplicated: int = 0
    conflicting: int = 0
    nan_poisoned: int = 0
    reshaped: int = 0
    executor_crashes: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class FaultInjector:
    """Chaos middleware between clients and one server.

    Drive it like the server, ``submit(slot, row)`` / ``pump()``, and it
    perturbs the stream per its :class:`FaultPlan`: ``submit`` returns the
    tickets that reached the server now (none under dropout or delay, two
    under duplication), ``pump`` first releases the held-back rows that
    are due, in shuffled order.  Construction installs the clock-skew
    hook on ``server._clock`` and the executor-crash hook on
    ``server._builder.close``.
    """

    def __init__(self, plan: FaultPlan, server: AggregationServer):
        self.plan = plan
        self.server = server
        self.stats = FaultStats()
        # independent streams, so that e.g. enabling executor crashes does
        # not shift the wire-level fault sequence
        self._rng = np.random.RandomState(plan.seed)
        self._crash_rng = np.random.RandomState(plan.seed + 0x5EED)
        self._skew_rng = np.random.RandomState(plan.seed + 0xC10C)
        self._pump_count = 0
        # (release_at_pump, slot, row, round_id) held-back submissions
        self._held: list[tuple[int, int, np.ndarray, Optional[int]]] = []
        self._install_hooks()

    def _install_hooks(self) -> None:
        plan, server = self.plan, self.server
        if plan.clock_skew > 0:
            base = server._clock
            skew, rng = plan.clock_skew, self._skew_rng

            def skewed_clock():
                return base() + rng.uniform(-skew, skew)

            server._clock = skewed_clock
        if plan.executor_crash > 0:
            builder = server._builder
            orig_close = builder.close
            crash_rng, stats = self._crash_rng, self.stats

            def crashing_close(key=None):
                if crash_rng.random_sample() < plan.executor_crash:
                    stats.executor_crashes += 1
                    raise InjectedFault(
                        "fault-plan executor crash at round close")
                return orig_close(key)

            builder.close = crashing_close

    def _corrupt(self, row: np.ndarray) -> np.ndarray:
        """Maybe replace the payload with a malformed variant."""
        rng, plan = self._rng, self.plan
        row = np.asarray(row, np.float32)
        if rng.random_sample() < plan.nan_payload:
            self.stats.nan_poisoned += 1
            bad = row.copy()
            idx = rng.randint(0, max(1, bad.size), size=max(1, bad.size // 8))
            bad.flat[idx] = np.float32(np.nan)
            bad.flat[idx[:1]] = np.float32(np.inf)
            return bad
        if rng.random_sample() < plan.wrong_shape:
            self.stats.reshaped += 1
            if rng.random_sample() < 0.5 and row.size > 1:
                return row[: max(1, row.size // 2)]  # truncated on the wire
            return np.concatenate([row, row[:1]])  # trailing garbage
        return row

    def _conflicting_payload(self, row: np.ndarray) -> np.ndarray:
        """A duplicate that disagrees with the original submission."""
        noise = self._rng.randn(*np.shape(row)).astype(np.float32)
        return np.asarray(row, np.float32) + noise

    def submit(self, slot: int, row,
               round_id: Optional[int] = None) -> list[Ticket]:
        """Submit one logical client row through the fault plan.  Returns
        the tickets that reached the server now (held-back rows surface
        at a later ``pump``)."""
        rng, plan = self._rng, self.plan
        self.stats.submitted += 1
        if rng.random_sample() < plan.dropout:
            self.stats.dropped += 1
            return []
        payload = self._corrupt(row)
        tickets: list[Ticket] = []
        if rng.random_sample() < plan.delay:
            release = self._pump_count + rng.randint(1,
                                                     plan.max_delay_pumps + 1)
            self._held.append((release, int(slot), payload, round_id))
            self.stats.delayed += 1
        else:
            tickets.append(self.server.submit(slot, payload, round_id))
        if rng.random_sample() < plan.duplicate:
            self.stats.duplicated += 1
            dup = payload
            if rng.random_sample() < plan.conflict:
                self.stats.conflicting += 1
                dup = self._conflicting_payload(payload)
            tickets.append(self.server.submit(slot, dup, round_id))
        return tickets

    def pump(self) -> list[RoundResult]:
        """Release the due held-back rows (shuffled: reordering), then
        pump the wrapped server."""
        self._pump_count += 1
        if self._held:
            due = [h for h in self._held if h[0] <= self._pump_count]
            if due:
                self._held = [h for h in self._held
                              if h[0] > self._pump_count]
                self._rng.shuffle(due)
                for _, slot, row, round_id in due:
                    self.server.submit(slot, row, round_id)
                    self.stats.released += 1
        return self.server.pump()

    def flush(self) -> list[Ticket]:
        """Force-deliver every still-held row (end-of-run drain)."""
        held, self._held = self._held, []
        out = []
        for _, slot, row, round_id in held:
            out.append(self.server.submit(slot, row, round_id))
            self.stats.released += 1
        return out

    @property
    def metrics(self):
        return self.server.metrics

    @property
    def round_id(self) -> int:
        return self.server.round_id
