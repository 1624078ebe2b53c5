"""Incremental cohort assembly for the streaming aggregation server, the
counterpart of ``repro.serve.cohort``.

One aggregation round collects up to ``n_slots`` client rows into an
``(n_slots, dim)`` buffer on the device.  Rows arrive in chunks of at most
``chunk_size``; each chunk is copied to the device once and folded in.

For the selection rules (krum / multi_krum) the expensive phase-1
statistic, the (n, n) Gram matrix, is kept up to date as rows arrive
(``Aggregator.update_stats``, one cross-Gram per chunk), so a round's
close is only the cheap ``finalize`` + ``apply_selection``.  The close is
BITWISE-equal to the plan's one-shot ``ServerStep`` on the assembled
buffer, on either device and backend: the one-shot Krum clips by the
norms on diag(G) of the raw rows (``krum_select_from_gram``), so the
builder accumulates the raw rows' Gram and hands the static radius to
``finalize``, the ops of the one-shot ``clip_then_krum``.  The Gram
kernels and their plain versions sum every entry in an order that
depends on the coordinate alone, so the merged cross-Grams equal the
one-shot Gram bit for bit; the chunk is embedded at full (n, dim) shape
to keep the operands those of the one-shot Gram.

Coordinate-wise and iterative rules have no deferred form: their close
is the plan's one-shot ``ServerStep`` over the buffer with the arrived
mask.

Serveable plans are the engine form: ``placement='naive'``, no
compression stage, and no clip or a static ``ClipSpec(radius=)``.
Executors are cached per (canonical plan JSON, n_slots, dim, chunk_size,
device), so servers sharing a plan share one executor.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .._device import resolve_device
from ..api import PlanError, ServerPlan

__all__ = ["CohortBuilder", "PlanExecutor", "executor_cache_info",
           "executor_cache_clear", "get_executor", "validate_serve_plan"]

F32 = torch.float32


def validate_serve_plan(plan: ServerPlan) -> None:
    """Raise PlanError unless ``plan`` can run inside the serve loop."""
    if plan.schedule.placement != "naive":
        raise PlanError(
            "the serve loop runs the single-process engine form: use "
            "placement='naive' (the sharded schedule needs a device mesh "
            "and the training launcher)")
    if plan.clip is not None and plan.clip.radius is None:
        raise PlanError(
            "a data-dependent ClipSpec(alpha=) radius needs the trainer's "
            "iterate pair; serveable plans use a static ClipSpec(radius=) "
            "or no clip stage")
    if plan.compress is not None:
        raise PlanError(
            "compression is a worker-side stage of the training loop; "
            "serve clients submit raw rows — drop the compress stage from "
            "the served plan")


class PlanExecutor:
    """The per-plan callables one cohort geometry on one device shares.

    ``ingest(buffer, arrived, stats, rows, ids)`` folds one chunk (rows and
    distinct slot ids, tensors on the device) into the round state;
    ``close(buffer, arrived, stats, key)`` gives the round's aggregate.
    ``kernels`` says whether the plan's aggregator runs its kernels on this
    device."""

    def __init__(self, plan: ServerPlan, n_slots: int, dim: int,
                 chunk_size: int, device=None):
        validate_serve_plan(plan)
        self.plan = plan
        self.n_slots = int(n_slots)
        self.dim = int(dim)
        self.chunk_size = int(chunk_size)
        self.device = resolve_device(device)
        self.step = plan.build()
        self.aggregator = self.step.aggregator
        self.two_phase = self.aggregator.supports_two_phase
        self.radius = None if plan.clip is None else float(plan.clip.radius)
        # raises for backend "cuda" on the CPU, as the step itself would
        self.kernels = self.aggregator.uses_kernels(
            torch.empty(0, device=self.device))

    def init_state(self):
        """A fresh round state: (buffer, arrived, stats) on the device."""
        n, d, dev = self.n_slots, self.dim, self.device
        stats = torch.zeros((n, n) if self.two_phase else (), dtype=F32,
                            device=dev)
        return (torch.zeros(n, d, dtype=F32, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev), stats)

    def ingest(self, buffer, arrived, stats, rows, ids):
        """Fold rows (c, dim) f32 at distinct slots ``ids`` (c,) into the
        state; ``buffer`` and ``arrived`` are updated in place, the new
        stats returned."""
        emb = torch.zeros_like(buffer)
        emb[ids] = rows
        chunk_mask = torch.zeros_like(arrived)
        chunk_mask[ids] = True
        buffer[ids] = rows
        arrived |= chunk_mask
        if self.two_phase:
            stats = self.aggregator.update_stats(stats, buffer, emb,
                                                 chunk_mask)
        return stats

    def close(self, buffer, arrived, stats, key=None):
        """The round's aggregate (dim,) over the arrived rows."""
        if self.two_phase:
            sel = self.aggregator.finalize(stats, mask=arrived, key=key,
                                           radius=self.radius)
            return self.aggregator.apply_selection(buffer, sel)
        return self.step(buffer, mask=arrived, key=key)


def _fresh(value, dtype, device) -> torch.Tensor:
    """A new tensor holding ``value`` (array or tensor), sharing no
    memory with it."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(value), dtype=dtype, device=device)


_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()
_CACHE_STATS = {"hits": 0, "misses": 0}


def get_executor(plan: ServerPlan, n_slots: int, dim: int,
                 chunk_size: int = 8, device=None) -> PlanExecutor:
    """The shared executor of ``plan`` at this geometry and device, keyed
    on the canonical plan JSON: equal plans, however constructed, share
    one executor."""
    dev = resolve_device(device)
    key = (plan.to_json(), int(n_slots), int(dim), int(chunk_size), str(dev))
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _CACHE_STATS["hits"] += 1
            return hit
    # built outside the lock; a race only builds a duplicate that is dropped
    ex = PlanExecutor(ServerPlan.from_json(key[0]), n_slots, dim, chunk_size,
                      dev)
    with _CACHE_LOCK:
        _CACHE_STATS["misses"] += 1
        return _CACHE.setdefault(key, ex)


def executor_cache_info() -> dict:
    with _CACHE_LOCK:
        return dict(_CACHE_STATS, size=len(_CACHE))


def executor_cache_clear() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()
        _CACHE_STATS.update(hits=0, misses=0)


class CohortBuilder:
    """One round's cohort: the streaming state plus its executor.

    ``ingest(rows, slot_ids)`` takes any number of host rows, cuts them
    into chunks of the executor's ``chunk_size`` (a slot repeated inside
    one chunk keeps its last row), copies each chunk to the device once
    and returns the number of chunks; ``close(key)`` returns the
    aggregate over the arrived rows; ``reset()`` opens the next round on
    the same executor."""

    def __init__(self, plan: ServerPlan, n_slots: int, dim: int, *,
                 chunk_size: int = 8, device=None):
        self.executor = get_executor(plan, n_slots, dim, chunk_size, device)
        self.reset()

    def reset(self) -> None:
        self._buffer, self._arrived, self._stats = self.executor.init_state()

    def state(self):
        """The round's streaming state: (buffer, arrived, stats), the live
        tensors (``ingest`` updates buffer and arrived in place).
        Everything ``close`` depends on: these three restored into a fresh
        cohort resume the round bit for bit (the incremental Gram is plain
        data)."""
        return self._buffer, self._arrived, self._stats

    def set_state(self, buffer, arrived, stats) -> None:
        """Install a snapshot taken from :meth:`state` (numpy arrays or
        tensors, shape-checked against this cohort's geometry) as fresh
        tensors on the executor's device: never a view of the caller's
        arrays, which the next ingest would otherwise write through."""
        template = self.executor.init_state()
        values = (buffer, arrived, stats)
        for name, tmpl, val in zip(("buffer", "arrived", "stats"), template,
                                   values):
            if tuple(np.shape(val)) != tuple(tmpl.shape):
                raise ValueError(
                    f"snapshot {name} shape {tuple(np.shape(val))} != "
                    f"expected {tuple(tmpl.shape)} for this cohort geometry")
        self._buffer, self._arrived, self._stats = (
            _fresh(val, tmpl.dtype, self.executor.device)
            for tmpl, val in zip(template, values))

    @property
    def fill(self) -> int:
        """Distinct slots with an arrived row this round."""
        return int(self._arrived.sum())

    @property
    def arrived(self) -> torch.Tensor:
        return self._arrived

    @property
    def buffer(self) -> torch.Tensor:
        return self._buffer

    def ingest(self, rows, slot_ids) -> int:
        ex = self.executor
        rows = np.asarray(rows, dtype=np.float32)
        ids = np.asarray(slot_ids, dtype=np.int64)
        if rows.ndim == 1:
            rows, ids = rows[None], ids.reshape(1)
        if rows.shape[0] != ids.shape[0]:
            raise ValueError(f"{rows.shape[0]} rows but {ids.shape[0]} slot "
                             "ids")
        if rows.shape[1] != ex.dim:
            raise ValueError(f"row width {rows.shape[1]} != configured dim "
                             f"{ex.dim}")
        if ids.size and (ids.min() < 0 or ids.max() >= ex.n_slots):
            raise ValueError(f"slot ids must lie in [0, {ex.n_slots}); got "
                             f"[{ids.min()}, {ids.max()}]")
        c = ex.chunk_size
        chunks = range(0, rows.shape[0], c)
        for lo in chunks:
            cids = ids[lo:lo + c]
            # the last occurrence of each slot, in arrival order
            _, first_rev = np.unique(cids[::-1], return_index=True)
            keep = np.sort(len(cids) - 1 - first_rev)
            chunk = torch.from_numpy(np.ascontiguousarray(rows[lo:lo + c][keep]))
            self._stats = ex.ingest(
                self._buffer, self._arrived, self._stats,
                chunk.to(ex.device), torch.from_numpy(cids[keep]).to(ex.device))
        return len(chunks)

    def close(self, key=None) -> torch.Tensor:
        """The aggregate of the arrived rows (does NOT reset the round).
        ``key`` is Bucketing's row order source (a permutation or a
        ``torch.Generator``; None: a generator seeded 0)."""
        return self.executor.close(self._buffer, self._arrived, self._stats,
                                   key)
