"""Crash-safe checkpoint and resume of the streaming aggregation server,
the counterpart of ``repro.serve.recovery``.

A server snapshot captures the full mid-stream round state as a flat tree
of numpy arrays: the open round's cohort buffer, arrived mask and
incremental Gram stats (copied off the device), the round counter, the
per-slot quarantine tables and every :class:`ServeMetrics` counter, plus
an optional caller ``extra`` tree (e.g. the driving loop's cursor, which
makes a resumed synthetic-client run bit for bit deterministic).
Snapshots go through :mod:`repro_torch.checkpoint`, whose writes are
atomic: a SIGKILL at any point leaves the newest complete checkpoint on
disk, and ``latest_step`` skips damaged files, so a killed ``--mode
stream`` server restarts mid-stream and replays forward to aggregates
bit for bit equal to an uninterrupted run's.

The tree has the reference's keys and ``SERVER_STATE_VERSION`` 1, and its
``metrics`` vector holds the reference's 15 counters in the reference's
order.  This package's one further counter, ``chunks_ingested``, is
stored under a key of its own, which the reference's reader ignores; a
reference snapshot has no such key, and it reads as 0.  So each package
restores the other's server snapshots.  A restored server needs no
generator state: a round's Bucketing order is ``round_key(seed,
round_id)``.

What a snapshot leaves out:

- the submission queue: snapshots are taken at pump boundaries, where the
  queue is drained (``save_server`` refuses otherwise);
- live :class:`Ticket` objects: handles die with the process; clients of
  a crashed server re-poll or resubmit;
- the wall clock: the open round's deadline window re-arms at restore.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from .. import checkpoint as _ckpt
from .server import AggregationServer, ServeMetrics

__all__ = [
    "SERVER_STATE_VERSION",
    "ServerCheckpointer",
    "restore_server",
    "save_server",
    "server_state",
]

SERVER_STATE_VERSION = 1

# the counter that the reference's ServeMetrics lacks: a key of its own
_PORT_ONLY = "chunks_ingested"
# the reference's field order, so the metrics vector round-trips through
# one array in both packages
_METRIC_FIELDS = tuple(f.name for f in dataclasses.fields(ServeMetrics)
                       if f.name != _PORT_ONLY)


def _host_copy(t) -> np.ndarray:
    """A host array that shares no memory with the live tensor ``t`` (on
    the CPU ``t.cpu().numpy()`` would alias it, and the next ingest writes
    ``buffer`` and ``arrived`` in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def server_state(server: AggregationServer, extra: Any = None) -> dict:
    """The server's full snapshot tree (numpy leaves, npz-friendly)."""
    buffer, arrived, stats = server._builder.state()
    n = server.config.n_slots
    strikes = np.zeros((n,), np.int64)
    q_level = np.zeros((n,), np.int64)
    q_until = np.full((n,), -1, np.int64)
    for slot, v in server._strikes.items():
        strikes[slot] = v
    for slot, v in server._quarantine_level.items():
        q_level[slot] = v
    for slot, v in server._quarantine_until.items():
        q_until[slot] = v
    m = server.metrics
    metrics = np.asarray([float(getattr(m, f)) for f in _METRIC_FIELDS],
                         np.float64)
    tree = {
        "version": np.int64(SERVER_STATE_VERSION),
        "round_id": np.int64(server._round_id),
        "buffer": _host_copy(buffer),
        "arrived": _host_copy(arrived),
        "stats": _host_copy(stats),
        "strikes": strikes,
        "quarantine_level": q_level,
        "quarantine_until": q_until,
        "metrics": metrics,
        _PORT_ONLY: np.int64(getattr(m, _PORT_ONLY)),
    }
    if extra is not None:
        tree["extra"] = extra
    return tree


def _load_state(server: AggregationServer, tree: dict) -> None:
    version = int(np.asarray(tree["version"]))
    if version != SERVER_STATE_VERSION:
        raise ValueError(
            f"unsupported server snapshot version {version}; this reader "
            f"understands version {SERVER_STATE_VERSION}")
    arrived = np.asarray(tree["arrived"]).astype(bool)
    server._builder.set_state(tree["buffer"], arrived, tree["stats"])
    server._round_id = int(np.asarray(tree["round_id"]))
    server._arrived_slots = {int(i) for i in np.nonzero(arrived)[0]}
    server._strikes = {int(i): int(v)
                       for i, v in enumerate(np.asarray(tree["strikes"]))
                       if v}
    server._quarantine_level = {
        int(i): int(v)
        for i, v in enumerate(np.asarray(tree["quarantine_level"])) if v}
    server._quarantine_until = {
        int(i): int(v)
        for i, v in enumerate(np.asarray(tree["quarantine_until"]))
        if v >= 0}
    metrics = np.asarray(tree["metrics"], np.float64)
    for name, value in zip(_METRIC_FIELDS, metrics):
        current = getattr(server.metrics, name)
        cast = float if isinstance(current, float) else int
        setattr(server.metrics, name, cast(value))
    setattr(server.metrics, _PORT_ONLY,
            int(np.asarray(tree.get(_PORT_ONLY, 0))))
    # tickets and queued rows do not survive a crash (module docstring)
    server._round_tickets = []
    server._queue.clear()
    server.metrics.queue_depth = 0
    # the deadline window re-arms from the restore instant
    server._round_opened_at = server._clock()


def save_server(server: AggregationServer, ckpt_dir: str, *,
                step: Optional[int] = None, extra: Any = None) -> str:
    """Atomically snapshot ``server`` into ``ckpt_dir`` (the step defaults
    to the current round id, i.e. the rounds closed so far)."""
    if server._queue:
        raise ValueError(
            f"refusing to snapshot with {len(server._queue)} undrained "
            "queued rows: call pump() first (queued rows are not part of "
            "the snapshot and would be silently lost on resume)")
    step = server._round_id if step is None else int(step)
    return _ckpt.save(ckpt_dir, step, server_state(server, extra))


def restore_server(server: AggregationServer, ckpt_dir: str, *,
                   step: Optional[int] = None, extra_template: Any = None):
    """Restore ``server`` in place from ``ckpt_dir``.

    ``step=None`` resumes from the newest complete checkpoint (damaged
    files from a crash mid-write are skipped).  ``extra_template`` mirrors
    the ``extra`` tree passed to ``save_server`` (shapes and dtypes).
    Returns ``(step, extra)``, or None when the directory holds no usable
    checkpoint."""
    if step is None:
        step = _ckpt.latest_step(ckpt_dir)
        if step is None:
            return None
    elif not _ckpt.verify_step(ckpt_dir, step):
        raise ValueError(
            f"checkpoint step {step} in {ckpt_dir!r} is missing or damaged")
    template = server_state(server, extra_template)
    if not _ckpt.has_leaf(ckpt_dir, step, f"['{_PORT_ONLY}']"):
        del template[_PORT_ONLY]  # a reference snapshot
    tree = _ckpt.restore(ckpt_dir, step, template)
    _load_state(server, tree)
    return step, tree.get("extra")


class ServerCheckpointer:
    """Periodic snapshot policy: ``observe(closed)`` after every pump
    saves once per ``every`` newly closed rounds (``save`` forces one)."""

    def __init__(self, server: AggregationServer, ckpt_dir: str, *,
                 every: int = 1):
        if every < 1:
            raise ValueError(f"every must be >= 1; got {every}")
        self.server = server
        self.ckpt_dir = ckpt_dir
        self.every = int(every)
        self._last_saved_round = -1

    def save(self, extra: Any = None) -> str:
        path = save_server(self.server, self.ckpt_dir, extra=extra)
        self._last_saved_round = self.server._round_id
        return path

    def observe(self, closed_rounds: int, extra: Any = None) -> Optional[str]:
        """Call after ``pump()``; saves when at least ``every`` rounds
        closed since the last snapshot."""
        if closed_rounds <= 0:
            return None
        if self._last_saved_round < 0 or \
                self.server._round_id - self._last_saved_round >= self.every:
            return self.save(extra)
        return None
