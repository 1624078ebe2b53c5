"""Crash-safe checkpoint and resume of the port's streaming server
(``repro_torch.serve.recovery``) on the CPU, mirroring
tests/test_serve_recovery.py.

The load-bearing property: a server snapshotted mid-round (partial
cohort, partial incremental Gram) and restored into a fresh server closes
the round bit for bit as if it had never stopped, for a two-phase
selection rule (krum: the Gram is live state) and an iterative one
(centered_clip), on the backends that run on the CPU; and ``python -m
repro_torch.launch.serve --mode stream`` SIGKILLed mid-run and restarted
with ``--resume`` emits, per round id, the aggregate bytes of an
uninterrupted run.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.api import AggregatorSpec, ClipSpec, ScheduleSpec, ServerPlan
from repro_torch.serve import (
    AggregationServer,
    ServeConfig,
    ServerCheckpointer,
    restore_server,
    save_server,
    server_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _plan(rule, *, backend="torch"):
    return ServerPlan(aggregate=AggregatorSpec(rule, byz_bound=1),
                      clip=ClipSpec(radius=5.0),
                      schedule=ScheduleSpec(placement="naive",
                                            backend=backend))


def _server(plan, cfg):
    return AggregationServer(plan, cfg, device=CPU)


# ---------------------------------------------------------------------------
# in-process snapshot and restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("rule", ["krum", "centered_clip"])
def test_mid_round_snapshot_restores_bitwise(rule, backend, tmp_path):
    n, d = 6, 16
    cfg = ServeConfig(n_slots=n, dim=d, cohort_size=5, seed=3)
    plan = _plan(rule, backend=backend)
    rows = np.random.RandomState(0).randn(8, d).astype(np.float32)

    live = _server(plan, cfg)
    # close one full round first, then park mid-round: the snapshot must
    # carry round_id, the partial buffer and the partial Gram stats
    for i in range(5):
        live.submit(i, rows[i])
    assert len(live.pump()) == 1
    live.submit(0, rows[5])
    live.submit(3, rows[6])
    assert live.pump() == []  # round 1 is open, fill 2/5
    save_server(live, str(tmp_path))

    clone = _server(plan, cfg)
    restored = restore_server(clone, str(tmp_path))
    assert restored is not None and restored[0] == 1
    assert clone.round_id == 1
    assert clone._arrived_slots == live._arrived_slots
    assert clone.metrics.snapshot() == live.metrics.snapshot()
    for mine, theirs in zip(clone._builder.state(), live._builder.state()):
        assert mine.device.type == "cpu"
        assert mine.data_ptr() != theirs.data_ptr()
        np.testing.assert_array_equal(mine.numpy(), theirs.numpy())

    # identical traffic from here on closes identically, bit for bit
    finish = [(1, rows[7]), (2, rows[0]), (4, rows[1])]
    for slot, row in finish:
        live.submit(slot, row)
        clone.submit(slot, row)
    closed_live, closed_clone = live.pump(), clone.pump()
    assert len(closed_live) == len(closed_clone) == 1
    assert closed_live[0].round_id == closed_clone[0].round_id == 1
    np.testing.assert_array_equal(closed_live[0].aggregate,
                                  closed_clone[0].aggregate)


def test_snapshot_is_a_copy_of_the_live_state():
    """On the CPU ``tensor.numpy()`` aliases the tensor; the snapshot must
    not change under the next ingest, and a restored builder must not
    write through into the caller's arrays."""
    plan = _plan("krum")
    cfg = ServeConfig(n_slots=4, dim=8, cohort_size=4)
    srv = _server(plan, cfg)
    srv.submit(0, np.ones(8, np.float32))
    srv.pump()
    tree = server_state(srv)
    before = {k: np.array(tree[k]) for k in ("buffer", "arrived", "stats")}
    srv.submit(1, 2 * np.ones(8, np.float32))
    srv.pump()
    for k, v in before.items():
        np.testing.assert_array_equal(tree[k], v)
    clone = _server(plan, cfg)
    clone._builder.set_state(tree["buffer"], tree["arrived"], tree["stats"])
    clone.submit(2, 3 * np.ones(8, np.float32))
    clone.pump()
    for k, v in before.items():
        np.testing.assert_array_equal(tree[k], v)
    with pytest.raises(ValueError, match="snapshot buffer shape"):
        clone._builder.set_state(np.zeros((3, 8)), tree["arrived"],
                                 tree["stats"])
    with pytest.raises(ValueError, match="snapshot stats shape"):
        clone._builder.set_state(tree["buffer"], tree["arrived"],
                                 np.zeros(()))
    clone._builder.set_state(torch.ones(4, 8, dtype=torch.float64),
                             torch.ones(4, dtype=torch.bool),
                             torch.zeros(4, 4))
    assert clone._builder.buffer.dtype == torch.float32


def test_snapshot_carries_quarantine_and_metrics(tmp_path):
    cfg = ServeConfig(n_slots=4, dim=8, cohort_size=2, quarantine_after=2,
                      quarantine_rounds=2)
    live = _server(_plan("cm"), cfg)
    bad = np.full(8, np.nan, np.float32)
    live.submit(0, bad)
    live.submit(0, bad)  # slot 0 quarantined for 2 rounds
    assert live.quarantined_until(0) == 2
    live.submit(1, np.ones(8, np.float32))
    live.pump()
    save_server(live, str(tmp_path))

    clone = _server(_plan("cm"), cfg)
    assert restore_server(clone, str(tmp_path)) is not None
    assert clone.quarantined_until(0) == 2
    t = clone.submit(0, np.ones(8, np.float32))
    assert t.status == "rejected" and t.error.code == "quarantined"
    assert clone.metrics.rows_rejected == live.metrics.rows_rejected + 1
    assert clone.metrics.quarantines == live.metrics.quarantines
    assert clone.metrics.chunks_ingested == live.metrics.chunks_ingested


def test_save_refuses_undrained_queue(tmp_path):
    srv = _server(_plan("cm"), ServeConfig(n_slots=4, dim=8))
    srv.submit(0, np.ones(8, np.float32))
    with pytest.raises(ValueError, match="undrained"):
        save_server(srv, str(tmp_path))
    srv.pump()
    save_server(srv, str(tmp_path))  # drained: fine


def test_restore_from_empty_dir_returns_none(tmp_path):
    srv = _server(_plan("cm"), ServeConfig(n_slots=4, dim=8))
    assert restore_server(srv, str(tmp_path / "nothing-here")) is None


def test_extra_tree_round_trips_exactly(tmp_path):
    srv = _server(_plan("cm"), ServeConfig(n_slots=4, dim=8))
    extra = {"cursor": np.int64(41), "blob": np.arange(5, dtype=np.uint32)}
    save_server(srv, str(tmp_path), extra=extra)
    clone = _server(_plan("cm"), ServeConfig(n_slots=4, dim=8))
    template = {"cursor": np.int64(0), "blob": np.zeros(5, np.uint32)}
    step, got = restore_server(clone, str(tmp_path), extra_template=template)
    assert step == 0
    assert int(got["cursor"]) == 41
    assert got["cursor"].dtype == np.int64
    np.testing.assert_array_equal(got["blob"], extra["blob"])


def test_version_mismatch_is_rejected(tmp_path):
    srv = _server(_plan("cm"), ServeConfig(n_slots=4, dim=8))
    tree = server_state(srv)
    tree["version"] = np.int64(999)
    ckpt.save(str(tmp_path), 0, tree)
    clone = _server(_plan("cm"), ServeConfig(n_slots=4, dim=8))
    with pytest.raises(ValueError, match="snapshot version"):
        restore_server(clone, str(tmp_path))


def test_checkpointer_saves_once_per_every(tmp_path):
    srv = _server(_plan("cm"), ServeConfig(n_slots=2, dim=8, cohort_size=2))
    ck = ServerCheckpointer(srv, str(tmp_path), every=2)
    saved = []
    for _ in range(4):
        srv.submit(0, np.ones(8, np.float32))
        srv.submit(1, np.ones(8, np.float32))
        closed = srv.pump()
        saved.append(ck.observe(len(closed)) is not None)
    # the first observe always snapshots, then every second round
    assert saved == [True, False, True, False]
    assert ck.observe(0) is None
    with pytest.raises(ValueError, match="every"):
        ServerCheckpointer(srv, str(tmp_path), every=0)


# ---------------------------------------------------------------------------
# subprocess kill-and-resume
# ---------------------------------------------------------------------------

def _stream_cmd(rule, backend, *, rounds, ckpt_dir, emit, resume=False,
                sleep_ms=0.0):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
           "stream", "--device", "cpu", "--aggregator", rule, "--backend",
           backend, "--clients", "4", "--dim", "8", "--n-byz", "1",
           "--clip-radius", "5.0", "--rounds", str(rounds),
           "--ckpt-dir", ckpt_dir, "--emit-rounds", emit,
           "--pump-sleep-ms", str(sleep_ms)]
    if resume:
        cmd.append("--resume")
    return cmd


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _run(cmd):
    subprocess.run(cmd, cwd=REPO, env=_env(), check=True, timeout=300,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _rounds_by_id(path):
    out = {}
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            out.setdefault(d["round_id"], set()).add(d["aggregate_hex"])
    return out


def _count_lines(path):
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for _ in f)


@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("rule", ["krum", "centered_clip"])
def test_sigkill_and_resume_is_bitwise_equal(rule, backend, tmp_path):
    """SIGKILL the stream server mid-run; every round id of the killed and
    resumed run carries one aggregate, bit for bit the uninterrupted
    run's."""
    rounds = 8
    oracle_emit = str(tmp_path / "oracle.jsonl")
    _run(_stream_cmd(rule, backend, rounds=rounds,
                     ckpt_dir=str(tmp_path / "oracle_ck"), emit=oracle_emit))
    oracle = _rounds_by_id(oracle_emit)
    assert set(oracle) == set(range(rounds))

    victim_emit = str(tmp_path / "victim.jsonl")
    victim_ck = str(tmp_path / "victim_ck")
    proc = subprocess.Popen(
        _stream_cmd(rule, backend, rounds=rounds, ckpt_dir=victim_ck,
                    emit=victim_emit, sleep_ms=60.0),
        cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 240
        while time.time() < deadline:
            if proc.poll() is not None:
                pytest.fail("the stream server finished before the kill "
                            "landed: raise --pump-sleep-ms")
            if _count_lines(victim_emit) >= 3:
                break
            time.sleep(0.05)
        else:
            pytest.fail("the stream server never emitted 3 rounds")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert _count_lines(victim_emit) < rounds

    _run(_stream_cmd(rule, backend, rounds=rounds, ckpt_dir=victim_ck,
                     emit=victim_emit, resume=True))
    victim = _rounds_by_id(victim_emit)
    assert set(victim) == set(range(rounds))
    for rid in range(rounds):
        assert victim[rid] == oracle[rid], f"round {rid} diverged"
        assert len(victim[rid]) == 1
