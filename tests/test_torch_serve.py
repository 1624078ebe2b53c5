"""The port's streaming aggregation server (``repro_torch.serve``) on the
CPU, mirroring tests/test_serve.py and the server half of
tests/test_serve_faults.py, plus a parity run against the reference
server on one shared stream.

The load-bearing property: incremental cohort assembly (rows arriving in
any chunk partition and order into a partial cohort) closes BITWISE-equal
to the plan's one-shot ``ServerStep`` on the assembled buffer, for every
ported registry rule, clip on and off, on the backends that run on the
CPU ("torch", and "auto", which runs the kernels' plain versions
there).  Against the reference server the aggregates agree to rtol 1e-5
with the same round ids, close reasons and fills.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.api import AggregatorSpec as RAggregatorSpec
from repro.api import ClipSpec as RClipSpec
from repro.api import ScheduleSpec as RScheduleSpec
from repro.api import ServerPlan as RServerPlan
from repro.scenarios import SyntheticCohort as RSyntheticCohort
from repro.serve import AggregationServer as RAggregationServer
from repro.serve import ServeConfig as RServeConfig
from repro_torch.api import (
    AggregatorSpec,
    BucketSpec,
    ClipSpec,
    CompressSpec,
    PlanError,
    ScenarioSpec,
    ScheduleSpec,
    ServerPlan,
)
from repro_torch.kernels import _build, ops
from repro_torch.launch import serve as tlaunch
from repro_torch.scenarios import SyntheticCohort
from repro_torch.serve import (
    AggregationServer,
    CohortBuilder,
    ServeConfig,
    executor_cache_clear,
    executor_cache_info,
    get_executor,
    round_key,
    validate_serve_plan,
)

CPU = "cpu"


def _plan(rule, *, bucket_s=0, radius=None, backend="torch", byz_bound=1):
    return ServerPlan(
        aggregate=AggregatorSpec(rule, byz_bound=byz_bound),
        clip=ClipSpec(radius=radius) if radius is not None else None,
        bucket=BucketSpec(s=bucket_s) if bucket_s else None,
        schedule=ScheduleSpec(placement="naive", backend=backend))


def _random_partition(rng, items):
    out, i = [], 0
    while i < len(items):
        step = int(rng.randint(1, len(items) - i + 1))
        out.append(items[i:i + step])
        i += step
    return out


# ---------------------------------------------------------------------------
# the bitwise property: incremental close == one-shot ServerStep
# ---------------------------------------------------------------------------

_REGISTRY = (("mean", 0), ("cm", 0), ("tm", 0), ("rfa", 0), ("krum", 0),
             ("multi_krum", 0), ("cm", 2), ("krum", 2), ("multi_krum", 2),
             ("krum", 3), ("centered_clip", 0), ("centered_clip", 2))


@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("rule,bucket_s", _REGISTRY,
                         ids=[f"{r}-s{s}" for r, s in _REGISTRY])
@pytest.mark.parametrize("radius", [None, 2.5], ids=["noclip", "clip"])
def test_incremental_close_bitwise_equals_one_shot_step(backend, rule,
                                                        bucket_s, radius):
    n, d = 8, 48
    xs = np.random.RandomState(0).randn(n, d).astype(np.float32) * 3.0
    plan = _plan(rule, bucket_s=bucket_s, radius=radius, backend=backend)
    step = plan.build()
    for trial in range(3):
        prng = np.random.RandomState(100 * trial + bucket_s)
        k = int(prng.randint(1, n + 1))
        slots = prng.permutation(n)[:k]
        builder = CohortBuilder(plan, n, d, chunk_size=3, device=CPU)
        for chunk in _random_partition(prng, list(slots)):
            ids = np.asarray(chunk)
            builder.ingest(xs[ids], ids)
        got = builder.close(round_key(7, trial))
        buf = np.zeros((n, d), np.float32)
        buf[slots] = xs[slots]
        mask = np.zeros(n, bool)
        mask[slots] = True
        want = step(torch.from_numpy(buf), mask=torch.from_numpy(mask),
                    key=round_key(7, trial))
        np.testing.assert_array_equal(
            got.numpy(), want.numpy(),
            err_msg=f"{rule} s={bucket_s} clip={radius} {sorted(slots)}")


def test_executor_takes_the_one_shot_form_of_its_device():
    """On the CPU no backend runs kernels; Krum keeps the raw rows and
    finalizes at the plan's radius on every backend; the Gram of a
    selection rule starts at zero."""
    for backend in ("torch", "auto"):
        ex = get_executor(_plan("krum", radius=2.0, backend=backend), 6, 10,
                          4, CPU)
        assert not ex.kernels and ex.two_phase and ex.radius == 2.0
        buf, arrived, stats = ex.init_state()
        assert stats.shape == (6, 6) and not arrived.any()
        rows = np.full((2, 10), 3.0, np.float32)  # norm 9.5 > radius
        stats = ex.ingest(buf, arrived, stats, torch.from_numpy(rows),
                          torch.tensor([1, 4]))
        np.testing.assert_array_equal(buf[[1, 4]].numpy(), rows)
    ex = get_executor(_plan("cm", radius=2.0), 6, 10, 4, CPU)
    assert not ex.two_phase
    with pytest.raises(ValueError, match="backend 'cuda'"):
        get_executor(_plan("krum", backend="cuda"), 6, 10, 4, CPU)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       chunk_size=st.integers(min_value=1, max_value=9),
       clip=st.booleans())
def test_incremental_gram_is_partition_invariant(seed, chunk_size, clip):
    """Any chunk partition, arrival order or resubmission lands on the same
    stats and the same close, bit for bit."""
    n, d = 7, 33
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, d).astype(np.float32)
    plan = _plan("multi_krum", radius=2.0 if clip else None)
    outs, stats = [], []
    for trial in range(2):
        order = list(rng.permutation(n))
        if trial == 1:  # a resubmitted row: the last write wins cleanly
            order.insert(rng.randint(1, n), order[0])
        builder = CohortBuilder(plan, n, d, chunk_size=chunk_size, device=CPU)
        for chunk in _random_partition(rng, order):
            ids = np.asarray(chunk)
            builder.ingest(xs[ids], ids)
        assert builder.fill == n
        outs.append(builder.close().numpy())
        stats.append(builder.state()[2].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(stats[0], stats[1])


def test_a_slot_repeated_in_one_chunk_keeps_its_last_row():
    plan = _plan("krum")
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = CohortBuilder(plan, 4, 4, chunk_size=8, device=CPU)
    a.ingest(rows, [1, 2, 1])
    b = CohortBuilder(plan, 4, 4, chunk_size=8, device=CPU)
    b.ingest(rows[1:], [2, 1])
    for x, y in zip(a.state(), b.state()):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_cohort_builder_validates_geometry():
    builder = CohortBuilder(_plan("cm"), 4, 8, device=CPU)
    with pytest.raises(ValueError, match="slot ids"):
        builder.ingest(np.zeros((1, 8), np.float32), [4])
    with pytest.raises(ValueError, match="row width"):
        builder.ingest(np.zeros((1, 9), np.float32), [0])
    with pytest.raises(ValueError, match="slot ids"):
        builder.ingest(np.zeros((2, 8), np.float32), [0])


def test_unservable_plans_are_rejected():
    with pytest.raises(PlanError, match="naive"):
        validate_serve_plan(ServerPlan(
            aggregate=AggregatorSpec("cm"),
            schedule=ScheduleSpec(placement="sharded")))
    with pytest.raises(PlanError, match="iterate pair"):
        validate_serve_plan(ServerPlan(aggregate=AggregatorSpec("cm"),
                                       clip=ClipSpec(alpha=1.0)))
    with pytest.raises(PlanError, match="compress"):
        validate_serve_plan(ServerPlan(
            aggregate=AggregatorSpec("cm"),
            compress=CompressSpec(kind="rand_k", k=2)))


def test_the_server_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AggregationServer(_plan("cm"), ServeConfig(n_slots=2, dim=3))


# ---------------------------------------------------------------------------
# the serve loop: triggers, stale policies, fan-out, counters
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _server(rule="cm", *, n=6, d=16, clock=None, plan=None, **cfg_kw):
    return AggregationServer(plan or _plan(rule),
                             ServeConfig(n_slots=n, dim=d, **cfg_kw),
                             clock=clock, device=CPU)


def test_cohort_size_trigger_fans_out_one_result():
    srv = _server(cohort_size=4)
    rng = np.random.RandomState(0)
    tickets = [srv.submit(i, rng.randn(16)) for i in range(4)]
    closed = srv.pump()
    assert len(closed) == 1
    r = closed[0]
    assert r.close_reason == "fill" and r.cohort_fill == 4
    assert all(t.done and t.result is r for t in tickets)
    assert all(t.status == "done" for t in tickets)
    assert srv.round_id == 1
    assert srv.metrics.closes_by_fill == 1


def test_deadline_trigger_closes_underfull_round():
    clock = _Clock()
    srv = _server(cohort_size=6, deadline=1.0, clock=clock)
    t = srv.submit(2, np.ones(16))
    assert srv.pump() == []
    clock.t = 1.5
    closed = srv.pump()
    assert len(closed) == 1 and closed[0].close_reason == "deadline"
    assert closed[0].cohort_fill == 1
    assert closed[0].latency == pytest.approx(1.5)
    assert t.done and t.latency == pytest.approx(1.5)
    assert srv.metrics.closes_by_deadline == 1


def test_deadline_with_empty_round_rearms_instead_of_closing():
    clock = _Clock()
    srv = _server(deadline=1.0, clock=clock)
    clock.t = 5.0
    assert srv.pump() == []
    assert srv.metrics.rounds_closed == 0
    srv.submit(0, np.ones(16))
    clock.t = 5.5
    assert srv.pump() == []
    clock.t = 6.1
    assert len(srv.pump()) == 1


def test_stale_drop_policy_rejects_late_rows():
    srv = _server(cohort_size=2, stale_policy="drop")
    srv.submit(0, np.ones(16))
    srv.submit(1, np.ones(16))
    assert len(srv.pump()) == 1
    late = srv.submit(2, np.ones(16), round_id=0)
    assert srv.pump() == []
    assert late.status == "dropped_stale" and not late.done
    assert srv.metrics.rows_dropped_stale == 1
    assert srv.metrics.rows_ingested == 2


@pytest.mark.parametrize("rule", ["mean", "krum"])
def test_stale_defer_policy_discounts_into_current_round(rule):
    """A deferred row enters the next round scaled by
    stale_discount ** staleness; the close equals the one-shot step over
    exactly that buffer, bit for bit."""
    plan = _plan(rule, radius=1.0 if rule == "krum" else None)
    cfg = ServeConfig(n_slots=3, dim=8, cohort_size=2, stale_policy="defer",
                      stale_discount=0.5, seed=4)
    srv = AggregationServer(plan, cfg, device=CPU)
    rng = np.random.RandomState(1)
    r0 = rng.randn(2, 8).astype(np.float32)
    srv.submit(0, r0[0])
    srv.submit(1, r0[1])
    assert len(srv.pump()) == 1
    late = rng.randn(8).astype(np.float32)
    t_late = srv.submit(2, late, round_id=0)
    r1 = rng.randn(8).astype(np.float32)
    srv.submit(0, r1)
    closed = srv.pump()
    assert len(closed) == 1 and closed[0].round_id == 1
    assert t_late.status == "deferred" and t_late.done
    assert srv.metrics.rows_deferred == 1
    buf = np.zeros((3, 8), np.float32)
    buf[2] = late * np.float32(0.5)
    buf[0] = r1
    mask = np.asarray([True, False, True])
    want = plan.build()(torch.from_numpy(buf), mask=torch.from_numpy(mask),
                        key=round_key(4, 1))
    np.testing.assert_array_equal(closed[0].aggregate, want.numpy())


def test_submit_to_future_round_is_rejected():
    with pytest.raises(ValueError, match="not opened"):
        _server().submit(0, np.ones(16), round_id=3)


def test_backlog_closes_multiple_rounds_in_one_pump():
    srv = _server(cohort_size=2, n=2)
    for _ in range(3):
        srv.submit(0, np.ones(16))
        srv.submit(1, np.ones(16))
    closed = srv.pump()
    assert [r.round_id for r in closed] == [0, 1, 2]
    assert srv.metrics.rounds_closed == 3


def test_metrics_snapshot_counts_queue_depth():
    srv = _server(cohort_size=6)
    for i in range(3):
        srv.submit(i, np.ones(16))
    assert srv.metrics.max_queue_depth == 3
    srv.pump()
    m = srv.metrics.snapshot()
    assert m["queue_depth"] == 0 and m["rows_ingested"] == 3
    assert m["rounds_closed"] == 0


@pytest.mark.parametrize("field,value,match", [
    ("n_slots", 0, "n_slots"), ("cohort_size", 5, "cohort_size"),
    ("deadline", -1.0, "deadline"), ("stale_policy", "nope", "stale_policy"),
    ("stale_discount", 0.0, "stale_discount"), ("chunk_size", 0, "chunk_size"),
    ("duplicate_policy", "x", "duplicate_policy"), ("min_fill", 9, "min_fill"),
    ("quarantine_after", -1, "quarantine_after"),
    ("quarantine_rounds", 0, "quarantine_rounds"),
    ("quarantine_cap", 0, "quarantine_cap"), ("dim", 0, "dim")])
def test_serve_config_validation(field, value, match):
    kw = dict(n_slots=4, dim=8)
    kw[field] = value
    with pytest.raises(ValueError, match=match):
        ServeConfig(**kw)


def test_executor_cache_shares_executors_across_tenants():
    executor_cache_clear()
    p1 = _plan("krum", radius=2.0)
    p2 = _plan("krum", radius=2.0)  # equal, separately constructed
    ex1 = get_executor(p1, 8, 32, 4, CPU)
    info = executor_cache_info()
    assert (info["misses"], info["hits"], info["size"]) == (1, 0, 1)
    ex2 = get_executor(p2, 8, 32, 4, CPU)
    info = executor_cache_info()
    assert (info["misses"], info["hits"]) == (1, 1)
    assert ex1 is ex2
    get_executor(_plan("cm"), 8, 32, 4, CPU)  # a different plan
    get_executor(p1, 8, 32, 2, CPU)  # another chunk size
    assert executor_cache_info()["misses"] == 3
    builder = CohortBuilder(p2, 8, 32, chunk_size=4, device=CPU)
    assert builder.executor is ex1
    executor_cache_clear()
    assert executor_cache_info() == {"hits": 0, "misses": 0, "size": 0}


# ---------------------------------------------------------------------------
# graceful degradation: validation, quarantine, duplicates, fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row,code", [
    (np.ones(15), "wrong_shape"), (np.ones((2, 16)), "wrong_shape"),
    (np.r_[np.ones(15), np.nan], "non_finite"),
    (np.r_[np.ones(15), np.inf], "non_finite"), ("abc", "wrong_shape")])
def test_malformed_rows_are_rejected_with_a_code(row, code):
    srv = _server(cohort_size=2)
    t = srv.submit(0, row)
    assert t.status == "rejected" and t.error.code == code
    assert t.latency is not None
    srv.submit(0, np.ones(16))
    srv.submit(1, np.ones(16))
    closed = srv.pump()
    assert len(closed) == 1 and np.all(closed[0].aggregate == 1.0)
    assert srv.metrics.rows_rejected == 1


def test_bad_slots_are_rejected():
    srv = _server()
    assert srv.submit(6, np.ones(16)).error.code == "bad_slot"
    assert srv.submit(-1, np.ones(16)).error.code == "bad_slot"
    assert srv.submit("x", np.ones(16)).error.code == "bad_slot"


def test_repeat_offenders_are_quarantined_with_bounded_backoff():
    srv = _server(cohort_size=1, quarantine_after=2, quarantine_rounds=1,
                  quarantine_cap=2)
    bad = np.full(16, np.nan)
    srv.submit(3, bad)
    srv.submit(3, bad)
    assert srv.metrics.quarantines == 1
    assert srv.quarantined_until(3) == 1
    t = srv.submit(3, np.ones(16))
    assert t.error.code == "quarantined"
    assert srv.metrics.rows_quarantined == 1
    srv.submit(0, np.ones(16))
    assert len(srv.pump()) == 1  # round 1 opens: slot 3 is heard again
    assert srv.quarantined_until(3) is None
    srv.submit(3, bad)
    srv.submit(3, bad)
    assert srv.quarantined_until(3) == 1 + 2  # doubled, capped at 2


@pytest.mark.parametrize("policy", ["first_wins", "last_wins", "reject"])
def test_duplicate_policy(policy):
    srv = _server("mean", n=3, cohort_size=2, duplicate_policy=policy, d=4)
    srv.submit(0, np.full(4, 1.0))
    dup = srv.submit(0, np.full(4, 3.0))
    srv.submit(1, np.full(4, 5.0))
    closed = srv.pump()
    assert len(closed) == 1
    want = {"first_wins": 3.0, "last_wins": 4.0, "reject": 3.0}[policy]
    np.testing.assert_array_equal(closed[0].aggregate, np.full(4, want))
    assert dup.status == {"first_wins": "duplicate", "last_wins": "done",
                          "reject": "rejected"}[policy]


def test_underfull_deadline_close_degrades_to_the_clipped_mean():
    clock = _Clock()
    plan = _plan("krum", radius=1.0)
    srv = AggregationServer(plan, ServeConfig(
        n_slots=6, dim=4, deadline=1.0, min_fill=3), clock=clock, device=CPU)
    srv.submit(0, np.asarray([3.0, 4.0, 0.0, 0.0]))
    srv.submit(1, np.asarray([0.0, 0.5, 0.0, 0.0]))
    srv.pump()
    clock.t = 2.0
    closed = srv.pump()
    assert len(closed) == 1 and closed[0].degraded
    assert closed[0].fallback_reason == "underfull"
    want = (np.asarray([0.6, 0.8, 0, 0]) + np.asarray([0, 0.5, 0, 0])) / 2
    np.testing.assert_allclose(closed[0].aggregate, want, rtol=1e-6)
    assert srv.metrics.rounds_degraded == 1


def test_executor_error_degrades_and_is_counted():
    srv = _server("krum", cohort_size=2, d=4)

    def broken(key=None):
        raise RuntimeError("launch failed")

    srv._builder.close = broken
    srv.submit(0, np.ones(4))
    srv.submit(1, 3 * np.ones(4))
    closed = srv.pump()
    assert closed[0].degraded
    assert closed[0].fallback_reason == "executor_error:RuntimeError"
    assert srv.metrics.executor_faults == 1
    np.testing.assert_array_equal(closed[0].aggregate, 2 * np.ones(4))


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_kernel_fault_propagates_instead_of_degrading(fault):
    """A kernel that does not build or launch is a fault of the server:
    pump() raises it, and no round closes on the fallback aggregate."""
    srv = _server("krum", cohort_size=2, d=4)

    def broken(key=None):
        raise _build.KernelError(f"{fault} failed")

    srv._builder.close = broken
    srv.submit(0, np.ones(4))
    srv.submit(1, 3 * np.ones(4))
    with pytest.raises(_build.KernelError, match=fault):
        srv.pump()
    m = srv.metrics
    assert (m.rounds_closed, m.rounds_degraded, m.executor_faults) == (0, 0, 0)


def test_on_close_sees_each_round_with_its_state_and_chunks_are_counted():
    """The audit hook gets every closed round with the streaming state it
    came from, and a burst of 6 rows at chunk size 4 folds in 2 chunks."""
    seen = []

    def audit(result, state):
        buf, arrived, stats = (t.clone() for t in state)
        seen.append((result, buf, arrived, stats))

    plan = _plan("krum", radius=2.0)
    srv = AggregationServer(plan, ServeConfig(n_slots=8, dim=5, cohort_size=6,
                                              chunk_size=4),
                            device=CPU, on_close=audit)
    rows = np.random.RandomState(1).randn(8, 5).astype(np.float32)
    for slot in range(6):
        srv.submit(slot, rows[slot])
    closed = srv.pump()
    assert len(closed) == 1 and len(seen) == 1
    assert srv.metrics.chunks_ingested == 2
    result, buf, arrived, stats = seen[0]
    assert result is closed[0]
    assert arrived.tolist() == [True] * 6 + [False] * 2
    once = srv.executor.step(buf, mask=arrived,
                             key=round_key(srv.config.seed, 0))
    np.testing.assert_array_equal(once.numpy(), result.aggregate)
    np.testing.assert_array_equal(
        stats.numpy(), srv.executor.aggregator.accumulate_stats(buf).numpy())


def test_stale_underflow_degrades_to_a_drop():
    srv = _server("mean", n=2, cohort_size=1, stale_policy="defer",
                  stale_discount=1e-200, d=4)
    for _ in range(3):
        srv.submit(0, np.ones(4))
        srv.pump()
    t = srv.submit(1, np.ones(4), round_id=0)
    srv.pump()
    assert t.status == "dropped_stale" and t.error.code == "stale_underflow"


@settings(deadline=None, max_examples=20)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_any_interleaving_of_retried_wire_batches_closes_like_in_order(seed):
    """Under first_wins, any interleaving of duplicated wire batches
    closes bit for bit like the in-order stream (through the incremental
    Gram of a selection rule)."""
    n, d = 5, 12
    chaos = np.random.RandomState(seed)
    rows = np.random.RandomState(42).randn(n, d).astype(np.float32)
    plan = _plan("krum", radius=5.0)

    def fresh(policy):
        return AggregationServer(plan, ServeConfig(
            n_slots=n, dim=d, seed=6, duplicate_policy=policy), device=CPU)

    oracle = fresh("last_wins")
    for slot in range(n):
        oracle.submit(slot, rows[slot])
    want = oracle.pump()[0].aggregate
    events = list(range(n)) + list(chaos.randint(0, n,
                                                 size=chaos.randint(0, 5)))
    chaos.shuffle(events)
    srv = fresh("first_wins")
    tickets, closed, i = [], [], 0
    while i < len(events):
        size = int(chaos.randint(1, 4))
        for slot in events[i:i + size]:
            tickets.append(srv.submit(slot, rows[slot]))
        i += size
        closed.extend(srv.pump())
    assert len(closed) == 1
    np.testing.assert_array_equal(closed[0].aggregate, want)
    round0 = [t for t in tickets if t.round_id == 0]
    assert all(t.done and t.result is closed[0] for t in round0)


# ---------------------------------------------------------------------------
# one stream through the reference server and the port's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,radius", [("krum", 5.0), ("multi_krum", 5.0),
                                         ("krum", None), ("cm", None),
                                         ("mean", 5.0),
                                         ("centered_clip", 5.0),
                                         ("centered_clip", None)])
@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_port_server_matches_reference_server_on_one_stream(rule, radius,
                                                            backend):
    """16 slots, the trailing 4 running ALIE, cohort 12, rows submitted
    one per pump round-robin from RandomState([seed, block]) as the
    launchers draw them: the same rounds, triggers and fills, and
    aggregates within rtol 1e-5."""
    n, d, rounds, seed = 16, 96, 4, 3
    rplan = RServerPlan(
        aggregate=RAggregatorSpec(rule, byz_bound=4),
        clip=RClipSpec(radius=radius) if radius else None,
        schedule=RScheduleSpec(placement="naive", backend="jnp"))
    doc = rplan.to_json()
    tplan = ServerPlan.from_json(doc.replace('"jnp"', f'"{backend}"'))
    assert tplan.aggregate.rule == rule
    ref = RAggregationServer(rplan, RServeConfig(n_slots=n, dim=d,
                                                 cohort_size=12, seed=seed))
    port = AggregationServer(tplan, ServeConfig(n_slots=n, dim=d,
                                                cohort_size=12, seed=seed),
                             device=CPU)
    rgen = RSyntheticCohort("alie", n_slots=n, dim=d, n_byz=4)
    tgen = SyntheticCohort("alie", n_slots=n, dim=d, n_byz=4)
    got, want = [], []
    cursor = 0
    while len(want) < rounds:
        b, slot = divmod(cursor, n)
        rrows = rgen.round_rows(np.random.RandomState([seed, b]))
        trows = tgen.round_rows(np.random.RandomState([seed, b]))
        np.testing.assert_allclose(trows, rrows, rtol=1e-6, atol=1e-6)
        ref.submit(slot, rrows[slot])
        port.submit(slot, trows[slot])
        want.extend(ref.pump())
        got.extend(port.pump())
        cursor += 1
    assert len(got) == len(want) == rounds
    for g, w in zip(got, want):
        assert (g.round_id, g.close_reason, g.cohort_fill, g.degraded) == \
            (w.round_id, w.close_reason, w.cohort_fill, w.degraded)
        np.testing.assert_allclose(g.aggregate, np.asarray(w.aggregate),
                                   rtol=1e-5, atol=1e-6)
    snap = port.metrics.snapshot()
    # the port also counts ingest chunks: one row per pump is one chunk
    assert snap.pop("chunks_ingested") == snap["rows_ingested"]
    assert snap | {"last_round_latency": 0} == \
        ref.metrics.snapshot() | {"last_round_latency": 0}


def test_synthetic_cohort_matches_reference_rows():
    for attack in ("none", "alie", "ipm", "bf"):
        for slots in (None, np.asarray([3, 14, 15, 0])):
            r = RSyntheticCohort(attack, n_slots=16, dim=40, n_byz=4,
                                 z_max=2.0)
            t = SyntheticCohort(attack, n_slots=16, dim=40, n_byz=4,
                                z_max=2.0)
            rng_r, rng_t = np.random.RandomState(5), np.random.RandomState(5)
            want = r.round_rows(rng_r, slots)
            got = t.round_rows(rng_t, slots)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            assert rng_r.randint(1 << 30) == rng_t.randint(1 << 30)


def test_scenario_spec_json_matches_reference():
    from repro.api import ScenarioSpec as RScenarioSpec

    spec = ScenarioSpec(attack="alie", byz_frac=0.25, z_max=2.0)
    doc = RScenarioSpec(attack="alie", byz_frac=0.25, z_max=2.0).to_json()
    assert spec.to_json() == doc
    assert ScenarioSpec.from_json(doc) == spec
    assert spec.n_byz(16) == 4
    assert spec.build().name == "alie"
    with pytest.raises(PlanError, match="byz_frac"):
        ScenarioSpec(byz_frac=1.5)
    with pytest.raises(PlanError, match="unknown scenario fields"):
        ScenarioSpec.from_dict({"attack": "none", "nope": 1})
    adaptive = ScenarioSpec.from_json(RScenarioSpec(attack="autogm").to_json())
    attack = adaptive.build(_plan("cm"))
    assert attack.name == "autogm" and attack.adaptive
    with pytest.raises(PlanError, match="pass the ServerPlan"):
        adaptive.build()


def test_stream_launcher_runs_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "rounds.jsonl"
    ops.reset_launch_counts()
    tlaunch.main(["--mode", "stream", "--aggregator", "krum", "--clients",
                  "16", "--dim", "64", "--rounds", "3", "--cohort-size", "12",
                  "--clip-radius", "5", "--attack", "alie", "--byz-frac",
                  "0.25", "--device", "cpu",
                  "--emit-rounds", str(out)])
    text = capsys.readouterr().out
    assert "3 rounds (0 degraded, rule=krum, attack=alie x4" in text
    assert "executor_faults = 0" in text
    lines = out.read_text().splitlines()
    assert len(lines) == 3
    assert sum(ops.launch_counts().values()) == 0
    # --mode score runs (tests/test_torch_score.py); decode, the default
    # mode, runs too (tests/test_torch_train.py holds its step)
    tlaunch.main(["--device", "cpu", "--batch", "2", "--tokens", "3"])
    assert "minitron-8b-smoke: 3 tokens x batch 2" in capsys.readouterr().out


def test_stream_driver_arrival_patterns():
    """steady submits one row per pump, burst a cohort per pump; both
    close the same rounds of the same rows."""
    plan = _plan("krum", radius=5.0, byz_bound=4)
    gen = SyntheticCohort("alie", n_slots=16, dim=32, n_byz=4)
    aggs = []
    for per in (1, 12):
        srv = AggregationServer(plan, ServeConfig(n_slots=16, dim=32,
                                                  cohort_size=12, seed=1),
                                device=CPU)
        closed = []
        tickets, wall = tlaunch.run_stream(srv, gen, rounds=3, seed=2,
                                           rows_per_pump=per,
                                           on_round=closed.append)
        assert len(closed) == 3 and wall > 0
        assert len(tickets) == 36
        assert srv.metrics.max_queue_depth == per
        lat = tlaunch.latency_ms(tickets)
        assert lat["p99_ms"] >= lat["p50_ms"] >= 0
        aggs.append(np.stack([r.aggregate for r in closed]))
    np.testing.assert_array_equal(aggs[0], aggs[1])
