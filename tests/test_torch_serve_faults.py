"""The port's fault injector (``repro_torch.serve.faults``) on the CPU,
mirroring the injector half of tests/test_serve_faults.py, plus a parity
run against the reference's injector: the same plan and the same
submissions fire the same faults (equal ``FaultStats``), close the same
rounds with the same reasons and fills, and give aggregates within rtol
1e-5, for unbucketed Krum and CM."""
import json
import os

import numpy as np
import pytest

from repro.api import AggregatorSpec as RAggregatorSpec
from repro.api import ClipSpec as RClipSpec
from repro.api import ScheduleSpec as RScheduleSpec
from repro.api import ServerPlan as RServerPlan
from repro.serve import AggregationServer as RAggregationServer
from repro.serve import FaultInjector as RFaultInjector
from repro.serve import FaultPlan as RFaultPlan
from repro.serve import ServeConfig as RServeConfig
from repro_torch.api import AggregatorSpec, ClipSpec, ScheduleSpec, ServerPlan
from repro_torch.kernels import _build
from repro_torch.serve import (
    AggregationServer,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    ServeConfig,
    canonical_fault_plan,
    load_fault_plan,
)
from repro_torch.serve.server import _DEVICE_FAULTS

CPU = "cpu"


def _plan(rule="cm", *, radius=None, backend="torch"):
    return ServerPlan(
        aggregate=AggregatorSpec(rule, byz_bound=1),
        clip=ClipSpec(radius=radius) if radius is not None else None,
        schedule=ScheduleSpec(placement="naive", backend=backend))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# FaultPlan: the replayable-config contract
# ---------------------------------------------------------------------------

def test_fault_plan_json_round_trip_and_matches_reference():
    p = canonical_fault_plan(seed=3)
    assert FaultPlan.from_json(p.to_json()) == p
    d = json.loads(p.to_json())
    assert d["version"] == 1 and d["seed"] == 3
    from repro.serve import canonical_fault_plan as rcanonical

    assert p.to_json() == rcanonical(seed=3).to_json()
    assert FaultPlan.from_json(rcanonical(seed=3).to_json()) == p


def test_fault_plan_rejects_unknown_fields_and_bad_values():
    with pytest.raises(ValueError, match="unknown fault-plan fields"):
        FaultPlan.from_dict({"dropout": 0.1, "typo_field": 1})
    with pytest.raises(ValueError, match="version"):
        FaultPlan.from_dict({"version": 99})
    with pytest.raises(ValueError, match="probability"):
        FaultPlan(dropout=1.5)
    with pytest.raises(ValueError, match="max_delay_pumps"):
        FaultPlan(max_delay_pumps=0)
    with pytest.raises(ValueError, match="clock_skew"):
        FaultPlan(clock_skew=-1.0)
    with pytest.raises(ValueError, match="not a fault-plan JSON"):
        FaultPlan.from_json("{not json")


def test_load_fault_plan_inline_and_path(tmp_path):
    assert load_fault_plan("") is None
    p = canonical_fault_plan()
    assert load_fault_plan(p.to_json()) == p
    f = tmp_path / "plan.json"
    f.write_text(p.to_json())
    assert load_fault_plan(str(f)) == p


def test_committed_canonical_plan_file_matches_the_function():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "fault_canonical.json")
    assert load_fault_plan(path) == canonical_fault_plan()


def test_inactive_plan_reports_inactive():
    assert not FaultPlan().active
    assert FaultPlan(dropout=0.1).active
    assert FaultPlan(clock_skew=0.5).active


# ---------------------------------------------------------------------------
# FaultInjector: deterministic chaos
# ---------------------------------------------------------------------------

def _drive_chaos(server_cls, injector_cls, cfg_cls, plan, fault_plan, *,
                 rounds=4, n=8, d=16, seed=0, deadline=5.0, **server_kw):
    """Drive a deadline-backstopped server through ``rounds`` closed rounds
    under ``fault_plan`` (either package: the classes are passed in);
    returns (results, server, injector)."""
    clock = _Clock()
    cfg = cfg_cls(n_slots=n, dim=d, cohort_size=n - 2, deadline=deadline,
                  seed=seed)
    server = server_cls(plan, cfg, clock=clock, **server_kw)
    inj = injector_cls(fault_plan, server)
    rng = np.random.RandomState(seed)
    results = []
    submissions = 0
    while len(results) < rounds:
        slot = submissions % n
        inj.submit(slot, rng.randn(d).astype(np.float32))
        submissions += 1
        clock.t += 0.1  # the deadline backstop closes starved rounds
        results.extend(inj.pump())
        assert submissions < 10_000, "chaos drive failed to close rounds"
    return results, server, inj


def _drive(plan, fault_plan, **kw):
    return _drive_chaos(AggregationServer, FaultInjector, ServeConfig, plan,
                        fault_plan, device=CPU, **kw)


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_canonical_chaos_closes_every_round_finite(backend):
    plan = _plan("krum", radius=5.0, backend=backend)
    results, server, inj = _drive(plan, canonical_fault_plan())
    assert len(results) >= 4
    assert [r.round_id for r in results] == list(range(len(results)))
    for r in results:
        assert np.all(np.isfinite(r.aggregate))
    s = inj.stats.snapshot()
    assert s["dropped"] > 0 or s["delayed"] > 0 or s["duplicated"] > 0
    assert server.metrics.rows_ingested > 0


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_chaos_replay_is_bitwise_deterministic(backend):
    plan = _plan("krum", radius=5.0, backend=backend)
    fp = canonical_fault_plan(seed=11)
    res_a, _, inj_a = _drive(plan, fp, seed=2)
    res_b, _, inj_b = _drive(plan, fp, seed=2)
    assert inj_a.stats.snapshot() == inj_b.stats.snapshot()
    assert len(res_a) == len(res_b)
    for a, b in zip(res_a, res_b):
        assert a.round_id == b.round_id
        assert a.close_reason == b.close_reason
        np.testing.assert_array_equal(a.aggregate, b.aggregate)


def test_certain_executor_crash_degrades_every_round():
    plan = _plan("krum", radius=2.0)
    results, server, inj = _drive(plan, FaultPlan(executor_crash=1.0),
                                  rounds=3)
    assert inj.stats.executor_crashes == len(results)
    assert server.metrics.executor_faults == len(results)
    for r in results:
        assert r.degraded
        assert r.fallback_reason == "executor_error:InjectedFault"
        assert np.all(np.isfinite(r.aggregate))


def test_injected_fault_is_a_runtime_error_not_a_device_fault():
    assert issubclass(InjectedFault, RuntimeError)
    assert not issubclass(InjectedFault, _DEVICE_FAULTS)


def test_kernel_fault_still_propagates_through_the_crash_hook():
    """The crash hook wraps the close; a KernelError from the close it
    wraps is still the server's fault and leaves pump()."""
    srv = AggregationServer(_plan("krum", radius=2.0),
                            ServeConfig(n_slots=4, dim=4, cohort_size=2),
                            device=CPU)

    def broken(key=None):
        raise _build.KernelError("launch failed")

    srv._builder.close = broken
    inj = FaultInjector(FaultPlan(seed=1, executor_crash=1e-12), srv)
    inj.submit(0, np.ones(4))
    inj.submit(1, 3 * np.ones(4))
    with pytest.raises(_build.KernelError, match="launch failed"):
        inj.pump()
    assert srv.metrics.rounds_closed == 0 and srv.metrics.executor_faults == 0


def test_dropout_one_drops_everything():
    cfg = ServeConfig(n_slots=4, dim=8)
    inj = FaultInjector(FaultPlan(dropout=1.0),
                        AggregationServer(_plan("cm"), cfg, device=CPU))
    assert inj.submit(0, np.ones(8)) == []
    assert inj.stats.dropped == 1
    assert inj.pump() == []
    assert inj.metrics.rows_ingested == 0


def test_delayed_rows_release_within_max_delay_pumps():
    cfg = ServeConfig(n_slots=4, dim=8, cohort_size=4)
    inj = FaultInjector(FaultPlan(delay=1.0, max_delay_pumps=2),
                        AggregationServer(_plan("cm"), cfg, device=CPU))
    for slot in range(4):
        assert inj.submit(slot, np.ones(8)) == []  # all held back
    assert inj.stats.delayed == 4
    closed = []
    for _ in range(3):  # every held row is due within max_delay_pumps
        closed.extend(inj.pump())
    assert inj.stats.released == 4
    assert len(closed) == 1 and closed[0].cohort_fill == 4


def test_flush_force_delivers_held_rows():
    cfg = ServeConfig(n_slots=4, dim=8, cohort_size=2)
    inj = FaultInjector(FaultPlan(delay=1.0, max_delay_pumps=3),
                        AggregationServer(_plan("cm"), cfg, device=CPU))
    inj.submit(0, np.ones(8))
    inj.submit(1, np.ones(8))
    tickets = inj.flush()
    assert len(tickets) == 2 and inj.stats.released == 2
    assert len(inj.pump()) == 1
    assert inj.round_id == 1


def test_clock_skew_hook_replaces_the_server_clock():
    clock = _Clock()
    server = AggregationServer(_plan("cm"), ServeConfig(n_slots=4, dim=8),
                               clock=clock, device=CPU)
    base = server._clock
    FaultInjector(FaultPlan(clock_skew=0.5), server)
    assert server._clock is not base
    assert abs(server._clock() - clock.t) <= 0.5


def test_malformed_rows_never_poison_the_round():
    """NaN and wrong-shape submissions resolve with structured errors and
    the round closes bit for bit like a server that never saw them."""
    plan = _plan("krum", radius=5.0)
    cfg = ServeConfig(n_slots=6, dim=8, cohort_size=4, seed=9)
    rows = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    victim = AggregationServer(plan, cfg, device=CPU)
    bad_nan = rows[0].copy()
    bad_nan[3] = np.nan
    t_nan = victim.submit(0, bad_nan)
    t_shape = victim.submit(1, rows[0][:5])
    t_inf = victim.submit(2, np.full(8, np.inf, np.float32))
    t_slot = victim.submit(99, rows[0])
    for t, code in ((t_nan, "non_finite"), (t_shape, "wrong_shape"),
                    (t_inf, "non_finite"), (t_slot, "bad_slot")):
        assert t.status == "rejected" and t.error.code == code
        assert t.latency is not None
    for slot in range(4):
        victim.submit(slot, rows[slot])
    closed_victim = victim.pump()
    oracle = AggregationServer(plan, cfg, device=CPU)
    for slot in range(4):
        oracle.submit(slot, rows[slot])
    closed_oracle = oracle.pump()
    assert len(closed_victim) == len(closed_oracle) == 1
    np.testing.assert_array_equal(closed_victim[0].aggregate,
                                  closed_oracle[0].aggregate)
    assert victim.metrics.rows_rejected == 4
    assert victim.metrics.rows_ingested == 4


# ---------------------------------------------------------------------------
# parity: one plan, one submission stream, both packages' injectors
# ---------------------------------------------------------------------------

_PARITY_PLANS = {  # name: (fault plan, deadline seconds)
    "canonical": (canonical_fault_plan(seed=11).to_dict(), 5.0),
    # crashes, clock skew and a tight deadline: deadline closes at fills
    # 1-5, two of them crashed into the fallback
    "crash-skew": (dict(canonical_fault_plan(seed=12).to_dict(),
                        executor_crash=0.3, clock_skew=0.15), 0.45),
}


@pytest.mark.parametrize("fault", sorted(_PARITY_PLANS))
@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("rule,radius", [("krum", 5.0), ("krum", None),
                                         ("cm", None), ("cm", 5.0)])
def test_injector_matches_reference_injector(rule, radius, backend, fault):
    fault_doc, deadline = _PARITY_PLANS[fault]
    doc = json.dumps(fault_doc)
    rplan = RServerPlan(
        aggregate=RAggregatorSpec(rule, byz_bound=1),
        clip=RClipSpec(radius=radius) if radius else None,
        schedule=RScheduleSpec(placement="naive", backend="jnp"))
    tplan = ServerPlan.from_json(rplan.to_json().replace('"jnp"',
                                                         f'"{backend}"'))
    kw = dict(rounds=6, n=8, d=24, seed=4, deadline=deadline)
    want, _, rinj = _drive_chaos(RAggregationServer, RFaultInjector,
                                 RServeConfig, rplan,
                                 RFaultPlan.from_json(doc), **kw)
    got, _, tinj = _drive(tplan, FaultPlan.from_json(doc), **kw)
    assert tinj.stats.snapshot() == rinj.stats.snapshot()
    assert tinj.stats.snapshot()["submitted"] > 0
    if fault == "crash-skew":
        assert tinj.stats.executor_crashes > 0
        assert any(g.close_reason == "deadline" for g in got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.round_id, g.close_reason, g.cohort_fill, g.degraded,
                g.fallback_reason) == (w.round_id, w.close_reason,
                                       w.cohort_fill, w.degraded,
                                       w.fallback_reason)
        np.testing.assert_allclose(g.aggregate, np.asarray(w.aggregate),
                                   rtol=1e-5, atol=1e-6)
