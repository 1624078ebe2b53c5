"""The streaming aggregation server as a command, the counterpart of
``repro.launch.serve --mode stream``: synthetic clients submit rows one
at a time, the server (``repro_torch.serve``) assembles them into
per-round cohorts on the card (the incremental Gram for the selection
rules), closes a round on a cohort-size or deadline trigger and fans the
aggregate out to every submitter's ticket.

    python -m repro_torch.launch.serve --mode stream --aggregator krum \\
        --clients 16 --dim 4096 --rounds 8 --cohort-size 12
    python -m repro_torch.launch.serve --mode stream --device cpu ...

It runs on the card unless ``--device cpu`` is given.  The reference's
other modes are not ported yet and raise: ``--mode score`` (the
robust-scoring endpoint) waits for ROADMAP queue 1, "the score and decode
modes", and ``--mode decode`` (model serving on the mesh) for the mesh
trainer and then that item.  The fault injector and checkpoints
(``--fault-json``, ``--ckpt-dir``, ``--resume``) come with "serve faults,
recovery and checkpoints".

The client stream is stateless: block b of n submissions is drawn from
``np.random.RandomState([seed, b])`` by ``SyntheticCohort``, as the
reference draws it, so both packages serve the same honest rows.
"""
from __future__ import annotations

import json
import time

import numpy as np

__all__ = ["run_stream", "latency_ms", "main"]

def run_stream(server, cohort, *, rounds: int, seed: int,
               rows_per_pump: int = 1, on_round=None):
    """Drive ``server`` with ``cohort``'s synthetic clients until ``rounds``
    rounds have closed: slots submit round-robin, ``rows_per_pump`` rows
    between pumps; ``on_round(result)`` sees every closed round.  Returns
    (tickets, wall seconds)."""
    n = server.config.n_slots
    cursor, block, block_rows, tickets = 0, -1, None, []
    t0 = time.perf_counter()
    while server.metrics.rounds_closed < rounds:
        for _ in range(rows_per_pump):
            b, slot = divmod(cursor, n)
            if b != block:
                block_rows = cohort.round_rows(np.random.RandomState([seed, b]))
                block = b
            tickets.append(server.submit(slot, block_rows[slot]))
            cursor += 1
        for result in server.pump():
            if on_round is not None:
                on_round(result)
    return tickets, time.perf_counter() - t0


def latency_ms(tickets) -> dict:
    """p50 and p99 submit-to-resolution milliseconds of resolved tickets."""
    lat = np.asarray([t.latency for t in tickets if t.done]) * 1e3
    if lat.size == 0:
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def _main_stream(args):
    from ..scenarios import SyntheticCohort
    from ..serve import AggregationServer, ServeConfig
    from .cli import plan_from_args, scenario_from_args

    n, d = args.clients, args.dim
    scenario = scenario_from_args(args)
    n_byz = scenario.n_byz(n) if scenario.byz_frac is not None else args.n_byz
    plan = plan_from_args(
        args, byz_bound=n_byz,
        clip_radius=args.clip_radius if args.clip_radius > 0 else None)
    cfg = ServeConfig(
        n_slots=n, dim=d, cohort_size=args.cohort_size or None,
        deadline=args.deadline_ms / 1e3 if args.deadline_ms > 0 else None,
        stale_policy=args.stale_policy, stale_discount=args.stale_discount,
        duplicate_policy=args.duplicate_policy, min_fill=args.min_fill,
        seed=args.seed)
    server = AggregationServer(plan, cfg, device=args.device)
    cohort = SyntheticCohort(scenario.build(), n_slots=n, dim=d, n_byz=n_byz,
                             z_max=scenario.z_max)
    emit = open(args.emit_rounds, "a") if args.emit_rounds else None

    def emit_round(r):
        if emit is None:
            return
        emit.write(json.dumps({
            "round_id": r.round_id, "close_reason": r.close_reason,
            "cohort_fill": r.cohort_fill, "degraded": r.degraded,
            "fallback_reason": r.fallback_reason,
            # the exact bits (float formatting would round)
            "aggregate_hex": np.asarray(r.aggregate, np.float32)
            .tobytes().hex(),
        }) + "\n")

    try:
        tickets, wall = run_stream(server, cohort, rounds=args.rounds,
                                   seed=args.seed, on_round=emit_round)
    finally:
        if emit is not None:
            emit.close()
    m = server.metrics.snapshot()
    lat = latency_ms(tickets)
    print(f"[serve] streamed {m['rows_ingested']} rows -> "
          f"{m['rounds_closed']} rounds ({m['rounds_degraded']} degraded, "
          f"rule={plan.aggregate.rule}, attack={cohort.attack.name} "
          f"x{n_byz}, cohort_size={cfg.resolved_cohort_size}/{n}, "
          f"device={server.device})")
    print(f"[serve]   rows_per_s = {m['rows_ingested'] / wall:.1f}  "
          f"p50_ms = {lat['p50_ms']}  p99_ms = {lat['p99_ms']}")
    for k, v in sorted(m.items()):
        print(f"[serve]   {k} = {v}")


def main(argv=None):
    import argparse

    from .cli import add_attack_args, add_plan_args

    ap = argparse.ArgumentParser(description="streaming aggregation server")
    ap.add_argument("--mode", default="stream",
                    choices=["decode", "score", "stream"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--n-byz", type=int, default=2)
    ap.add_argument("--clip-radius", type=float, default=0.0,
                    help="> 0: static server clip radius (ClipSpec(radius=))")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds to run before exiting")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="close a round after this many distinct rows "
                         "(0: wait for every client)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="close a non-empty round after this many ms "
                         "(0: no deadline)")
    ap.add_argument("--stale-policy", default="drop",
                    choices=["drop", "defer"])
    ap.add_argument("--stale-discount", type=float, default=0.5)
    ap.add_argument("--duplicate-policy", default="last_wins",
                    choices=["first_wins", "last_wins", "reject"])
    ap.add_argument("--min-fill", type=int, default=1,
                    help="deadline closes below this fill use the "
                         "clipping-only fallback aggregate")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the client stream and of the rounds' "
                         "Bucketing order")
    ap.add_argument("--emit-rounds", default="",
                    help="append one JSON line per closed round (the "
                         "aggregate's exact bits in hex) to this file")
    add_plan_args(ap, placement="naive")
    add_attack_args(ap, attack="gauss")
    args = ap.parse_args(argv)
    if args.mode == "score":
        raise NotImplementedError(
            "--mode score (the robust-scoring endpoint) is not ported yet "
            "(ROADMAP queue 1: the score and decode modes)")
    if args.mode == "decode":
        raise NotImplementedError(
            "--mode decode (model serving on the mesh) is not ported yet "
            "(ROADMAP queue 1: the mesh trainer on torch.distributed, then "
            "the score and decode modes)")
    _main_stream(args)


if __name__ == "__main__":
    main()
