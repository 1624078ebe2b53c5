#!/usr/bin/env python3
"""Time the port's streaming server over a long window on one CUDA card.

    python3 tools/serve_window.py [--rounds N] [--dim D]
        [--arrival steady|burst] [--rule krum|multi_krum|cm]
        [--profile-rounds M]

The serve launcher's configuration (16 slots, the trailing 4 under ALIE,
cohort 12, Krum with byz_bound 4 and a static clip radius 5.0, backend
"auto"; CM without clip).  The clients' rows are drawn before the clock
starts (one ``RandomState([seed, block])`` block of 16 rows per 16
submissions, as ``repro_torch.launch.serve`` draws them), so the window
times the server alone.  Two windows, after two warm-up rounds:

1. ``--rounds`` rounds, unprofiled: rows per second, p50/p90/p99 and the
   largest submit-to-resolution ms over every row, and the host's
   seconds per row in ``submit`` and in ``pump``;
2. ``--profile-rounds`` rounds under ``torch.profiler``: the card's busy
   ms per row (the sum of the device times of the kernels and copies it
   ran), the five device events with the most of it, and from it the
   device's idle share of window 1's wall time, 1 - busy per row * rows
   per second.

Prints one JSON line.  Needs a card (and nvcc for the kernels).
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _busy_us(prof):
    """Microseconds of the device's events (kernels, copies) in the
    profiled window, by event name; empty when the profiler saw none."""
    from torch.autograd import DeviceType

    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us())
    return by_name


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=250)
    ap.add_argument("--profile-rounds", type=int, default=25)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--arrival", default="steady", choices=["steady", "burst"])
    ap.add_argument("--rule", default="krum",
                    choices=["krum", "multi_krum", "cm"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("serve_window: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.api import (AggregatorSpec, ClipSpec, ScheduleSpec,
                                 ServerPlan)
    from repro_torch.scenarios import SyntheticCohort
    from repro_torch.serve import AggregationServer, ServeConfig

    n, byz, cohort_size = 16, 4, 12
    plan = ServerPlan(
        aggregate=AggregatorSpec(args.rule, byz_bound=byz),
        clip=None if args.rule == "cm" else ClipSpec(radius=5.0),
        schedule=ScheduleSpec(placement="naive", backend="auto"))
    server = AggregationServer(
        plan, ServeConfig(n_slots=n, dim=args.dim, cohort_size=cohort_size,
                          seed=args.seed), device="cuda")
    cohort = SyntheticCohort("alie", n_slots=n, dim=args.dim, n_byz=byz)
    per_pump = cohort_size if args.arrival == "burst" else 1
    total = 2 + args.rounds + args.profile_rounds
    rows_needed = total * cohort_size + cohort_size
    blocks = [cohort.round_rows(np.random.RandomState([args.seed, b]))
              for b in range(-(-rows_needed // n))]
    cursor = 0

    def window(rounds):
        nonlocal cursor
        tickets, t_submit, t_pump = [], 0.0, 0.0
        target = server.metrics.rounds_closed + rounds
        t0 = time.perf_counter()
        while server.metrics.rounds_closed < target:
            t1 = time.perf_counter()
            for _ in range(per_pump):
                b, slot = divmod(cursor, n)
                tickets.append(server.submit(slot, blocks[b][slot]))
                cursor += 1
            t2 = time.perf_counter()
            server.pump()
            t_pump += time.perf_counter() - t2
            t_submit += t2 - t1
        torch.cuda.synchronize()
        return tickets, time.perf_counter() - t0, t_submit, t_pump

    window(2)  # warm-up: builds and loads the kernels
    tickets, wall, t_submit, t_pump = window(args.rounds)
    done = [t for t in tickets if t.done]
    lat = np.asarray([t.latency for t in done]) * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ptickets, pwall, _, _ = window(args.profile_rounds)
    prows = sum(1 for t in ptickets if t.done)
    busy = _busy_us(prof)
    busy_ms_per_row = sum(busy.values()) / 1e3 / max(prows, 1)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    rows_per_s = len(done) / wall
    m = server.metrics
    if m.executor_faults or m.rounds_degraded:
        sys.exit(f"serve_window: faults or degraded rounds {m.snapshot()}")
    print(json.dumps({
        "rule": args.rule, "arrival": args.arrival, "dim": args.dim,
        "rounds": args.rounds, "rows": len(done), "wall_s": wall,
        "rows_per_s": rows_per_s,
        "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)),
        "p99_ms": float(np.percentile(lat, 99)),
        "max_ms": float(lat.max()),
        "submit_ms_per_row": t_submit * 1e3 / len(done),
        "pump_ms_per_row": t_pump * 1e3 / len(done),
        "profiled_rows": prows, "profiled_wall_s": pwall,
        "device_busy_ms_per_row": busy_ms_per_row,
        "device_top_ms_per_row": {name[:60]: us / 1e3 / prows
                                  for name, us in top},
        "device_idle_share": (None if busy_ms_per_row == 0
                              else 1.0 - busy_ms_per_row * rows_per_s / 1e3),
        "chunks_ingested": m.chunks_ingested,
        "rows_ingested": m.rows_ingested,
    }))


if __name__ == "__main__":
    main()
