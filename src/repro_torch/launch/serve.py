"""The serving launcher, the counterpart of ``repro.launch.serve``: its
three products.

1. **Model serving** (``--mode decode``, the default): batched prefill
   and incremental decode, one new token a step against the KV cache
   (``make_serve_step``: greedy argmax, int32 tokens; ``decode_32k`` is
   batch 128 x cache 32,768).  The CLI decodes the ``--arch`` smoke
   config with random weights, as the reference's does.
2. **Robust scoring** (``--mode score``): each request carries an (n, d)
   matrix of client updates; :func:`make_scoring_step` runs the plan's
   clip -> bucket -> aggregate composition on it (through the kernels on
   the card) and returns the robust aggregate with per-client
   diagnostics: distance to the aggregate (the outlier score), clip
   factor and message norm.  A request carries no iterate pair, so plans
   clip with a static ``ClipSpec(radius=)`` or not at all.
3. **Streaming aggregation** (``--mode stream``): synthetic clients
   submit rows one at a time, the server (``repro_torch.serve``)
   assembles them into per-round cohorts on the card, closes a round on
   a cohort-size or deadline trigger and fans the aggregate out to every
   submitter's ticket; ``--fault-json`` injects a fault plan, and
   ``--ckpt-dir`` / ``--resume`` make the run survive a SIGKILL.

    python -m repro_torch.launch.serve --arch jamba_v01_52b --tokens 24
    python -m repro_torch.launch.serve --mode score --aggregator krum \\
        --requests 8 --clients 16 --dim 4096 --clip-radius 5.0
    python -m repro_torch.launch.serve --mode stream --aggregator krum \\
        --clients 16 --dim 4096 --rounds 8 --cohort-size 12
    python -m repro_torch.launch.serve --mode stream --device cpu ...

Every mode runs on the card unless ``--device cpu`` is given.

The client stream is stateless: block b of n submissions is drawn from
``np.random.RandomState([seed, b])`` by ``SyntheticCohort``, as the
reference draws it, so both packages serve the same honest rows, and a
resumed run regenerates the stream from its checkpointed cursor.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..api import PlanError, ServerPlan
from ..kernels.clip_aggregate import clip_factor
from ..models.model import apply_decode, apply_prefill, init_cache, init_params
from ..serve.server import round_key

__all__ = ["make_prefill_step", "make_serve_step", "abstract_serve_inputs",
           "decode_batch", "run_stream", "latency_ms", "make_scoring_step",
           "abstract_scoring_inputs", "main"]


# ---------------------------------------------------------------------------
# model serving (decode path)
# ---------------------------------------------------------------------------

def make_prefill_step(model_cfg):
    def prefill_step(params, batch):
        return apply_prefill(params, model_cfg, batch)

    return prefill_step


def make_serve_step(model_cfg):
    """serve_step(params, batch, cache, cache_index) -> (next_token,
    logits, cache): greedy next tokens (B,) int32, the logits (B, vocab)
    f32 and the cache with the step's keys and values written in."""

    def serve_step(params, batch, cache, cache_index):
        with torch.no_grad():
            logits, new_cache = apply_decode(params, model_cfg, batch, cache,
                                             cache_index)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step


def abstract_serve_inputs(model_cfg, batch: int, cache_len: int):
    """(params, batch, cache, cache_index) on "meta" tensors: the shapes
    and dtypes of a decode step, nothing allocated."""
    params = init_params(0, model_cfg, device="meta")
    b = {"tokens": torch.empty((batch, 1), dtype=torch.int32, device="meta")}
    if model_cfg.input_kind == "tokens+vision":
        b["vision"] = torch.empty(
            (batch, model_cfg.n_vision_tokens, model_cfg.d_model),
            dtype=model_cfg.jdtype, device="meta")
    cache = init_cache(model_cfg, batch, cache_len, device="meta")
    idx = torch.empty((), dtype=torch.int32, device="meta")
    return params, b, cache, idx


def decode_batch(model_cfg, tokens):
    """A decode step's batch: ``tokens`` (B, 1), with the VLM's vision
    tokens (zeros) when the config takes them."""
    batch = {"tokens": tokens}
    if model_cfg.input_kind == "tokens+vision":
        batch["vision"] = torch.zeros(
            (tokens.shape[0], model_cfg.n_vision_tokens, model_cfg.d_model),
            dtype=model_cfg.jdtype, device=tokens.device)
    return batch


def _main_decode(args):
    from ..configs.registry import get_smoke_config

    cfg = get_smoke_config(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    dev = resolve_device(args.device)
    params = init_params(0, cfg, device=dev)
    step = make_serve_step(cfg)
    cache = init_cache(cfg, args.batch, args.tokens + 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (args.batch, 1), generator=gen,
                        dtype=torch.int32, device=dev)
    t0 = time.time()
    for t in range(args.tokens):
        nxt, _, cache = step(params, decode_batch(cfg, tok), cache, t)
        tok = nxt[:, None]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {args.tokens} tokens x batch {args.batch} in "
          f"{time.time() - t0:.2f}s (device={dev})")


# ---------------------------------------------------------------------------
# robust scoring (ServerPlan path)
# ---------------------------------------------------------------------------

def _request_keys(key, batch: int):
    """Each request's Bucketing order source: ``key`` None or an int seed
    gives ``round_key(seed, b)`` for request b; otherwise ``key`` is a
    (B, n) array of permutations, one a request."""
    if key is None or isinstance(key, int):
        seed = 0 if key is None else key
        return [round_key(seed, b) for b in range(batch)]
    perms = torch.as_tensor(np.asarray(key), dtype=torch.long)
    if perms.ndim != 2 or perms.shape[0] != batch:
        raise ValueError(f"key must hold one permutation per request: "
                         f"({batch}, n); got {tuple(perms.shape)}")
    return list(perms)


def make_scoring_step(plan: ServerPlan, device=None):
    """Compile ``plan`` into a batched robust-scoring endpoint on
    ``device`` (the card unless "cpu").

    ``scoring_step(batch_xs, batch_mask=None, key=None)`` takes a (B, n, d)
    batch of requests (B independent cohorts of n client updates) and
    returns a dict of per-request results, tensors on the device:

      aggregate   (B, d)  the plan's robust aggregate of each request
      distance    (B, n)  per-client l2 distance to the aggregate (the
                          outlier score)
      clip_factor (B, n)  the server-clip scale each client received
                          (1.0 everywhere for plans without a clip stage)
      norm        (B, n)  per-client message norms

    ``batch_mask`` (B, n) marks each request's participating clients
    (None: all).  ``key`` is Bucketing's order: None or an int seed (a
    generator ``round_key(seed, b)`` for request b), or a (B, n) array of
    permutations.  Requests run one after another, so each aggregate is
    the plan's step at the shapes the trainer and the server run."""
    if plan.schedule.placement != "naive":
        raise PlanError(
            "the scoring endpoint aggregates each request whole-message "
            "in-process; use ScheduleSpec(placement='naive'): the sharded "
            "placement is a mesh-trainer schedule")
    if plan.clip is not None and plan.clip.radius is None:
        raise PlanError(
            "scoring requests carry no iterate pair, so the data-dependent "
            "ClipSpec(alpha) radius is undefined here; use "
            "ClipSpec(radius=...) for a static server clip, or drop the "
            "clip stage")
    dev = resolve_device(device)
    step = plan.build()
    radius = None if plan.clip is None else float(plan.clip.radius)

    def scoring_step(batch_xs, batch_mask=None, key=None):
        xs = torch.as_tensor(batch_xs).to(dev)
        batch, n = xs.shape[0], xs.shape[1]
        if batch_mask is None:
            mask = torch.ones((batch, n), dtype=torch.bool, device=dev)
        else:
            mask = torch.as_tensor(batch_mask).to(dev, torch.bool)
        out = {"aggregate": [], "distance": [], "clip_factor": [],
               "norm": []}
        for b, k in enumerate(_request_keys(key, batch)):
            x32 = xs[b].float()
            agg = step(xs[b], mask=mask[b], key=k).float()
            norms = torch.sqrt((x32 * x32).sum(dim=1))
            out["aggregate"].append(agg)
            out["distance"].append(
                torch.sqrt(((x32 - agg[None, :]) ** 2).sum(dim=1)))
            out["clip_factor"].append(
                torch.ones_like(norms) if radius is None
                else clip_factor(norms, radius))
            out["norm"].append(norms)
        return {name: torch.stack(v) for name, v in out.items()}

    return scoring_step


def abstract_scoring_inputs(batch: int, n_clients: int, dim: int,
                            dtype=torch.float32):
    """(batch_xs, batch_mask, key) on "meta" tensors, with the shapes and
    dtypes of the reference's scoring inputs: (batch, n_clients, dim) of
    ``dtype``, (batch, n_clients) bool and a (2,) uint32 key.  The port's
    ``scoring_step`` takes its Bucketing orders from an int seed or
    per-request permutations instead of that key (``_request_keys``)."""
    return (torch.empty((batch, n_clients, dim), dtype=dtype, device="meta"),
            torch.empty((batch, n_clients), dtype=torch.bool, device="meta"),
            torch.empty((2,), dtype=torch.uint32, device="meta"))


def _main_score(args):
    from .cli import plan_from_args

    plan = plan_from_args(
        args, byz_bound=args.n_byz,
        clip_radius=args.clip_radius if args.clip_radius > 0 else None)
    dev = resolve_device(args.device)
    scoring = make_scoring_step(plan, dev)
    B, n, d = args.requests, args.clients, args.dim
    rng = np.random.RandomState(0)
    xs = rng.randn(B, n, d).astype(np.float32)
    # the trailing n_byz clients of every request send 100x payloads
    if args.n_byz:
        xs[:, n - args.n_byz:, :] *= 100.0
    batch = torch.from_numpy(xs).to(dev)

    def call():
        out = scoring(batch, key=2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    call()  # warm-up: loads the kernels
    t0 = time.perf_counter()
    out = call()
    wall = time.perf_counter() - t0
    dist = out["distance"].cpu().numpy()
    flagged = (dist > np.median(dist, axis=1, keepdims=True) * 3.0).sum(1)
    print(f"[serve] scored {B} requests x {n} clients x d={d} "
          f"(rule={plan.aggregate.rule}, device={dev}) in {wall * 1e3:.1f} "
          f"ms ({wall / B * 1e3:.2f} ms/request)")
    print(f"[serve] outliers flagged per request: {flagged.tolist()}")


# ---------------------------------------------------------------------------
# streaming aggregation
# ---------------------------------------------------------------------------

def run_stream(front, cohort, *, rounds: int, seed: int,
               rows_per_pump: int = 1, on_round=None, cursor: int = 0,
               on_pump=None):
    """Drive ``front`` (a server, or a ``FaultInjector`` around one) with
    ``cohort``'s synthetic clients until ``rounds`` rounds have closed:
    slots submit round-robin from submission ``cursor`` on,
    ``rows_per_pump`` rows between pumps; ``on_round(result)`` sees every
    closed round, then ``on_pump(cursor, closed)`` every pump.  Returns
    (tickets, wall seconds)."""
    n = cohort.n_slots
    block, block_rows, tickets = -1, None, []
    t0 = time.perf_counter()
    while front.metrics.rounds_closed < rounds:
        for _ in range(rows_per_pump):
            b, slot = divmod(cursor, n)
            if b != block:
                block_rows = cohort.round_rows(np.random.RandomState([seed, b]))
                block = b
            got = front.submit(slot, block_rows[slot])
            tickets.extend(got if isinstance(got, list) else [got])
            cursor += 1
        closed = front.pump()
        if on_round is not None:
            for result in closed:
                on_round(result)
        if on_pump is not None:
            on_pump(cursor, closed)
    return tickets, time.perf_counter() - t0


def latency_ms(tickets) -> dict:
    """p50 and p99 submit-to-resolution milliseconds of resolved tickets."""
    lat = np.asarray([t.latency for t in tickets if t.done]) * 1e3
    if lat.size == 0:
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def _main_stream(args):
    """The stream-mode loop, with the reference's determinism contract:
    the client stream is a pure function of (seed, cursor), and every
    checkpoint stores (server state, cursor) at a pump boundary, so a run
    SIGKILLed at any instant and restarted with ``--resume`` replays the
    lost submissions and closes every round with an aggregate bit for bit
    equal to the uninterrupted run's."""
    from ..scenarios import SyntheticCohort
    from ..serve import (AggregationServer, FaultInjector, ServeConfig,
                         recovery)
    from .cli import fault_plan_from_args, plan_from_args, scenario_from_args

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
    fault_plan = fault_plan_from_args(args)
    front = server
    if fault_plan is not None and fault_plan.active:
        front = FaultInjector(fault_plan, server)
        print(f"[serve] fault injection ON: {fault_plan.to_json()}")
    cohort = SyntheticCohort(scenario.build(), n_slots=n, dim=d, n_byz=n_byz,
                             z_max=scenario.z_max)

    cursor = 0  # synthetic submissions so far (slot = cursor % n)
    if args.ckpt_dir and args.resume:
        restored = recovery.restore_server(
            server, args.ckpt_dir, extra_template={"cursor": np.int64(0)})
        if restored is not None:
            step, extra = restored
            cursor = int(np.asarray(extra["cursor"]))
            print(f"[serve] resumed from checkpoint step {step} "
                  f"(round {server.round_id}, cursor {cursor})")
        else:
            print(f"[serve] --resume but no usable checkpoint in "
                  f"{args.ckpt_dir!r}; starting fresh")
    rows0 = server.metrics.rows_ingested  # rows of a run resumed from
    ckpt = None
    if args.ckpt_dir:
        ckpt = recovery.ServerCheckpointer(server, args.ckpt_dir,
                                           every=args.ckpt_every)
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
        # durable before the next pump: a SIGKILL loses no emitted round
        emit.flush()
        os.fsync(emit.fileno())

    def after_pump(cur, closed):
        if ckpt is not None and closed:
            ckpt.observe(len(closed), extra={"cursor": np.int64(cur)})
        if args.pump_sleep_ms > 0:
            time.sleep(args.pump_sleep_ms / 1e3)

    try:
        tickets, wall = run_stream(front, cohort, rounds=args.rounds,
                                   seed=args.seed, on_round=emit_round,
                                   cursor=cursor, on_pump=after_pump)
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
    print(f"[serve]   rows_per_s = {(m['rows_ingested'] - rows0) / wall:.1f}"
          f"  p50_ms = {lat['p50_ms']}  p99_ms = {lat['p99_ms']}  "
          f"wall_s = {wall:.3f}")
    for k, v in sorted(m.items()):
        print(f"[serve]   {k} = {v}")
    if isinstance(front, FaultInjector):
        for k, v in sorted(front.stats.snapshot().items()):
            print(f"[serve]   fault.{k} = {v}")


def main(argv=None):
    import argparse

    from .cli import add_attack_args, add_fault_args, add_plan_args

    ap = argparse.ArgumentParser(description="serving launcher")
    ap.add_argument("--mode", default="decode",
                    choices=["decode", "score", "stream"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    # decode-mode flags
    ap.add_argument("--arch", default="minitron_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--requests", type=int, default=8,
                    help="score mode: requests in the batch")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--n-byz", type=int, default=2)
    ap.add_argument("--clip-radius", type=float, default=0.0,
                    help="> 0: static server clip radius (ClipSpec(radius=))")
    ap.add_argument("--rounds", type=int, default=4,
                    help="stream mode: rounds to run before exiting")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="stream mode: close a round after this many "
                         "distinct rows (0: wait for every client)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="stream mode: close a non-empty round after this "
                         "many ms (0: no deadline)")
    ap.add_argument("--stale-policy", default="drop",
                    choices=["drop", "defer"])
    ap.add_argument("--stale-discount", type=float, default=0.5)
    ap.add_argument("--duplicate-policy", default="last_wins",
                    choices=["first_wins", "last_wins", "reject"])
    ap.add_argument("--min-fill", type=int, default=1,
                    help="stream mode: deadline closes below this fill use "
                         "the clipping-only fallback aggregate")
    ap.add_argument("--seed", type=int, default=0,
                    help="stream mode: seed of the client stream and of the "
                         "rounds' Bucketing order")
    ap.add_argument("--ckpt-dir", default="",
                    help="stream mode: directory for crash-safe server "
                         "snapshots (empty: no checkpointing)")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="stream mode: snapshot once per this many closed "
                         "rounds")
    ap.add_argument("--resume", action="store_true",
                    help="stream mode: resume from the newest complete "
                         "checkpoint in --ckpt-dir (fresh start if none)")
    ap.add_argument("--emit-rounds", default="",
                    help="stream mode: append one JSON line per closed "
                         "round (the aggregate's exact bits in hex) to this "
                         "file")
    ap.add_argument("--pump-sleep-ms", type=float, default=0.0,
                    help="stream mode: sleep after each pump (a testing "
                         "knob: widens the kill window of the "
                         "kill-and-resume test)")
    add_plan_args(ap, placement="naive")
    add_attack_args(ap, attack="gauss")
    add_fault_args(ap)
    args = ap.parse_args(argv)
    if args.mode == "score":
        _main_score(args)
    elif args.mode == "stream":
        _main_stream(args)
    else:
        _main_decode(args)


if __name__ == "__main__":
    main()
