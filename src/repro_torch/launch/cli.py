"""Shared CLI plumbing for the ServerPlan, scenario and fault-injection
flags, the counterpart of ``repro.launch.cli``:

    ap = argparse.ArgumentParser()
    add_plan_args(ap)
    args = ap.parse_args()
    plan = plan_from_args(args, byz_bound=args.n_byz, clip_radius=5.0)

``--plan-json`` takes an inline ``ServerPlan.to_json()`` document or a
path to one and overrides the individual flags; the document is the one
the reference reads.
"""
from __future__ import annotations

import os
from typing import Optional

from ..api import (
    AggregatorSpec,
    BucketSpec,
    ClipSpec,
    CompressSpec,
    ScenarioSpec,
    ScheduleSpec,
    ServerPlan,
)

__all__ = ["add_attack_args", "add_fault_args", "add_plan_args",
           "fault_plan_from_args", "plan_from_args", "scenario_from_args"]


def add_plan_args(ap, *, aggregator: str = "cm", placement: str = "sharded",
                  backend: str = "auto", bucket_s: int = 0):
    """Register the ServerPlan flags on ``ap`` (one group, shared by every
    CLI)."""
    g = ap.add_argument_group(
        "server plan",
        "the clip -> compress -> bucket -> aggregate -> schedule "
        "composition (repro_torch.api.ServerPlan)")
    g.add_argument("--aggregator", default=aggregator,
                   help="registry rule (cm, trimmed_mean, mean, rfa, krum, "
                        "multi_krum, centered_clip; aliases tm/cclip/gm)")
    g.add_argument("--agg-schedule", default=placement,
                   choices=["naive", "sharded"], dest="agg_schedule",
                   help="placement: naive (paper parameter-server) or "
                        "sharded (all_to_all scatter/aggregate/gather)")
    g.add_argument("--schedule", default="sequential",
                   choices=["sequential", "pipelined"],
                   help="inner block schedule of the sharded placement")
    g.add_argument("--superleaf-elems", type=int, default=0,
                   help="> 0: pack the message into uniform chunks of this "
                        "many coordinates (sharded placement)")
    g.add_argument("--backend", default=backend,
                   choices=["auto", "torch", "cuda", "jnp", "pallas"],
                   help="aggregation backend (auto = the CUDA kernels iff "
                        "the rows are on the card; jnp/pallas read as "
                        "torch/cuda)")
    g.add_argument("--bucket-s", type=int, default=bucket_s,
                   help=">= 2 composes the rule with Bucketing over "
                        "buckets of this size; 0 disables Bucketing")
    g.add_argument("--trim-ratio", type=float, default=0.25,
                   help="trimmed-mean trim ratio in [0, 0.5)")
    g.add_argument("--plan-json", default="",
                   help="inline ServerPlan JSON or a path to one; "
                        "overrides the individual plan flags")
    return g


def add_fault_args(ap):
    """Register the fault-injection flag: ``--fault-json`` names a
    ``repro_torch.serve.faults.FaultPlan`` document (inline or a path),
    the replayable-chaos analogue of ``--plan-json``."""
    g = ap.add_argument_group(
        "fault injection",
        "deterministic chaos: a seeded, replayable "
        "repro_torch.serve.faults.FaultPlan wraps the server "
        "(dropout/delay/duplicates/malformed rows/clock skew/executor "
        "crashes)")
    g.add_argument("--fault-json", default="",
                   help="inline FaultPlan JSON or a path to one; empty "
                        "disables fault injection")
    return g


def fault_plan_from_args(args):
    """The FaultPlan an ``add_fault_args`` parser describes (None when
    fault injection is disabled)."""
    from ..serve.faults import load_fault_plan

    return load_fault_plan(getattr(args, "fault_json", ""))


def add_attack_args(ap, *, attack: str = "none"):
    """Register the adversarial-scenario flags: the attack the byzantine
    rows run and its tunables (repro_torch.api.ScenarioSpec)."""
    g = ap.add_argument_group(
        "adversarial scenario",
        "the byzantine payload (repro_torch.core.attacks registry, plus the "
        "adaptive gradient-ascent adversary) and its tunables")
    g.add_argument("--attack", default=attack,
                   help="registry attack (none, bf, sf, lf, ipm, alie, shb, "
                        "gauss) or an adaptive kind (adaptive, autogm)")
    g.add_argument("--byz-frac", type=float, default=None, dest="byz_frac",
                   help="byzantine fraction in [0, 1]; overrides "
                        "launcher-specific --n-byz when set")
    g.add_argument("--z-max", type=float, default=1.5, dest="z_max",
                   help="ALIE deviation multiple (mu - z_max * sigma)")
    g.add_argument("--budget", type=int, default=8,
                   help="adaptive: ascent steps per round")
    g.add_argument("--lr", type=float, default=0.5,
                   help="adaptive: ascent step relative to ||mu_good||")
    g.add_argument("--objective", default="deviation",
                   choices=["deviation", "descent"],
                   help="adaptive: damage objective (autogm forces "
                        "descent)")
    return g


def scenario_from_args(args) -> ScenarioSpec:
    """The ScenarioSpec an ``add_attack_args`` parser describes."""
    return ScenarioSpec(attack=args.attack, byz_frac=args.byz_frac,
                        z_max=args.z_max, budget=args.budget, lr=args.lr,
                        objective=args.objective)


def plan_from_args(args, *, byz_bound: Optional[int] = None,
                   clip_alpha: Optional[float] = None,
                   clip_radius: Optional[float] = None,
                   compress_frac: float = 0.0,
                   cohort: Optional[int] = None) -> ServerPlan:
    """The ServerPlan an ``add_plan_args`` parser describes; the clip,
    compress and cohort stages come from the launcher."""
    if args.plan_json:
        doc = args.plan_json
        if os.path.exists(doc):
            with open(doc) as f:
                doc = f.read()
        return ServerPlan.from_json(doc)
    clip = None
    if clip_alpha is not None or clip_radius is not None:
        clip = ClipSpec(alpha=clip_alpha, radius=clip_radius)
    compress = None
    if compress_frac and compress_frac > 0.0:
        compress = CompressSpec(kind="rand_fraction", frac=float(compress_frac))
    return ServerPlan(
        aggregate=AggregatorSpec(rule=args.aggregator,
                                 trim_ratio=args.trim_ratio,
                                 byz_bound=byz_bound),
        clip=clip,
        compress=compress,
        bucket=BucketSpec(s=args.bucket_s) if args.bucket_s >= 2 else None,
        schedule=ScheduleSpec(placement=args.agg_schedule,
                              blocks=args.schedule,
                              superleaf_elems=args.superleaf_elems,
                              backend=args.backend),
        cohort=cohort)
