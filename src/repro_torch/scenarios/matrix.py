"""The resilience matrix: breakdown-point curves, the counterpart of
``repro.scenarios.matrix``.

Sweep attack x rule x compressor x participation rate x byzantine
fraction over the Algorithm-1 engine (``ByzVRMarinaPP`` on a seeded
logistic problem), call each cell CONVERGED when its final optimality
gap clears a fixed tolerance, and reduce every (rule, attack, clip,
participation, compressor) curve to its **breakdown point**: the
smallest byzantine fraction that breaks convergence (1.0 = survived
every tested fraction).

The cells run on the card with backend "auto" unless ``device="cpu"``
is given; the draws come from the engine's CPU generator, so the card
and the CPU make the same draws and judge each cell alike.  The port's
draws differ from the reference's (``jax.random``), so its map is its
own; ``run_cell(..., tape=, problem=)`` replays the reference's draws
and data for the parity tests.  ``--json-out`` writes the resilience
block into a JSON file the caller names (merging into it if it exists).

  python -m repro_torch.scenarios.matrix --smoke [--device cpu]
  python -m repro_torch.scenarios.matrix \\
      --rules cm,krum --attacks alie,shb,adaptive --byz-fracs 0.1,0.3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from .._device import resolve_device

__all__ = ["MatrixGrid", "run_cell", "collect_resilience",
           "append_resilience", "breakdown_points", "SMOKE_GRID"]


@dataclasses.dataclass(frozen=True)
class MatrixGrid:
    """One resilience sweep: the axes plus the (fixed) cell economy."""
    rules: tuple = ("mean", "cm")
    attacks: tuple = ("gauss", "shb")
    clips: tuple = ("clip", "noclip")  # the paper's central ablation
    byz_fracs: tuple = (0.1, 0.25, 0.45)
    participations: tuple = (0.2,)  # sampled cohort C = round(part * n)
    compressors: tuple = ("none",)  # "none" | "randf<percent>"
    clip_alpha: float = 1.0  # alpha of the "clip" cells
    steps: int = 250
    n_clients: int = 20
    dim: int = 30
    m: int = 200
    gamma: float = 0.5
    p: float = 0.2
    batch: int = 32
    bucket_s: int = 2
    tol: float = 2e-2  # converged iff final gap < tol
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# the smoke grid, the paper's Figure-1 story end to end: at C = 4 of
# n = 20 the unclipped cells break under SHB once sampled cohorts go
# byzantine-majority often enough (0.45 on the reference's draws, 0.25
# on the port's), plain mean breaks under gauss at every fraction, and
# the clipped compositions survive SHB at every fraction
SMOKE_GRID = MatrixGrid()

_BENCH_FILE = "BENCH_kernels.json"  # the reference's payload: never written


def _compress_spec(name: str):
    from ..api import CompressSpec

    if name in ("none", ""):
        return None
    if name.startswith("randf"):
        return CompressSpec(kind="rand_fraction",
                            frac=int(name[len("randf"):]) / 100.0)
    raise ValueError(f"unknown matrix compressor {name!r}; use 'none' or "
                     "'randf<percent>' (e.g. randf50)")


def _cell_key(rule: str, attack: str, clip: str, C: int,
              compressor: str) -> str:
    return f"{rule}.{attack}.{clip}.C{C}.{compressor}"


def _fstar_cache():
    """f* of a problem: 2,000 gradient steps of 1/L from x^0, once per
    (n_clients, n_good) (the data depend on nothing else in a grid)."""
    cache = {}

    def fstar(prob):
        key = (prob.n_clients, prob.n_good)
        if key not in cache:
            lr = 1.0 / prob.smoothness()
            x = prob.x0.clone()
            for _ in range(2000):
                x = x - lr * prob.grad(x)
            cache[key] = float(prob.loss(x))
        return cache[key]

    return fstar


def run_cell(grid: MatrixGrid, *, rule: str, attack: str, byz_frac: float,
             participation: float, clip: str = "clip",
             compressor: str = "none", fstar=None, device=None,
             backend: str = "auto", tape=None, problem=None) -> dict:
    """One (rule, attack, clip, byz_frac, participation, compressor)
    cell: run the Algorithm-1 engine on ``device`` (None = "cuda") and
    report the final optimality gap (and ``final``, the mean of the last
    10 losses the gap subtracts f* from, and ``full_rounds``, the run's
    count of full-gradient rounds).  ``tape`` (a ``MarinaPPTape``) and
    ``problem`` (a ``FedProblem`` on ``device``) replace the engine's
    draws and the grid's seeded data."""
    from ..api import (AggregatorSpec, BucketSpec, ClipSpec, ScenarioSpec,
                       ScheduleSpec, ServerPlan)
    from ..core import ByzVRMarinaPP, MarinaPPConfig, logistic_problem

    if clip not in ("clip", "noclip"):
        raise ValueError(f"clip axis is 'clip' | 'noclip', got {clip!r}")
    dev = resolve_device(device)
    n = grid.n_clients
    n_byz = int(round(byz_frac * n))
    n_good = n - n_byz
    C = max(1, int(round(participation * n)))
    prob = problem if problem is not None else logistic_problem(
        grid.seed, n_clients=n, n_good=n_good, m=grid.m, dim=grid.dim,
        homogeneous=True, device=dev)
    plan = ServerPlan(
        aggregate=AggregatorSpec(rule, byz_bound=max(1, n_byz)),
        clip=ClipSpec(alpha=grid.clip_alpha) if clip == "clip" else None,
        compress=_compress_spec(compressor),
        bucket=BucketSpec(s=grid.bucket_s) if grid.bucket_s >= 2 else None,
        schedule=ScheduleSpec(backend=backend),
    )
    cfg = MarinaPPConfig(
        gamma=grid.gamma, p=grid.p, C=C, C_hat=n, batch=grid.batch,
        plan=plan, scenario=ScenarioSpec(attack=attack), seed=grid.seed + 1,
    )
    _, metrics = ByzVRMarinaPP(prob, cfg, device=dev).run(grid.steps,
                                                          tape=tape)
    tail = metrics["loss"][-10:]
    final = float(tail.mean())
    fs = fstar(prob) if fstar is not None else 0.0
    gap = final - fs
    finite = bool(torch.isfinite(tail).all())
    return {
        "key": _cell_key(rule, attack, clip, C, compressor),
        "byz_frac": byz_frac,
        "n_byz": n_byz,
        "gap": gap if finite else float("inf"),
        "converged": finite and gap < grid.tol,
        "final": final,
        "full_rounds": int(metrics["full_round"].sum()),
    }


def breakdown_points(cells: "list[dict]") -> dict:
    """Reduce cells to {curve key: smallest byz_frac that broke
    convergence} (1.0 when every tested fraction converged)."""
    out = {}
    for c in sorted(cells, key=lambda c: (c["key"], c["byz_frac"])):
        k = c["key"]
        if k not in out:
            out[k] = 1.0
        if out[k] == 1.0 and not c["converged"]:
            out[k] = c["byz_frac"]
    return out


def collect_resilience(grid: MatrixGrid = SMOKE_GRID, progress=None, *,
                       device=None, backend: str = "auto") -> dict:
    """Run the full sweep on ``device`` (None = "cuda"); returns the
    resilience block ``{"grid": ..., "breakdown": {curve: frac}, "gap":
    {cell: gap}}``."""
    fstar = _fstar_cache()
    cells = []
    for rule in grid.rules:
        for attack in grid.attacks:
            for clip in grid.clips:
                for part in grid.participations:
                    for comp in grid.compressors:
                        for frac in grid.byz_fracs:
                            c = run_cell(
                                grid, rule=rule, attack=attack,
                                byz_frac=frac, participation=part,
                                clip=clip, compressor=comp, fstar=fstar,
                                device=device, backend=backend,
                            )
                            cells.append(c)
                            if progress is not None:
                                progress(c)
    return {
        "grid": grid.to_dict(),
        "breakdown": breakdown_points(cells),
        "gap": {
            f"{c['key']}@{c['byz_frac']:.2f}": round(c["gap"], 6)
            if c["gap"] != float("inf") else "inf"
            for c in cells
        },
    }


def append_resilience(json_path: str, res: dict) -> None:
    """Write the resilience block into ``json_path`` under "resilience",
    merging into the file's object if it exists.  The reference's
    ``BENCH_kernels.json`` is refused: the port writes its own files."""
    if os.path.basename(json_path) == _BENCH_FILE:
        raise ValueError(f"{_BENCH_FILE} holds the reference's TPU payload; "
                         "name a file of the port's own")
    payload = {}
    if os.path.exists(json_path):
        with open(json_path) as f:
            payload = json.load(f)
    payload["resilience"] = res
    with open(json_path, "w") as f:
        json.dump(payload, f, indent=2)


def _parse_tuple(s: str, cast=str) -> tuple:
    return tuple(cast(x) for x in s.split(",") if x)


def print_cell(c) -> None:
    gap = "inf" if c["gap"] == float("inf") else f"{c['gap']:.4f}"
    verdict = "converged" if c["converged"] else "BROKEN"
    print(f"{c['key']:30s} {c['byz_frac']:5.2f} {gap:>12s}  {verdict}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke grid (SMOKE_GRID): fixed seeds, 24 cells")
    ap.add_argument("--rules", default="mean,cm")
    ap.add_argument("--attacks", default="gauss,shb",
                    help="registry names plus 'adaptive'/'autogm'")
    ap.add_argument("--clips", default="clip,noclip",
                    help="the clip axis (the paper's central ablation)")
    ap.add_argument("--byz-fracs", default="0.1,0.25,0.45")
    ap.add_argument("--participations", default="0.2")
    ap.add_argument("--compressors", default="none",
                    help="'none' or 'randf<percent>' (e.g. randf50)")
    ap.add_argument("--steps", type=int, default=SMOKE_GRID.steps)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain rules)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--json-out", default="",
                    help="write the resilience block into this JSON file "
                         "(merged into it if it exists)")
    args = ap.parse_args(argv)

    grid = SMOKE_GRID if args.smoke else MatrixGrid(
        rules=_parse_tuple(args.rules),
        attacks=_parse_tuple(args.attacks),
        clips=_parse_tuple(args.clips),
        byz_fracs=_parse_tuple(args.byz_fracs, float),
        participations=_parse_tuple(args.participations, float),
        compressors=_parse_tuple(args.compressors),
        steps=args.steps,
    )

    print(f"{'cell':30s} {'byz':>5s} {'gap':>12s}  verdict")
    res = collect_resilience(grid, progress=print_cell, device=args.device,
                             backend=args.backend)
    print("\nbreakdown points (smallest byz fraction that breaks "
          "convergence; 1.0 = survived all tested):")
    for k, v in sorted(res["breakdown"].items()):
        print(f"  {k:30s} {v:.2f}")
    if args.json_out:
        append_resilience(args.json_out, res)
        print(f"\n[matrix] resilience block written to {args.json_out}")
    return res


if __name__ == "__main__":
    main()
