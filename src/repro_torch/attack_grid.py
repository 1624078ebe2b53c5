"""Attack x aggregator grid: a thin shim over the resilience matrix
(``repro_torch.scenarios.matrix``), the counterpart of
``examples/attack_grid.py``.

    PYTHONPATH=src python -m repro_torch.attack_grid --steps 150
    PYTHONPATH=src python -m repro_torch.attack_grid --device cpu

It keeps the original Fig.-2 flavour (robust rules against omniscient
attacks, clip and no clip) on a small grid and runs on the card unless
``--device cpu`` is given.  For the smoke sweep run ``python -m
repro_torch.scenarios.matrix --smoke``.
"""
import argparse

from .scenarios.matrix import MatrixGrid, collect_resilience, print_cell


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--rules", default="cm,rfa")
    ap.add_argument("--attacks", default="bf,alie,shb")
    ap.add_argument("--byz-fracs", default="0.25")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain rules)")
    args = ap.parse_args(argv)

    grid = MatrixGrid(
        rules=tuple(args.rules.split(",")),
        attacks=tuple(args.attacks.split(",")),
        byz_fracs=tuple(float(f) for f in args.byz_fracs.split(",")),
        steps=args.steps,
    )
    print(f"{'cell':30s} {'byz':>5s} {'gap':>12s}  verdict")
    res = collect_resilience(grid, progress=print_cell, device=args.device)
    print("\nbreakdown points:")
    for k, v in sorted(res["breakdown"].items()):
        print(f"  {k:30s} {v:.2f}")
    return res


if __name__ == "__main__":
    main()
