#!/usr/bin/env python3
"""Time the port's four Krum kernels (``csrc/krum.cu``) on one CUDA card.

    python3 tools/krum_wrappers.py [--src DIR] [--tag NAME] [--reps N]

At the wide server-step shape (n = 20 rows, d = 2^24+37 coordinates, f32)
it prints one JSON line with the median times (CUDA events) of
``gram_matrix``, ``cross_gram``, ``weighted_row_sum`` (every weight
non-zero) and ``select_row`` of the ``repro_torch`` package under
``--src`` (default: this checkout's ``src``), after checking that the Gram
is symmetric and equal to ``cross_gram(x, x)`` bit for bit.  Run it on two
trees in one call (parent, change, change, parent) to compare them on the
same card; each process builds only its tree's ``krum.cu``.

Needs a card and nvcc; exits non-zero without them.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

N, D = 20, 2 ** 24 + 37


def _time_ms(torch, fn, reps):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("krum_wrappers: needs a CUDA card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build

    kr = sys.modules.get("repro_torch.kernels.krum") or __import__(
        "repro_torch.kernels.krum", fromlist=["krum"])
    build_s = _build.build_all(("krum",))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, D, device="cuda", generator=g)
    y = torch.randn(N, D, device="cuda", generator=g)
    w = torch.rand(N, device="cuda", generator=g) + 0.5
    win = torch.tensor(N // 2, device="cuda")
    sc = torch.tensor(0.5, device="cuda")
    gram = kr.gram_matrix(x)
    torch.cuda.synchronize()
    if not (torch.equal(gram, gram.T) and torch.equal(kr.cross_gram(x, x),
                                                      gram)):
        sys.exit(f"krum_wrappers: {args.tag}: the Gram is not symmetric or "
                 "differs from cross_gram(x, x)")
    out = {
        "tag": args.tag, "src": args.src, "build_s": round(build_s, 1),
        "gram_matrix": _time_ms(torch, lambda: kr.gram_matrix(x), args.reps),
        "cross_gram": _time_ms(torch, lambda: kr.cross_gram(x, y), args.reps),
        "weighted_row_sum": _time_ms(
            torch, lambda: kr.weighted_row_sum(x, w), args.reps),
        "select_row": _time_ms(torch, lambda: kr.select_row(x, win, sc),
                               args.reps),
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
