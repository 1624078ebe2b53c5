#!/usr/bin/env python3
"""Time the port's four Krum kernels (``csrc/krum.cu``) and
``clipped_diff_scale`` (``csrc/clipped_diff.cu``) on one CUDA card.

    python3 tools/krum_wrappers.py [--src DIR] [--tag NAME]

At the wide server-step shape (n = 20 rows, d = 2^24+37 coordinates) it
prints one JSON line for the ``repro_torch`` package under ``--src``
(default: this checkout's ``src``), after checking that the Gram is
symmetric and equal to ``cross_gram(x, x)`` bit for bit.  Every time is
``chip_smoke.py``'s, taken by its own functions: the device time of
``gram_matrix``, ``cross_gram`` and ``weighted_row_sum`` (every weight
non-zero) in f32 (``_device_ms``: back-to-back calls between one event
pair); ``select_row`` at winners 8 (aligned) and 10 (misaligned) and
``clipped_diff_scale`` on 2^24+37 values (an aligned d, and in f32 also
one 8 bytes past a 16-byte boundary), in f32 and bf16, with their
library calls, host enqueue us and bounds (``time_select_row``,
``time_scale``, which hold each kernel bit for bit equal to its library
call first).  Run it on two trees in one call (parent, change, change,
parent) to compare them on the same card; each process builds only its
tree's two sources.

Needs a card and nvcc; exits non-zero without them.
"""
import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, D = 20, 2 ** 24 + 37


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("krum_wrappers: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import _device_ms, time_scale, time_select_row
    from repro_torch.kernels import _build

    kr = importlib.import_module("repro_torch.kernels.krum")
    # time_scale finds the module in sys.modules
    importlib.import_module("repro_torch.kernels.clipped_diff")
    build_s = _build.build_all(("krum", "clipped_diff"))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, D, device="cuda", generator=g)
    y = torch.randn(N, D, device="cuda", generator=g)
    w = torch.rand(N, device="cuda", generator=g) + 0.5
    factor = torch.tensor(0.6180339887, device="cuda")
    gram = kr.gram_matrix(x)
    torch.cuda.synchronize()
    if not (torch.equal(gram, gram.T) and torch.equal(kr.cross_gram(x, x),
                                                      gram)):
        sys.exit(f"krum_wrappers: {args.tag}: the Gram is not symmetric or "
                 "differs from cross_gram(x, x)")
    out = {
        "tag": args.tag, "src": args.src, "build_s": round(build_s, 1),
        "gram_matrix": _device_ms(lambda: kr.gram_matrix(x)),
        "cross_gram": _device_ms(lambda: kr.cross_gram(x, y)),
        "weighted_row_sum": _device_ms(lambda: kr.weighted_row_sum(x, w)),
        "select_row": time_select_row(x)["variants"],
        # on an aligned copy of row 10, as the entry point's d lies, and
        # (f32 only) on row 10 itself, 8 bytes past a 16-byte boundary
        "clipped_diff_scale": time_scale(x[N // 2].clone(), factor)["variants"],
        "clipped_diff_scale f32 off 8 bytes": time_scale(
            x[N // 2], factor)["variants"]["f32"],
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
