#!/usr/bin/env python3
"""Split the Gram kernels' time on one CUDA card into their copies and
their multiply-adds.

    python3 tools/gram_parts.py [--src DIR]

Builds four versions of ``csrc/krum.cu`` of the tree under ``--src``
(default: this checkout's ``src``), each in its own copy of the package
under ``build/gram_parts/``: ``kernel``, the source as it is; ``copies``,
the kernel with its multiply-adds taken out (the steps' copies, waits and
barriers only); ``sums``, the kernel with its copies taken out (the
multiply-adds over whatever shared memory holds); ``copy_warps``, the
kernel with two more warps that issue every copy while the 8 others only
multiply (a design that was tried and dropped).  For each it prints one
JSON line with the device time of ``gram_matrix`` and ``cross_gram`` at
n = 20, d = 2^24+37, f32 (``chip_smoke.py``'s ``_device_ms``) and the
registers ptxas gave each Gram kernel.  ``copies`` and ``sums`` compute
wrong values and are only timed.

Needs a card and nvcc; exits non-zero without them.
"""
import argparse
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, D = 20, 2 ** 24 + 37
# (version, [(source text, its replacement)]): each text must occur once
CUTS = {
    "kernel": [],
    "copies": [("    if (!active) continue;\n    const unsigned char* stage",
                "    continue;\n    const unsigned char* stage")],
    "sums": [("    if (t < steps) issue(t);\n", ""),
             ("    if (t + kStages - 1 < steps) issue(t + kStages - 1);\n",
              "")],
    # a design that was tried and dropped: two warps beside the 8 that
    # multiply issue every copy, and the 8 only multiply
    "copy_warps": [
        ("constexpr int kGramThreads = 256;\n",
         "constexpr int kGramThreads = 256;\n"
         "constexpr int kCopyWarps = 2;\n"
         "constexpr int kGramBlock = kGramThreads + 32 * kCopyWarps;\n"),
        ("__launch_bounds__(kGramThreads, TPT",
         "__launch_bounds__(kGramBlock, TPT"),
        ("pad * words; e += kGramThreads)", "pad * words; e += kGramBlock)"),
        ("  const int warp = tid >> 5, lane = tid & 31;",
         "  const bool copier = tid >= kGramThreads;\n"
         "  const int warp = (tid - kGramThreads) >> 5, lane = tid & 31;"),
        ("q < ops * n; q += kGramThreads / 32)",
         "q < ops * n; q += kCopyWarps)"),
        ("  const bool active = p < group",
         "  const bool active = !copier && p < group"),
        ("    if (t < steps) issue(t);\n    cp_async_commit();",
         "    if (copier && t < steps) issue(t);\n"
         "    if (copier) cp_async_commit();"),
        ("    cp_async_wait<kStages - 2>();",
         "    if (copier) cp_async_wait<kStages - 2>();"),
        ("    if (t + kStages - 1 < steps) issue(t + kStages - 1);\n"
         "    cp_async_commit();",
         "    if (copier && t + kStages - 1 < steps) "
         "issue(t + kStages - 1);\n    if (copier) cp_async_commit();"),
        ("kernel<<<blocks, kGramThreads,", "kernel<<<blocks, kGramBlock,"),
    ],
}


def _prepare(src: Path, version: str) -> Path:
    """A copy of the package under build/gram_parts/<version>/src with the
    version's cuts applied to csrc/krum.cu."""
    dest = ROOT / "build" / "gram_parts" / version / "src"
    shutil.rmtree(dest.parent, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dest / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dest / "repro_torch" / "kernels" / "csrc" / "krum.cu"
    text = cu.read_text()
    for old, new in CUTS[version]:
        if text.count(old) != 1:
            sys.exit(f"gram_parts: {version}: the cut {old!r} does not match "
                     "csrc/krum.cu once")
        text = text.replace(old, new)
    cu.write_text(text)
    return dest


def _time(src: str, version: str) -> dict:
    """Time one prepared version (run in a process of its own)."""
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    from chip_smoke import _device_ms
    from repro_torch.kernels import _build

    kr = importlib.import_module("repro_torch.kernels.krum")
    _build.build_all(("krum",))
    log = _build.build_log("krum")
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"'(_ZN5repro18gram_slices_kernel\w+)'.*?Used (\d+) registers", log,
        re.S)}
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, D, device="cuda", generator=g)
    y = torch.randn(N, D, device="cuda", generator=g)
    return {"version": version, "src": src,
            "gram_matrix": _device_ms(lambda: kr.gram_matrix(x)),
            "cross_gram": _device_ms(lambda: kr.cross_gram(x, y)),
            "registers": regs, "device": torch.cuda.get_device_name(0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--time", nargs=2, metavar=("SRC", "VERSION"),
                    help=argparse.SUPPRESS)  # the child process's work
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("gram_parts: needs a CUDA card")
    if args.time:
        print(json.dumps(_time(*args.time)))
        return
    for version in CUTS:
        dest = _prepare(Path(args.src).resolve(), version)
        out = subprocess.run([sys.executable, __file__, "--time", str(dest),
                              version], capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"gram_parts: {version} failed:\n{out.stderr}")
        print(out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    main()
