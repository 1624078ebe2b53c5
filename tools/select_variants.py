#!/usr/bin/env python3
"""Time the port's selection kernels (``csrc/select.cuh``) on one CUDA card.

    python3 tools/select_variants.py [--src DIR] [--tag NAME]
    python3 tools/select_variants.py --parts [VERSION ...]

At n = 20 rows, d = 2^24+37 coordinates, f32, on the data of
``chip_smoke.py``'s wide shape (its seed 3: the rows, the random mask, the
Bucketing order), every time a device time by ``chip_smoke.py``'s
``_device_ms``.

Without ``--parts`` it prints one JSON line for the ``repro_torch``
package under ``--src`` (default: this checkout's ``src``):

- ``ms``: the three selection sites through their wrappers:
  ``coordinate_median`` under each mask of ``chip_smoke.select_masks``
  (every row kept, the random mask, 4 of 20 kept), ``clip_bucket_select``
  at s = 2 (random mask, given factors and order: Fig. 1's pass 2) and at
  s = 1 (random mask and 4 of 20), and ``bucketed_coordinate_median`` at
  s = 2 (a random permutation);
- ``ptxas``: registers and stack, spill-store and spill-load bytes of each
  selection kernel the tree built, by ``dtype NB/S/KIND`` (its template
  arguments: width, compile-time bucket size, 0 generic / 1 median / 2
  trimmed mean; the parent design has no KIND).

Run it on two trees in one call (parent, change, change, parent) to compare
them on one card; unpack the other tree with ``git archive`` under
``build/``.

With ``--parts`` it splits this tree's time: it builds versions of
``csrc/select.cuh`` (``CUTS``), each in its own copy of the package under
``build/select_parts/`` (all builds started together), and prints one such
line for each: ``kernel``, the source as it is; ``loads``, without the
medians' networks (the per-count network at s = 1, the exact-width one at
s = 2; the keys are xor-folded into the wires the median reads, so that
every load stays live: slot staging, loads, keys and the read-out);
``network``, without the row loads (keys made from the column in
registers, then the network); ``prefix``, the first design of the
median at s = 1, kept for comparison: every coordinate through the
exact-width network of all W slots sorted up to wire W/2, without the
per-count networks; ``tiles1``, ``tiles2``, ``tiles8``: the kernel with 1,
2 or 8 column tiles a block in place of 4; ``bounds4``, ``bounds5``,
``bounds6``: the kernel with ``__launch_bounds__`` asking for 4, 5 or 6
blocks a SM (at most 64, 48 or 40 registers a thread).  ``loads`` and
``network`` compute wrong values and are only timed.  ``--parts V ...``
builds only the versions named.

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
    # the keys xor-folded into a wire the median reads, so that no load is
    # dead (C or NB xors where the network ran its min/max), and no
    # coordinate sent to the all-slots path by the folded key
    "loads": [("        MedianNetwork<C>::apply(v);\n",
               "        { int f = 0; for (int k = 0; k < C; ++k) f ^= v[k]; "
               "v[C / 2] = f; }\n"),
              ("        r = v[hi] <= big ?", "        r = true ?"),
              ("    Network<NB, true>::apply(v);\n",
               "    { int f = 0; for (int k = 0; k < NB; ++k) f ^= v[k]; "
               "v[NB / 2] = f; }\n")],
    "network": [
        ("        if (col < d) xv[g][k] = to_f32(x[s_slot[k].off + col]);",
         "        if (col < d) xv[g][k] = __int_as_float(0x3f800000 ^ "
         "static_cast<int>(col * (k + 1)));"),
        ("          if (off >= 0) p[b * S + t] = to_f32(x[off + col]);",
         "          if (off >= 0) p[b * S + t] = __int_as_float(0x3f800000 ^ "
         "static_cast<int>((off + col) * 3));"),
    ],
    "prefix": [("  if constexpr (S == 1 && KIND == kMedian) {",
                "  if constexpr (S == 1 && KIND == kMedian && false) {")],
    "tiles1": [("constexpr int kSelectTiles = 4;",
                "constexpr int kSelectTiles = 1;")],
    "tiles2": [("constexpr int kSelectTiles = 4;",
                "constexpr int kSelectTiles = 2;")],
    "tiles8": [("constexpr int kSelectTiles = 4;",
                "constexpr int kSelectTiles = 8;")],
    "bounds4": [("__global__ void __launch_bounds__(kSelectThreads)",
                 "__global__ void __launch_bounds__(kSelectThreads, 4)")],
    "bounds5": [("__global__ void __launch_bounds__(kSelectThreads)",
                 "__global__ void __launch_bounds__(kSelectThreads, 5)")],
    "bounds6": [("__global__ void __launch_bounds__(kSelectThreads)",
                 "__global__ void __launch_bounds__(kSelectThreads, 6)")],
}
_KERNEL = re.compile(
    r"Compiling entry function '(_ZN5repro25clip_bucket_select_kernel\w+)'"
    r".*?(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
    r"spill loads.*?Used (\d+) registers", re.S)


def _kernel_tag(mangled: str) -> str:
    """``f32 20/1/1``: the input type and the integer template arguments."""
    args = mangled.split("clip_bucket_select_kernelI", 1)[1]
    dtype = "bf16" if args.startswith("13__nv_bfloat16") else "f32"
    nums = re.findall(r"Li(-?\d+)E", args.split("EEv", 1)[0] + "E")
    return f"{dtype} {'/'.join(nums)}"


def _ptxas(log: str) -> dict:
    return {_kernel_tag(m.group(1)): {
        "registers": int(m.group(5)), "stack": int(m.group(2)),
        "spill_stores": int(m.group(3)), "spill_loads": int(m.group(4))}
        for m in _KERNEL.finditer(log)}


def _time(src: str, tag: str) -> dict:
    """Build the tree under ``src`` and time its wrappers (run in a process
    of its own: each tree has its own ``repro_torch``)."""
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    from chip_smoke import _device_ms, select_masks
    from repro_torch.kernels import _build, ops

    ca = importlib.import_module("repro_torch.kernels.clip_aggregate")
    secs = _build.build_all(("clip_aggregate",))
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(N, D, device="cuda", generator=g)
    mask = torch.rand(N, device="cuda", generator=g) > 0.3
    mask[0] = True
    idx = torch.randperm(N, device="cuda", generator=g).to(torch.int32)
    factors = torch.rand(N, device="cuda", generator=g) * 0.5 + 0.5
    perm = torch.randperm(N, device="cuda", generator=g).to(torch.int32)
    masks = select_masks(mask)
    four = f"4-of-{N}"
    ms = {f"coordinate_median {k}": _device_ms(
        lambda m=m: ops.coordinate_median(x, m)) for k, m in masks.items()}
    for k in ("random", four):
        m = masks[k].float()
        ms[f"pass2 s=1 {k}"] = _device_ms(
            lambda: ca.clip_bucket_select(x, factors, m, None, 1, -1.0))
    maskf = mask.float()
    ms["pass2 s=2 random"] = _device_ms(
        lambda: ca.clip_bucket_select(x, factors, maskf, idx, 2, -1.0))
    ms["bucketed_cm s=2 random"] = _device_ms(
        lambda: ops.bucketed_coordinate_median(x, perm, maskf))
    return {"tag": tag, "src": src, "device": torch.cuda.get_device_name(0),
            "shape": [N, D], "kept_rows": {k: int(m.sum())
                                           for k, m in masks.items()},
            "ms": ms, "build_s": secs,
            "ptxas": _ptxas(_build.build_log("clip_aggregate"))}


def _prepare(version: str) -> Path:
    """A copy of this tree's package under build/select_parts/<version>/src
    with the version's cuts applied to csrc/select.cuh."""
    dest = ROOT / "build" / "select_parts" / version / "src"
    shutil.rmtree(dest.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cuh = dest / "repro_torch" / "kernels" / "csrc" / "select.cuh"
    text = cuh.read_text()
    for old, new in CUTS[version]:
        if text.count(old) != 1:
            sys.exit(f"select_variants: {version}: the cut {old!r} does not "
                     "match csrc/select.cuh once")
        text = text.replace(old, new)
    cuh.write_text(text)
    return dest


def _run(args) -> str:
    out = subprocess.run([sys.executable, __file__, *args],
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"select_variants: {' '.join(args)} failed:\n{out.stderr}")
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--parts", nargs="*", metavar="VERSION",
                    help="split the time (all of CUTS, or these versions)")
    ap.add_argument("--build", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("select_variants: needs a CUDA card")
    if args.build:  # a child process: build one prepared copy
        sys.path.insert(0, args.build)
        from repro_torch.kernels import _build
        _build.build_all(("clip_aggregate",))
        return
    if args.parts is None:
        print(json.dumps(_time(str(Path(args.src).resolve()), args.tag)))
        return
    unknown = set(args.parts) - set(CUTS)
    if unknown:
        sys.exit(f"select_variants: no version {sorted(unknown)}; "
                 f"the versions are {list(CUTS)}")
    dests = {v: _prepare(v) for v in (args.parts or CUTS)}
    builds = [subprocess.Popen([sys.executable, __file__, "--build", str(p)],
                               stderr=subprocess.PIPE, text=True)
              for p in dests.values()]
    for version, proc in zip(dests, builds):
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"select_variants: {version} did not build:\n{err}")
    for version, dest in dests.items():
        print(_run(["--src", str(dest), "--tag", version]))


if __name__ == "__main__":
    main()
