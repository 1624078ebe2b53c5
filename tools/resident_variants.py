#!/usr/bin/env python3
"""Time the port's one-block resident kernels (``gm_resident``,
``cclip_resident``; ``csrc/resident.cuh``) on one CUDA card.

    python3 tools/resident_variants.py [--src DIR] [--tag NAME]
    python3 tools/resident_variants.py --parts [VERSION ...]

For the ``repro_torch`` package under ``--src`` (default: this checkout's
``src``) it builds ``geometric_median`` and ``centered_clip`` and prints one
JSON line a shape, every time a device time by ``chip_smoke.py``'s
``_device_ms``, through the kernels' wrappers:

- the Fig. 2 shape: ``gm_resident`` at n = 20, d = 698, Bucketing(2),
  8 Weiszfeld steps, on the data ``chip_smoke.py`` times it on (seed 5);
- the Fig. 1 shape: ``cclip_resident`` at n = 20, d = 40, Bucketing(2),
  5 steps, tau 1.0, as phase 2 times it (seed 40);
- ``gm_resident`` at n = 10, d = 698, s = 1, 8 steps: Fig. 2's RFA
  without Bucketing (``chip_smoke.py``'s fig2-rfa-unbucketed runs);
- each rule's largest shape the resident rule admits at n = 20, s = 1
  (d = 2,750) and s = 2 (d = 5,266), with the rule's steps.

Each line holds ``ms`` (the path's steps), ``iters0_ms`` (no step: the
launch, the staging, z0 and the write-out), ``step_ms`` ((ms -
iters0_ms) / steps), ``floor_ms`` (back-to-back ``torch.cuda._sleep(1)``
spin kernels under the same yardstick: what a launch costs on this card),
and ``ptxas``: registers, stack, spill-store and spill-load bytes of every
resident kernel the tree built, by ``dtype rule path``.

Run it on two trees in one call (parent, change, change, parent) to compare
them on one card; unpack the other tree with ``git archive`` under
``build/``.

With ``--parts`` it times versions of this tree's ``csrc/resident.cuh``
(``CUTS``), each built in its own copy of the package under
``build/resident_parts/`` (all builds started together), one such line a
shape and version: ``kernel``, the source as it is; ``coords2``: the
block sized for 2 coordinates a thread in place of 3; ``stage16``,
``stagerows8``: staging tiles of the shared-memory path 16 coordinates or
8 rows in place of 8 and 4; ``noload``: the staging without its loads
(each loaded value a constant, so the results are wrong and only timed).
``--parts V ...`` builds only the versions named.

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
# (rule, n, d, s, seed): Fig. 2, Fig. 1, Fig. 2 without Bucketing, then
# the largest admitted shapes
SHAPES = [("gm", 20, 698, 2, 5), ("cclip", 20, 40, 2, 40),
          ("gm", 10, 698, 1, 698),
          ("gm", 20, 2750, 1, 2750), ("gm", 20, 5266, 2, 5266),
          ("cclip", 20, 2750, 1, 2750), ("cclip", 20, 5266, 2, 5266)]
STEPS = {"gm": 8, "cclip": 5}
CCLIP_TAU = 1.0
# (version, [(source text, its replacement)]): each text must occur once
CUTS = {
    "kernel": [],
    "coords2": [("constexpr int kResCoords = 3;", "constexpr int kResCoords = 2;")],
    "stage16": [("constexpr int kResStageK = 8;", "constexpr int kResStageK = 16;")],
    "stagerows8": [("constexpr int kResStageRows = 4;",
                    "constexpr int kResStageRows = 8;")],
    # staging without its loads (every loaded value a constant): what the
    # loads cost
    "noload": [('asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));',
                "v = 0;"),
               ('asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));',
                "v = 1.f;"),
               ('asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));',
                "v = 0x3f80;")],
}
_KERNEL = re.compile(
    r"Compiling entry function '(\w*resident\w*)'"
    r".*?(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
    r"spill loads.*?Used (\d+) registers", re.S)


def _kernel_tag(mangled: str) -> str:
    """``f32 gm regs/3``: the input type, the rule and the code path
    (registers with K coordinates a thread, shared memory, or the parent
    tree's single kernel a rule, ``one-block``)."""
    dtype = "bf16" if "__nv_bfloat16" in mangled else "f32"
    rule = "gm" if ("GmStep" in mangled or "gm_resident" in mangled) \
        else "cclip"
    if "resident_regs_kernel" in mangled:
        path = "regs/" + "/".join(re.findall(r"Li(\d+)E", mangled))
    elif "resident_smem_kernel" in mangled:
        path = "smem"
    else:
        path = "one-block"
    return f"{dtype} {rule} {path}"


def _ptxas(log: str) -> dict:
    return {_kernel_tag(m.group(1)): {
        "registers": int(m.group(5)), "stack": int(m.group(2)),
        "spill_stores": int(m.group(3)), "spill_loads": int(m.group(4))}
        for m in _KERNEL.finditer(log)}


def _time(src: str, tag: str):
    """Build the tree under ``src`` and time its wrappers (run in a process
    of its own: each tree has its own ``repro_torch``)."""
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    from chip_smoke import _device_ms
    from repro_torch.kernels import _build

    cc = importlib.import_module("repro_torch.kernels.centered_clip")
    gmk = importlib.import_module("repro_torch.kernels.geometric_median")
    secs = _build.build_all(("geometric_median", "centered_clip"))
    ptxas = {**_ptxas(_build.build_log("geometric_median")),
             **_ptxas(_build.build_log("centered_clip"))}
    floor = _device_ms(lambda: torch.cuda._sleep(1))
    for rule, n, d, s, seed in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, d, device="cuda", generator=g)
        m = (torch.rand(n, device="cuda", generator=g) > 0.3).float()
        f = torch.rand(n, device="cuda", generator=g)
        i = torch.randperm(n, device="cuda", generator=g).int()
        if rule == "gm":
            def run(iters):
                return gmk.gm_resident(x, m, f, i, s, iters=iters)
        else:
            def run(iters):
                return cc.cclip_resident(x, m, f, i, s, iters=iters,
                                         tau=CCLIP_TAU)
        steps = STEPS[rule]
        ms = _device_ms(lambda: run(steps))
        ms0 = _device_ms(lambda: run(0))
        print(json.dumps({
            "tag": tag, "src": src, "device": torch.cuda.get_device_name(0),
            "kernel": f"{rule}_resident", "shape": [n, d, s], "steps": steps,
            "ms": ms, "iters0_ms": ms0, "step_ms": (ms - ms0) / steps,
            "floor_ms": floor, "build_s": secs, "ptxas": ptxas}), flush=True)


def _prepare(version: str) -> Path:
    """A copy of this tree's package under build/resident_parts/<version>/src
    with the version's cuts applied to csrc/resident.cuh."""
    dest = ROOT / "build" / "resident_parts" / version / "src"
    shutil.rmtree(dest.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cuh = dest / "repro_torch" / "kernels" / "csrc" / "resident.cuh"
    text = cuh.read_text()
    for old, new in CUTS[version]:
        if text.count(old) != 1:
            sys.exit(f"resident_variants: {version}: the cut {old!r} does not "
                     "match csrc/resident.cuh once")
        text = text.replace(old, new)
    cuh.write_text(text)
    return dest


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--parts", nargs="*", metavar="VERSION",
                    help="time versions of resident.cuh (all of CUTS, or these)")
    ap.add_argument("--build", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("resident_variants: needs a CUDA card")
    if args.build:  # a child process: build one prepared copy
        sys.path.insert(0, args.build)
        from repro_torch.kernels import _build
        _build.build_all(("geometric_median", "centered_clip"))
        return
    if args.parts is None:
        _time(str(Path(args.src).resolve()), args.tag)
        return
    unknown = set(args.parts) - set(CUTS)
    if unknown:
        sys.exit(f"resident_variants: no version {sorted(unknown)}; "
                 f"the versions are {list(CUTS)}")
    dests = {v: _prepare(v) for v in (args.parts or CUTS)}
    builds = [subprocess.Popen([sys.executable, __file__, "--build", str(p)],
                               stderr=subprocess.PIPE, text=True)
              for p in dests.values()]
    for version, proc in zip(dests, builds):
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"resident_variants: {version} did not build:\n{err}")
    for version, dest in dests.items():
        out = subprocess.run([sys.executable, __file__, "--src", str(dest),
                              "--tag", version], capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"resident_variants: {version} failed:\n{out.stderr}")
        print(out.stdout, end="", flush=True)


if __name__ == "__main__":
    main()
