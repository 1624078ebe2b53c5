#!/usr/bin/env python3
"""Time the port's selection kernel (``csrc/select.cuh``) on one CUDA card.

    python3 tools/select_variants.py [--src DIR] [--tag NAME] [--reps N]

At the wide server-step shape (n = 20 rows, d = 2^24+37 coordinates, f32,
random masks) it prints, as one JSON line:

- ``wrappers``: the median times (CUDA events) of pass 2 through
  ``clip_bucket_select`` with s = 2 and s = 1 and of the standalone
  ``coordinate_median``, for the ``repro_torch`` package under ``--src``
  (default: this checkout's ``src``).  Run it on two trees in one call
  (parent, change, change, parent) to compare them on the same card.
- ``variants``: the selection template built for the bucket size as a
  compile-time argument (S = 2 for s = 2, S = 1 for s = 1) against the
  same template with s read at run time (S = 0), one small library built
  with the package's nvcc flags from that tree's ``select.cuh``.  Each
  pair must give the same output bit for bit.

Needs a card and nvcc; exits non-zero without them.
"""
import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

N, D = 20, 2 ** 24 + 37
# (name, S, NB, s): the compile-time bucket size S against S = 0
VARIANTS = (("s2_static", 2, 16, 2), ("s2_runtime", 0, 16, 2),
            ("s1_static", 1, 32, 1), ("s1_runtime", 0, 32, 1))

_SOURCE = """#include "{header}"
extern "C" int select_variant(int which, const void* x, const void* f,
                              const void* m, const void* idx, void* out,
                              int n, int n_p, long long d, int s, int nb,
                              float trim, void* stream) {{
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {{
{cases}
    default: return static_cast<int>(cudaErrorInvalidValue);
  }}
}}
"""


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


def _build_variants(build, csrc: Path, out_dir: Path) -> ctypes.CDLL:
    # a template with idx_slots takes pass 2's (n of the row order slots)
    slots = "n, " if "idx_slots" in (csrc / "select.cuh").read_text() else ""
    cases = "\n".join(
        f"    case {i}: return static_cast<int>(repro::launch_select_s<float, "
        f"{nb}, {S}>(x, f, m, idx, out, n, n_p, {slots}d, s, nb, trim, st));"
        for i, (_, S, nb, _) in enumerate(VARIANTS))
    src = _SOURCE.format(header=csrc / "select.cuh", cases=cases)
    h = hashlib.sha256(src.encode())
    for path in sorted(csrc.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    lib_path = out_dir / f"select_variants-{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cu = lib_path.with_suffix(".cu")
        cu.write_text(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                        str(cu)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.select_variant.restype = i
    lib.select_variant.argtypes = [i, vp, vp, vp, vp, vp, i, i,
                                   ctypes.c_longlong, i, i, ctypes.c_float, vp]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("select_variants: needs a CUDA card")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import clip_aggregate as ca

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(N, D, device="cuda", generator=g)
    mask = torch.rand(N, device="cuda", generator=g) > 0.3
    mask[0] = True
    maskf = mask.float()
    idx = torch.randperm(N, device="cuda", generator=g).to(torch.int32)
    factors = torch.rand(N, device="cuda", generator=g) * 0.5 + 0.5

    wrappers = {}
    for _ in range(2):  # two rounds; the median of each call's medians
        for name, fn in (
            ("pass2_s2_cm", lambda: ca.clip_bucket_select(
                x, factors, maskf, idx, 2, -1.0)),
            ("pass2_s1_cm", lambda: ca.clip_bucket_select(
                x, factors, maskf, None, 1, -1.0)),
            ("coordinate_median", lambda: ops.coordinate_median(x, mask)),
        ):
            wrappers.setdefault(name, []).append(_time_ms(torch, fn, args.reps))

    lib = _build_variants(_build, src / "repro_torch" / "kernels" / "csrc",
                          src.parent / "build" / "select_variants")
    outs, times = {}, {}

    def launch(i, s, nb, out):
        n_p = nb * s
        rc = lib.select_variant(
            i, x.data_ptr(), factors.data_ptr(), maskf.data_ptr(),
            idx.data_ptr() if s > 1 else None, out.data_ptr(), N, n_p, D, s,
            nb, -1.0, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant {VARIANTS[i][0]}: CUDA error {rc}")

    order = list(range(len(VARIANTS)))
    for rnd in range(2):  # A B B A within each pair
        for i in (order if rnd == 0 else order[::-1]):
            name, _, _, s = VARIANTS[i]
            nb = (N + s - 1) // s
            out = torch.empty(D, device="cuda")
            times.setdefault(name, []).append(_time_ms(
                torch, lambda: launch(i, s, nb, out), args.reps))
            outs[name] = out
    torch.cuda.synchronize()
    for a, b in (("s2_static", "s2_runtime"), ("s1_static", "s1_runtime")):
        if not torch.equal(outs[a], outs[b]):
            raise AssertionError(f"{a} and {b} disagree")
    result = {
        "tag": args.tag, "card": card, "shape": [N, D],
        "wrappers_ms": wrappers, "variants_ms": times,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
