#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises, prints no result and exits non-zero):

1. Device and build: the card's name and power limit, then every CUDA
   kernel of ``src/repro_torch/kernels/csrc`` built with nvcc (one process
   per source, started together) and the build's wall seconds.
2. Kernel vs plain version on the card: row norms (pass 1), the fused
   clip -> Bucketing -> CM/TM pass (bucketed s = 2 and unbucketed, CM and
   TM(0.1), clip on and off) and the standalone masked CM/TM, at the main
   path's shape (n=20, d=40), an odd-n bucket-padding shape (n=21) and a
   ragged wide server-step shape (n=20, d=2^24+37, 1.3 GB in f32), with
   random masks.  Tolerances: the coordinate median exactly when kernel
   and plain version get the same clip factors; sums f32 rtol 1e-5.  At
   the wide shape: each kernel's median time (CUDA events), its bound,
   the plain version's time and one library call's time.
3. Main path: the paper's Fig. 1 configuration (20 clients, 15 good,
   m=300, d=40, CM over Bucketing(2), shift-back, C=4, C_hat=20, p=0.2,
   gamma=0.5) on "cuda" with backend "auto", clipped and unclipped, 300
   steps each, plus the clipped run with CM without Bucketing (the path of
   the standalone CM kernel).  Each run's launch counts, set to 0 just
   before it and read just after it, must equal the counts that run's own
   coins predict; the clipped run must converge (final loss < 0.64, within 1e-3 of the
   optimum of the data) and the unclipped one diverge (> 5); the runs
   must agree with the plain PyTorch path on the CPU, which makes the same
   draws.
4. A ``{"kernels": [...]}`` line, then the card line, then the result.
   A kernel's ``launches`` are those of the run of the path it serves
   (``path``); ``launches_by_path`` has its counts in all three runs.
"""
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same source
WIDE_D = 2 ** 24 + 37
STEPS = 300
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def _time_ms(fn, reps):
    """Median wall time of one call on the card (CUDA events), after one
    warm-up call."""
    import torch

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


class Checks:
    """Kernel-vs-plain comparisons; keeps the worst error per kernel."""

    def __init__(self):
        self.max_abs = {}

    def compare(self, kernel, what, got, want, exact):
        import torch

        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        max_abs = float(err.max())
        rel = float((err / want.abs().clamp(min=1e-30)).max())
        if exact:
            ok = torch.equal(got, want)
            tol = "exact"
        else:
            ok = bool((err <= SUM_ATOL + SUM_RTOL * want.abs()).all())
            tol = f"rtol {SUM_RTOL:g} atol {SUM_ATOL:g}"
        print(f"  {kernel:18s} {what:44s} max_abs {max_abs:.3e} "
              f"max_rel {rel:.3e} [{tol}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {what}: kernel and plain version "
                                 f"disagree (max abs {max_abs:.3e})")
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), max_abs)


def check_shape(checks, n, d, seed):
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cmk = sys.modules["repro_torch.kernels.coordinate_median"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, device="cuda", generator=g)
    mask = torch.rand(n, device="cuda", generator=g) > 0.3
    mask[0] = True
    maskf = mask.float()
    idx = torch.randperm(n, device="cuda", generator=g).to(torch.int32)
    norms_plain = ca.row_norms_plain(x)
    radius = float(norms_plain.median())  # clips about half the rows
    factors = ca.clip_factor(norms_plain, radius)
    ones = torch.ones(n, device="cuda")
    print(f"shape n={n} d={d}")
    checks.compare("row_norms", "row norms", ops.row_norms(x), norms_plain,
                   exact=False)
    for s in (2, 1):
        bidx = idx if s == 2 else None
        for trim in (-1.0, 0.1):
            rule = "cm" if trim < 0 else "tm0.1"
            tag = f"s={s} {rule}"
            exact = trim < 0
            checks.compare(
                "clip_bucket_select", f"{tag} same factors",
                ca.clip_bucket_select(x, factors, maskf, bidx, s, trim),
                ca.clip_bucket_select_plain(x, factors, maskf, bidx, s, trim),
                exact)
            checks.compare(
                "clip_bucket_select", f"{tag} no clip",
                ops.clip_then_aggregate(x, radius, mask, bidx, trim_ratio=trim,
                                        bucket_s=s, use_clip=False)[0],
                ca.clip_bucket_select_plain(x, ones, maskf, bidx, s, trim),
                exact)
            # clip on: pass 1 then pass 2; the factors come from norms
            # summed in another order, so even the median is held to rtol
            checks.compare(
                "clip_bucket_select", f"{tag} clip (pass 1 + pass 2)",
                ops.clip_then_aggregate(x, radius, mask, bidx, trim_ratio=trim,
                                        bucket_s=s)[0],
                ca.clip_bucket_select_plain(x, factors, maskf, bidx, s, trim),
                exact=False)
    for trim in (-1.0, 0.1):
        kern = ops.coordinate_median(x, mask) if trim < 0 \
            else ops.trimmed_mean(x, mask, trim)
        checks.compare("coordinate_median", "cm" if trim < 0 else "tm0.1",
                       kern, cmk.coordinate_median_plain(x, mask, trim),
                       exact=trim < 0)
    return x, mask, idx, factors


def _bitonic_ops(nb):
    """f32 min/max operations of the kernels' bitonic network over the
    least power-of-two width (>= 16) that holds nb values."""
    width = 16
    while width < nb:
        width *= 2
    lg = int(math.log2(width))
    return 2 * (width // 4) * lg * (lg + 1)


def _bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_wide(x, mask, idx, factors):
    """Kernel, plain and library times at the wide shape."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cmk = sys.modules["repro_torch.kernels.coordinate_median"]
    n, d = x.shape
    maskf = mask.float()
    nb = (n + 1) // 2
    chunks = -(-d // 8192)
    out = {}

    t = {"ms": _time_ms(lambda: ops.row_norms(x), 10),
         "plain_ms": _time_ms(lambda: ca.row_norms_plain(x), 3),
         "library_ms": _time_ms(
             lambda: torch.linalg.vector_norm(x, dim=1), 10)}
    t["bound_ms"], t["bound_by"] = _bound(4 * n * d + 4 * n * chunks,
                                          2 * n * d)
    out["row_norms"] = t

    # pass 2 alone (bucketed s=2, CM, given factors): no single PyTorch
    # call clips, buckets and selects, so there is no library time
    t = {"ms": _time_ms(lambda: ca.clip_bucket_select(
            x, factors, maskf, idx, 2, -1.0), 10),
         "plain_ms": _time_ms(lambda: ca.clip_bucket_select_plain(
             x, factors, maskf, idx, 2, -1.0), 3),
         "library_ms": None}
    t["bound_ms"], t["bound_by"] = _bound(
        4 * n * d + 4 * d + 12 * n, (3 * n + nb + _bitonic_ops(nb)) * d)
    out["clip_bucket_select"] = t

    # masked CM; the library call is the midpoint median of the rows with
    # NaN at the masked ones, made before the timing
    vals = torch.where(mask[:, None], x, float("nan"))
    t = {"ms": _time_ms(lambda: ops.coordinate_median(x, mask), 10),
         "plain_ms": _time_ms(
             lambda: cmk.coordinate_median_plain(x, mask, -1.0), 3)}
    try:
        t["library_ms"] = _time_ms(lambda: torch.nanquantile(
            vals, 0.5, dim=0, interpolation="midpoint"), 5)
    except RuntimeError as e:  # the yardstick only; the port never calls it
        print(f"  torch.nanquantile refused the wide shape: {e}")
        t["library_ms"] = None
    del vals
    t["bound_ms"], t["bound_by"] = _bound(4 * n * d + 4 * d + 4 * n,
                                          _bitonic_ops(n) * d)
    out["coordinate_median"] = t
    for name, v in out.items():
        lib = "n/a" if v["library_ms"] is None else f"{v['library_ms']:.4f}"
        print(f"  {name:18s} kernel {v['ms']:.4f} ms  bound {v['bound_ms']:.4f}"
              f" ms ({v['bound_by']})  plain {v['plain_ms']:.4f} ms  "
              f"library {lib} ms")
    return out


def _optimum(prob):
    import torch

    x = prob.x0.clone()
    for _ in range(2000):
        x = x - 2.0 * prob.grad(x)
    return float(prob.loss(x)), torch.linalg.vector_norm(prob.grad(x))


def _predicted(name, n_diff):
    """Launches per kernel that a run of ``STEPS`` steps with ``n_diff``
    difference rounds makes: g^0 and every full round aggregate without
    clip, every difference round clips (pass 1) and aggregates."""
    n_full = STEPS - n_diff
    if name == "cm-unbucketed":  # the clip goes through pass 2 with s = 1
        return {"row_norms": n_diff, "clip_bucket_select": n_diff,
                "coordinate_median": 1 + n_full}
    return {"row_norms": n_diff if name == "clipped" else 0,
            "clip_bucket_select": 1 + STEPS, "coordinate_median": 0}


def main_path():
    """The Fig. 1 runs on the card; returns each run's launch counts."""
    import dataclasses

    import torch

    from repro_torch.api import AggregatorSpec, ClipSpec, ServerPlan
    from repro_torch.configs.paper import fig1_marina_pp, fig1_problem_kwargs
    from repro_torch.core import ByzVRMarinaPP, logistic_problem
    from repro_torch.kernels import ops

    fig1 = fig1_marina_pp(True)
    runs = {
        "clipped": fig1,
        "unclipped": fig1_marina_pp(False),
        "cm-unbucketed": dataclasses.replace(fig1, plan=ServerPlan(
            aggregate=AggregatorSpec("cm"), clip=ClipSpec(alpha=1.0))),
    }
    prob = logistic_problem(0, device="cuda", **fig1_problem_kwargs())
    cpu_prob = logistic_problem(0, device="cpu", **fig1_problem_kwargs())
    results, counts = {}, {}
    for name, cfg in runs.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, met = ByzVRMarinaPP(prob, cfg, device="cuda").run(STEPS)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        results[name] = (met, time.perf_counter() - t0)

    diff = {k: int((~m["full_round"]).sum()) for k, (m, _) in results.items()}
    full = {k: STEPS - v for k, v in diff.items()}
    f_star, _ = _optimum(cpu_prob)
    print(f"optimum of the data (full-batch GD on the CPU): {f_star:.6f}")
    for name, (met, wall) in results.items():
        loss = met["loss"]
        marks = ", ".join(f"{i + 1}: {float(loss[i]):.6f}"
                          for i in (0, 49, 99, 199, 299))
        print(f"  {name:14s} loss at steps {{{marks}}}  full rounds "
              f"{full[name]}  wall {wall / STEPS * 1e3:.3f} ms/step")
        if not torch.isfinite(loss[:100]).all():
            raise AssertionError(f"{name}: non-finite loss")
        # the plain path on the CPU makes the same draws from the same seeds
        _, ref = ByzVRMarinaPP(cpu_prob, runs[name], device="cpu").run(STEPS)
        agree = 300 if name != "unclipped" else 100
        err = float(((loss[:agree] - ref["loss"][:agree]).abs()
                     / ref["loss"][:agree].abs()).max())
        print(f"  {name:14s} vs the CPU plain path, steps 1-{agree}: "
              f"max rel err {err:.3e} [rtol 1e-4]")
        if err > 1e-4 or not torch.equal(met["full_round"], ref["full_round"]):
            raise AssertionError(f"{name}: the card and the CPU disagree")
    final = {k: float(m["loss"][-1]) for k, (m, _) in results.items()}
    if not (final["clipped"] < 0.64 and final["clipped"] - f_star < 1e-3):
        raise AssertionError(f"clipped run did not converge: {final}")
    if not final["unclipped"] > 5.0:
        raise AssertionError(f"unclipped run did not diverge: {final}")
    for name in runs:
        predicted = _predicted(name, diff[name])
        print(f"  {name:14s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this needs a CUDA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        _fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
              "a checkout of the repository")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    from repro_torch.kernels import _build

    secs = _build.build_all()
    print(f"built {', '.join(_build.SOURCES)} for sm_90a in {secs:.1f} s "
          f"into {_build.BUILD_DIR}")
    for name in _build.SOURCES:  # ptxas -v: per kernel instantiation
        log = _build.build_log(name)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {sum(1 for v in spills if v)} with spill stores "
              f"(at most {max(spills)} bytes)")

    # 2. kernel vs plain version
    checks = Checks()
    check_shape(checks, 20, 40, 1)
    check_shape(checks, 21, 40, 2)
    wide = check_shape(checks, 20, WIDE_D, 3)
    times = time_wide(*wide)
    del wide
    torch.cuda.empty_cache()

    # 3. the main path
    counts = main_path()

    # 4. the kernels line, the card, the result
    meta = {  # source, TPU kernel, the run of the path it serves
        "row_norms": ("csrc/row_norms.cu", "clip_aggregate.py:53",
                      "clipped"),
        "clip_bucket_select": ("csrc/clip_aggregate.cu",
                               "clip_aggregate.py:67", "clipped"),
        "coordinate_median": ("csrc/clip_aggregate.cu",
                              "coordinate_median.py:65", "cm-unbucketed"),
    }
    kernels = []
    for name, (source, replaces, path) in meta.items():
        if counts[path][name] < 1:
            raise AssertionError(f"{name} was not launched on its path "
                                 f"({path})")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "path": path, "launches": counts[path][name],
            "launches_by_path": {k: c[name] for k, c in counts.items()},
            "max_abs_err": checks.max_abs[name],
            **times[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
