#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises, prints no result and exits non-zero):

1. Device and build: the card's name and power limit, then every CUDA
   kernel of ``src/repro_torch/kernels/csrc`` built with nvcc (one process
   per source, started together), the build's wall seconds and each
   source's ptxas registers and spills.
2. Kernel vs plain version on the card.  Fig. 1's kernels: row norms
   (pass 1), the fused clip -> Bucketing -> CM/TM pass (bucketed s = 2
   and unbucketed, CM and TM(0.1), clip on and off) and the standalone
   masked CM/TM, at the Fig. 1 shape (n=20, d=40), an odd-n bucket-padding
   shape (n=21) and a ragged wide server-step shape (n=20, d=2^24+37,
   1.3 GB in f32).  Tolerances: the coordinate median exactly when kernel
   and plain version get the same clip factors; sums f32 rtol 1e-5.
   Fig. 2's Weiszfeld geometric-median kernels (gm_resident, diff_row_ssq,
   bucket_means, gm_update) and the whole clip_then_geometric_median,
   each against its plain version at rtol 1e-5: at the Fig. 2 shape
   (n=20, d=698, s = 1 and 2), odd n (n=21, s = 2 and 3), the largest d
   the resident rule admits at n=20 and one past it (both sides of the
   dispatch), and the wide shape (s = 1 and 2, clipped); random masks and
   an all-masked case (result 0).  At the wide shape: each kernel's time,
   its bound, the plain version's time and one library call's time
   (bucket_means: B @ x with B the (n/2, n) bucket-mean
   weights; gm_update: (w / wsum) @ x; diff_row_ssq: torch.cdist);
   gm_resident is timed at the Fig. 2 shape, the largest it takes on the
   path.
   Krum's four kernels (gram_matrix, cross_gram, weighted_row_sum,
   select_row) against their plain versions at the serve shape (n=16,
   d=4,096), an odd shape (n=17, d=4,097) and the wide shape (n=20,
   d=2^24+37), with random masks as weights, an inf in a zero-weight row,
   scale 0, winner indices out of range and bf16: the Gram and cross-Gram
   to rtol 1e-5 of each entry's scale sqrt(G_ii G_jj), the row-sum to
   rtol 1e-5, select_row exactly; and bit for bit G == G^T and
   cross_gram(x, x) == gram_matrix(x) at all three shapes, and at the
   shapes of GRAM_EDGES: rows 1-3 values off a 16-byte boundary (d = 1, 2,
   3 mod 4 in f32, odd d in bf16), tiny d (1-33), n in {1, 4, 5, 20, 128},
   many steps of misaligned rows (d = 2^20+3) and matrices whose last row
   ends at the end of their allocation.  The Gram's f32
   arithmetic is held against a float64 Gram of the same inputs, each
   entry within GRAM_F32_K * 2^-24 * sqrt(D) * (sqrt(sum_k a_ik^2 b_jk^2)
   + |G_ij|), D the most roundings a product passes through in the
   kernel's sum (``gram_rounding_depth``): the f32 summation error of
   sums of random-sign and of same-sign terms.  On f32 inputs the same
   limit must reject two stand-ins, the float64 Gram of the operands
   rounded to TF32 and to bf16, or the check fails as too loose.  At the wide
   shape each is timed beside its bound, its plain version and one library
   call (x @ x.T, a @ b.T, w @ x, x[r] * scale with r a Python int; TF32
   off), the Gram kernels also at the serve shape (their rows' ``serve``);
   select_row at an aligned winner (r = 8) and a misaligned one
   (r = 10), in f32 and bf16, with an int32 winner as the engine's.  Then
   select_row and clipped_diff_scale at every alignment, exactly:
   select_row at the wide shape at winners whose rows start at every
   residue mod 4 (f32) and 8 (bf16) and at n = 20 with d in STREAM_DS
   (every winner, int32 and int64), clipped_diff_scale at the lengths of
   SCALE_LENS starting 0-7 values past an aligned start, f32 and bf16.
   CenteredClip's two kernels (cclip_resident, cclip_update) and the whole
   clip_then_centered_clip (tau = 10, 5 steps) against their plain versions
   at rtol 1e-5, atol 1e-6: at the Fig. 1 shape (n=20, d=40, s = 2 and 1),
   odd n (n=21, s = 2 and 3), the largest d its own shared-memory rule
   admits at n=20 and one past it, and the wide shape (s = 1 and 2,
   tiled); random masks and an all-masked case (result 0).  cclip_update
   is timed at the wide shape beside its library call (torch.addmv with
   the weights s_i f_i / den and beta = 1 - sum s_i / den, checked against
   the kernel first), cclip_resident at the Fig. 1 shape and at the
   largest it takes, and the whole tiled call (s = 1, 2) with its
   launches.  The entry points: clipped_diff on one vector of 2^24+37
   values (f32 with a bool and a numeric keep mask, bf16, a 2-D shape):
   its norm to rtol 1e-6 and d and the output bit for bit given the same
   factor; bucketed_coordinate_median (an explicit permutation of the
   padded slots) bit for bit at the wide shape, in bf16 and with padded
   slots; then the entry-points run (one call of each, counted from 0)
   and their times (library: d * factor for the scale pass, in f32 and
   bf16; none for the others).
   Times: a kernel's and a library call's ``ms`` is its device time
   (``_device_ms``: after a warm-up, N back-to-back calls between one
   event pair, over N, the median of 5 windows of about 3 ms, the card
   held by a spin kernel while the host queues each window), and
   ``call_ms`` the median of single calls each between its own event
   pair (``_time_ms``, which counts the wrapper's host time while the card
   waits); plain versions keep the single-call timer.  select_row and
   clipped_diff_scale also give each wrapper's host enqueue time,
   ``enqueue_us``: a host clock over 300 calls with no synchronise.
3. Fig. 1: the paper's configuration (20 clients, 15 good, m=300, d=40,
   CM over Bucketing(2), shift-back, C=4, C_hat=20, p=0.2, gamma=0.5) on
   "cuda" with backend "auto", clipped and unclipped, 300 steps each, plus
   the clipped run with CM without Bucketing (the path of the standalone
   CM kernel).  Each run's launch counts, set to 0 just before it and
   read just after it, must equal the counts that run's own coins
   predict; the clipped run must converge (final loss < 0.64, within 1e-3
   of the optimum of the data) and the unclipped one diverge (> 5); the
   runs must agree with the plain PyTorch path on the CPU, which makes
   the same draws.  Then Algorithm 1 with compression and CenteredClip:
   fig1-randk-{40,20,5} (bench_ablation.py's RandK sweep, 400 steps, gap
   to the optimum below 1e-3, fixed from the port's CPU run),
   fig1-cclip (CenteredClip(10, 5) over Bucketing(2), 300 steps, the
   resident kernel, gap below 1e-3), fig1-theory (``from_theory`` with
   Theorem 4.2, CenteredClip and RandK k=10, 300 steps; the final loss
   below the first) and d30-randk-10 (test_compression_still_converges'
   problem and criterion: gap below 2e-2 after 400 steps); each within
   rtol 1e-4 of the CPU plain path, with its predicted launches and its
   wall ms per step.
4. Fig. 2: ``ClippedPPMomentum`` with RFA on the MLP problem, on "cuda"
   with backend "auto": fig2-rfa (the paper's Fig. 2 configuration,
   d = 698, 300 steps, the resident kernel), RFA without Bucketing on the
   majority cell (10 clients, 7 good, C = 3, gamma = 0.15) clipped and
   unclipped (300 steps each; clipped must end below 2.0 and unclipped
   above 20), and fig2-rfa-wide (the Fig. 2 configuration at MNIST's
   input width, d = 101,770, 50 steps, the tiled kernels).  Launch counts
   as in phase 3, each equal to its run's prediction; each run agrees
   with the CPU plain path at rtol 1e-4 (the unclipped run over its first
   100 steps).
5. Serving: ``AggregationServer`` on "cuda" with backend "auto" at the
   serve launcher's size (16 slots, the trailing 4 under ALIE, cohort
   12), driven by ``repro_torch.launch.serve.run_stream``:
   serve-krum-steady, serve-krum-burst (Krum, byz_bound 4, static radius
   5.0, one row or a cohort per pump), serve-multikrum-bucketed
   (multi-Krum over Bucketing(2), radius 5.0), serve-cm (CM, no clip),
   serve-cclip (CenteredClip, radius 5.0, the tiled kernels) at d = 4,096,
   8 rounds, and serve-krum-wide (d = 2^20, 4 rounds).  Every
   round's close must equal the one-shot ServerStep on the assembled
   buffer bit for bit, each run must agree with the same stream on the
   CPU plain path (rtol 1e-5, the same Krum winners and multi-Krum sets),
   end without executor faults or degraded rounds, and launch exactly
   what its own chunking predicts; a second, unchecked run of each
   gives rows per second and p50/p99 submit-to-resolution ms.
6. A ``{"kernels": [...]}`` line, then the card line, then the result.
   A kernel's ``launches`` are those of the run of the path it serves
   (``path``; "entry-points" for clipped_diff's and the bucketed median's,
   which no engine calls); ``launches_by_path`` has its counts in every
   run.
"""
import functools
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
WIDE_STEPS = 50  # fig2-rfa-wide
GM_ITERS = 8
CCLIP_TAU, CCLIP_ITERS = 10.0, 5
RANDK_KS, RANDK_STEPS = (40, 20, 5), 400  # bench_ablation.py's sweep
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
NORM_RTOL = 1e-6  # clipped_diff's norm against its plain version
GRAM_F32_K = 8.0  # the Gram's limit against float64, in f32 rounding units
# phase 4's thresholds for the unbucketed majority runs, fixed from the
# port's own CPU run (clipped 1.6687, unclipped 199.42 after 300 steps)
CLIPPED_BELOW, UNCLIPPED_ABOVE = 2.0, 20.0
# phase 3's thresholds for the compressed and CenteredClip runs, fixed
# from the port's own CPU run: gaps to the optimum 1.01e-4 (RandK k = 40,
# 20, 5, 400 steps) and 4.75e-4 (CenteredClip, 300 steps)
SWEEP_GAP_BELOW = 1e-3
MAJORITY = dict(n_clients=10, n_good=7, m=128, in_dim=32, hidden=16,
                heterogeneous=True)
# phase 2's device-time yardstick: windows of back-to-back calls
WINDOW_MS, DEVICE_WINDOWS, MAX_WINDOW_CALLS = 3.0, 5, 1000
ENQUEUE_CALLS = 300  # calls over which a wrapper's host enqueue time is taken


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


@functools.cache
def _spin_cycles_per_ms():
    """Clock cycles of the card's spin kernel (``torch.cuda._sleep``) in one
    ms, measured once."""
    import torch

    cycles = 10 ** 7
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _device_ms(fn):
    """Device time of one call: after a warm-up, N calls back to back
    between one event pair with no synchronise between them, the window
    over N; the median of DEVICE_WINDOWS windows, N chosen so that a window
    lasts about WINDOW_MS.  Before each window a spin kernel holds the card
    for 1.5 times as long as the host takes to queue the window's calls,
    so the host's cost per call stays out of the window."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(3):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    end.synchronize()
    calls = max(1, min(MAX_WINDOW_CALLS,
                       round(WINDOW_MS / max(start.elapsed_time(end) / 3,
                                             1e-3))))
    spin = int(min(1.5 * calls * host_ms + 0.2, 100.0)
               * _spin_cycles_per_ms())
    times = []
    for _ in range(DEVICE_WINDOWS):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _enqueue_us(fn, calls=ENQUEUE_CALLS):
    """Host time to enqueue one call, in us: a host clock over ``calls``
    calls with no synchronise between them, and one at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def _row(kernel, plain, library=None, reps=10, plain_reps=3):
    """One kernel's times: the kernel's and the library call's device time
    (``ms``, ``library_ms``: ``_device_ms``) and single-call time
    (``call_ms``, ``library_call_ms``: ``_time_ms``), and the plain
    version's single-call time (no yardstick, so the old timer)."""
    t = {"ms": _device_ms(kernel), "call_ms": _time_ms(kernel, reps),
         "plain_ms": _time_ms(plain, plain_reps),
         "library_ms": None, "library_call_ms": None}
    if library is not None:
        t["library_ms"] = _device_ms(library)
        t["library_call_ms"] = _time_ms(library, reps)
    return t


def _print_rows(out, digits=4):
    for name, v in out.items():
        lib = "none" if v["library_ms"] is None else (
            f"{v['library_ms']:.4f} (one call {v['library_call_ms']:.4f})")
        print(f"  {name:18s} kernel {v['ms']:.4f} ms (one call "
              f"{v['call_ms']:.4f})  bound {v['bound_ms']:.{digits}f} ms "
              f"({v['bound_by']})  plain {v['plain_ms']:.4f} ms  "
              f"library {lib} ms")


class Checks:
    """Kernel-vs-plain comparisons; keeps the worst error per kernel."""

    def __init__(self):
        self.max_abs = {}

    def compare(self, kernel, what, got, want, exact, scale=None,
                rtol=SUM_RTOL, atol=SUM_ATOL):
        """``scale``: what rtol is relative to (default |want|)."""
        import torch

        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        max_abs = float(err.max())
        scale = want.abs() if scale is None else scale
        rel = float((err / scale.clamp(min=1e-30)).max())
        if exact:
            ok = torch.equal(got, want)
            tol = "exact"
        else:
            ok = bool((err <= atol + rtol * scale).all())
            tol = f"rtol {rtol:g} atol {atol:g}"
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

    t = _row(lambda: ops.row_norms(x), lambda: ca.row_norms_plain(x),
             lambda: torch.linalg.vector_norm(x, dim=1))
    t["bound_ms"], t["bound_by"] = _bound(4 * n * d + 4 * n * chunks,
                                          2 * n * d)
    out["row_norms"] = t

    # pass 2 alone (bucketed s=2, CM, given factors): no single PyTorch
    # call clips, buckets and selects, so there is no library time
    t = _row(lambda: ca.clip_bucket_select(x, factors, maskf, idx, 2, -1.0),
             lambda: ca.clip_bucket_select_plain(x, factors, maskf, idx, 2,
                                                 -1.0))
    t["bound_ms"], t["bound_by"] = _bound(
        4 * n * d + 4 * d + 12 * n, (3 * n + nb + _bitonic_ops(nb)) * d)
    out["clip_bucket_select"] = t

    # masked CM; the library call is the midpoint median of the rows with
    # NaN at the masked ones, made before the timing
    vals = torch.where(mask[:, None], x, float("nan"))
    t = _row(lambda: ops.coordinate_median(x, mask),
             lambda: cmk.coordinate_median_plain(x, mask, -1.0))
    try:
        quantile = lambda: torch.nanquantile(  # noqa: E731
            vals, 0.5, dim=0, interpolation="midpoint")
        t["library_ms"] = _device_ms(quantile)
        t["library_call_ms"] = _time_ms(quantile, 5)
    except RuntimeError as e:  # the yardstick only; the port never calls it
        print(f"  torch.nanquantile refused the wide shape: {e}")
    del vals
    t["bound_ms"], t["bound_by"] = _bound(4 * n * d + 4 * d + 4 * n,
                                          _bitonic_ops(n) * d)
    out["coordinate_median"] = t
    _print_rows(out)
    return out


def _gm_mods():
    """(centered_clip, geometric_median) kernel modules (the package
    re-exports functions under the modules' names)."""
    return (sys.modules["repro_torch.kernels.centered_clip"],
            sys.modules["repro_torch.kernels.geometric_median"])


def _gm_plain(x, radius, mask, idx, s):
    """The plain clip_then_geometric_median: same dispatch and composition."""
    _, gmk = _gm_mods()
    return gmk.clip_then_geometric_median_plain(
        x, radius, mask, idx, iters=GM_ITERS, bucket_s=s)[0]


def check_gm(checks, x, mask, idx, s, tag, expect=None):
    """The four GM kernels and the whole clip_then_geometric_median
    against their plain versions on one input; ``expect`` ("resident" or
    "tiled") is the schedule the whole call must take.  Returns the
    padded auxiliaries."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cc, gmk = _gm_mods()
    n, d = x.shape
    norms = ca.row_norms_plain(x)
    radius = float(norms.median())
    f = ca.clip_factor(norms, radius)
    bidx = idx if s >= 2 else None
    m, fp, ip = cc.pad_bucket_aux(mask.float(), f, bidx, n, s)
    rows = m.shape[0] // s
    fits = cc.resident_smem_bytes(rows, d) <= cc.smem_budget(x.device)
    t = f"{tag} s={s}"
    if fits:
        checks.compare("gm_resident", t,
                       gmk.gm_resident(x, m, fp, ip, s, iters=GM_ITERS),
                       gmk.gm_resident_plain(x, m, fp, ip, s, iters=GM_ITERS,
                                             eps=1e-8), exact=False)
    if s >= 2:
        checks.compare("bucket_means", t, cc.bucket_means(x, m, fp, ip, s),
                       cc.bucket_means_plain(x, m, fp, ip, s)[0], exact=False)
    z = _gm_plain(x, radius, mask, bidx, s)
    checks.compare("diff_row_ssq", t, cc.diff_row_ssq(x, z, fp[:n]),
                   cc.diff_row_ssq_plain(x, z, fp[:n]), exact=False)
    ssq = cc.diff_row_ssq_plain(x, z, fp[:n])
    w = m[:n] / (ssq + 1e-8).sqrt()
    wsum = w.sum().clamp(min=1e-8)
    checks.compare("gm_update", t, gmk.gm_update(x, w, fp[:n], wsum),
                   gmk.gm_update_plain(x, w, fp[:n], wsum), exact=False)
    ops.reset_launch_counts()
    got, _ = ops.clip_then_geometric_median(x, radius, mask, bidx,
                                            iters=GM_ITERS, bucket_s=s)
    counts = ops.launch_counts()
    took = "resident" if counts["gm_resident"] else "tiled"
    if took != ("resident" if fits else "tiled") or (expect and took != expect):
        raise AssertionError(f"{t}: the whole call took the {took} schedule "
                             f"(expected {expect}, fits={fits}): {counts}")
    checks.compare("clip_then_gm", f"{t} whole call ({took})", got, z,
                   exact=False)
    none = torch.zeros_like(mask)
    zero = torch.zeros(d, device=x.device)
    checks.compare("clip_then_gm", f"{t} all rows masked",
                   ops.clip_then_geometric_median(x, radius, none, bidx,
                                                  bucket_s=s)[0], zero,
                   exact=True)
    checks.compare("clip_then_gm", f"{t} all rows masked (plain)",
                   _gm_plain(x, radius, none, bidx, s), zero, exact=True)
    return m, fp, ip


def gm_shapes(checks):
    """Phase 2's GM checks at the Fig. 2, odd-n and threshold shapes."""
    import torch

    cc, _ = _gm_mods()
    budget = cc.smem_budget(torch.device("cuda"))
    print(f"gm shapes (opt-in shared memory per block: {budget} bytes)")

    def data(n, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, d, device="cuda", generator=g)
        mask = torch.rand(n, device="cuda", generator=g) > 0.3
        mask[0] = True
        return x, mask, torch.randperm(n, device="cuda", generator=g).int()

    for s in (1, 2):
        check_gm(checks, *data(20, 698, 10 + s), s, "n=20 d=698",
                 expect="resident")
    for s in (2, 3):
        check_gm(checks, *data(21, 700, 20 + s), s, "n=21 d=700",
                 expect="resident")
    for s in (1, 2):
        rows = 20 // s
        d_max = 1
        while cc.resident_smem_bytes(rows, d_max + 1) <= budget:
            d_max += 1
        for d, expect in ((d_max, "resident"), (d_max + 1, "tiled")):
            check_gm(checks, *data(20, d, 30 + d), s, f"n=20 d={d}",
                     expect=expect)


def time_gm(x, mask, idx, checks):
    """GM checks at the wide shape, then kernel, plain and library times:
    the tiled kernels at the wide shape, gm_resident at the Fig. 2 shape."""
    import torch

    from repro_torch.kernels import ops

    cc, gmk = _gm_mods()
    n, d = x.shape
    nb = n // 2
    for s in (1, 2):
        check_gm(checks, x, mask, idx, s, f"n={n} d={d}", expect="tiled")
    out = {}
    z = torch.randn(d, device="cuda")
    t = _row(lambda: cc.diff_row_ssq(x, z),
             lambda: cc.diff_row_ssq_plain(x, z),
             lambda: torch.cdist(x, z[None]) ** 2)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + d + n), 3 * n * d)
    out["diff_row_ssq"] = t

    # the library call is one GEMM, B @ x with B[b, r] = f_r m_r / max(cnt_b,
    # 1) for the rows r of bucket b, B made before the timing
    m, fp, ip = cc.pad_bucket_aux(mask.float(), torch.rand(n, device="cuda"),
                                  idx, n, 2)
    slots = ip.long().view(nb, 2)
    cnt = m[slots].sum(dim=1).clamp(min=1.0)
    bmat = torch.zeros(nb, m.shape[0], device="cuda").scatter_(
        1, slots, (fp * m)[slots] / cnt[:, None])[:, :n].contiguous()
    checks.compare("B @ x (library)", f"n={n} d={d} s=2 vs bucket_means",
                   bmat @ x, cc.bucket_means(x, m, fp, ip, 2), exact=False)
    t = _row(lambda: cc.bucket_means(x, m, fp, ip, 2),
             lambda: cc.bucket_means_plain(x, m, fp, ip, 2), lambda: bmat @ x)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + nb * d), 4 * n * d)
    out["bucket_means"] = t

    w = torch.rand(n, device="cuda")
    wsum = w.sum()
    wn = w / wsum
    t = _row(lambda: gmk.gm_update(x, w, None, wsum),
             lambda: gmk.gm_update_plain(x, w, None, wsum), lambda: wn @ x)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + d), 2 * n * d)
    out["gm_update"] = t

    # gm_resident at the largest shape the Fig. 2 path gives it
    g = torch.Generator(device="cuda").manual_seed(5)
    xr = torch.randn(20, 698, device="cuda", generator=g)
    mr = (torch.rand(20, device="cuda", generator=g) > 0.3).float()
    fr = torch.rand(20, device="cuda", generator=g)
    ir = torch.randperm(20, device="cuda", generator=g).int()
    t = _row(lambda: gmk.gm_resident(xr, mr, fr, ir, 2, iters=GM_ITERS),
             lambda: gmk.gm_resident_plain(xr, mr, fr, ir, 2, iters=GM_ITERS,
                                           eps=1e-8), reps=20, plain_reps=10)
    rows, dr = 10, 698
    t["bound_ms"], t["bound_by"] = _bound(
        4 * (20 * dr + dr + 3 * 20),
        3 * 20 * dr + 2 * rows * dr + GM_ITERS * 5 * rows * dr)
    out["gm_resident"] = t
    _print_rows(out, digits=6)

    # the whole call, clipped, per schedule: the bytes its kernels move
    # (pass 1, bucket means, z0 and two streams per step) against the
    # bytes the function must move (its input once, its output once)
    for s in (1, 2):
        rows = n if s == 1 else nb
        moved = (4 * n * d  # pass 1
                 + (4 * (n + nb) * d if s == 2 else 0)  # bucket means
                 + 4 * (rows * d + d)  # z0
                 + GM_ITERS * 4 * (2 * rows * d + 2 * d))  # per step
        bidx = idx if s == 2 else None
        ms = _time_ms(lambda: ops.clip_then_geometric_median(
            x, 1.0, mask, bidx, bucket_s=s), 5)
        plain = _time_ms(lambda: _gm_plain(x, 1.0, mask, bidx, s), 3)
        print(f"  clip_then_gm s={s}  whole call {ms:.4f} ms  schedule bytes "
              f"{moved / 1e9:.3f} GB -> {moved / HBM_BYTES_PER_S * 1e3:.4f} ms"
              f"  function bound {4 * (n * d + d) / HBM_BYTES_PER_S * 1e3:.4f}"
              f" ms (bytes)  plain {plain:.4f} ms  library none")
    return out


def _krum_mod():
    return sys.modules["repro_torch.kernels.krum"]


def _entry_scale(gram_a, gram_b):
    """Each Gram entry's Cauchy-Schwarz scale sqrt(|A_ii B_jj|)."""
    import torch

    return torch.sqrt(torch.outer(gram_a.diagonal(), gram_b.diagonal()).abs())


def _tf32(t):
    """f32 values rounded to TF32's 10-bit mantissa (ties away from 0)."""
    import torch

    bits = (t.float().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def check_gram_f64(what, tag, got, a, b):
    """Hold a Gram or cross-Gram against the float64 product of its
    operands at the f32 summation limit (module docstring); on f32 inputs
    the limit must also reject the TF32 and bf16 stand-ins."""
    import torch

    kr = _krum_mod()
    n, d = a.shape
    a64, b64 = a.double(), b.double()
    g64 = a64 @ b64.T
    q = (a64 * a64) @ (b64 * b64).T
    tol = (GRAM_F32_K * 2.0 ** -24 * math.sqrt(kr.gram_rounding_depth(n, d))
           * (q.sqrt() + g64.abs()))
    del a64, b64, q

    def worst(g):
        return float(((g.double() - g64).abs() / tol).max())

    ratio = worst(got)
    line = f"  {what:18s} {tag + ' vs float64':44s} err/limit {ratio:.3e}"
    stand_ins = {}
    if a.dtype == torch.float32:
        stand_ins = {"tf32": worst(_tf32(a).double() @ _tf32(b).double().T),
                     "bf16": worst(a.bfloat16().double()
                                   @ b.bfloat16().double().T)}
        line += "  stand-ins " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in stand_ins.items())
    ok = ratio <= 1.0 and all(v > 1.0 for v in stand_ins.values())
    print(line + f" [limit {GRAM_F32_K:g} units] {'ok' if ok else 'FAIL'}")
    if ratio > 1.0:
        raise AssertionError(f"{what} {tag}: beyond the f32 summation limit "
                             f"of the float64 Gram ({ratio:.3e})")
    if not ok:
        raise AssertionError(f"{what} {tag}: the f32 limit does not reject a "
                             f"rounded-operand stand-in {stand_ins}")


def check_krum(checks, x, y, tag):
    """Krum's four kernels against their plain versions on (n, d) rows x
    (and y, the second cross-Gram operand), and the Gram's bitwise
    properties."""
    import torch

    kr = _krum_mod()
    n, d = x.shape
    g = torch.Generator(device="cuda").manual_seed(n + d)
    mask = torch.rand(n, device="cuda", generator=g) > 0.3
    gram = kr.gram_matrix(x)
    want = kr.gram_matrix_plain(x)
    want_y = kr.gram_matrix_plain(y)
    checks.compare("gram_matrix", tag, gram, want, exact=False,
                   scale=_entry_scale(want, want))
    check_gram_f64("gram_matrix", tag, gram, x, x)
    torch.cuda.synchronize()
    sym = torch.equal(gram, gram.T)
    same = torch.equal(kr.cross_gram(x, x), gram)
    print(f"  {'gram_matrix':18s} {tag + ' G == G^T, cross(x,x) == gram(x)':44s}"
          f" {'bit for bit' if sym and same else 'FAIL'}")
    if not (sym and same):
        raise AssertionError(f"{tag}: symmetric {sym}, cross == gram {same}")
    cross = kr.cross_gram(x, y)
    checks.compare("cross_gram", tag, cross, kr.cross_gram_plain(x, y),
                   exact=False, scale=_entry_scale(want, want_y))
    check_gram_f64("cross_gram", tag, cross, x, y)
    w = torch.rand(n, device="cuda", generator=g) * mask
    checks.compare("weighted_row_sum", f"{tag} masked weights",
                   kr.weighted_row_sum(x, w), kr.weighted_row_sum_plain(x, w),
                   exact=False)
    for win, sc in ((n // 2, 0.75), (-3, 1.0), (n + 5, 2.0), (1, 0.0)):
        win_t = torch.tensor(win, device="cuda")
        sc_t = torch.tensor(sc, device="cuda")
        checks.compare("select_row", f"{tag} row {win} scale {sc}",
                       kr.select_row(x, win_t, sc_t),
                       kr.select_row_plain(x, win_t, sc_t), exact=True)


def krum_edges(checks):
    """At the serve shape: an inf row of weight 0 and of scale 0, and bf16."""
    import torch

    kr = _krum_mod()
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(16, 4096, device="cuda", generator=g)
    x[3] = float("inf")
    w = torch.rand(16, device="cuda", generator=g)
    w[3] = 0.0
    got = kr.weighted_row_sum(x, w)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("weighted_row_sum: an inf row of weight 0 "
                             "leaked into the sum")
    checks.compare("weighted_row_sum", "n=16 d=4096 inf row of weight 0", got,
                   kr.weighted_row_sum_plain(x, w), exact=False)
    zero = torch.zeros(4096, device="cuda")
    checks.compare("select_row", "n=16 d=4096 inf row, scale 0",
                   kr.select_row(x, torch.tensor(3, device="cuda"),
                                 torch.tensor(0.0, device="cuda")), zero,
                   exact=True)
    xb = torch.randn(17, 4097, device="cuda", generator=g).bfloat16()
    yb = torch.randn(17, 4097, device="cuda", generator=g).bfloat16()
    check_krum(checks, xb, yb, "n=17 d=4097 bf16")


# (n, d, dtype, where): rows 0-3 values past an allocation's start, or the
# last row ending at the allocation's end ("end")
GRAM_EDGES = (
    (20, 4097, "f32", 1), (20, 4098, "f32", 2), (20, 4099, "f32", 3),
    (17, 4097, "bf16", 1), (20, 4099, "bf16", 0), (1, 1, "f32", 0),
    (5, 1, "f32", 1), (4, 2, "f32", 0), (20, 3, "f32", 2), (4, 5, "bf16", 1),
    (1, 33, "f32", 3), (5, 31, "f32", 0), (20, 17, "bf16", 0),
    (128, 9, "f32", 1), (128, 33, "bf16", 1), (20, 2 ** 20 + 3, "f32", 1),
    (20, 4097, "f32", "end"), (17, 4099, "bf16", "end"), (5, 3, "f32", "end"))


def _placed(n, d, dtype, where, g):
    """Random (n, d) rows ``where`` values past an allocation's start, or
    ending at its end (an allocation of whole 512-byte blocks)."""
    import torch

    per = 512 // dtype.itemsize
    size = -(-n * d // per) * per if where == "end" else where + n * d
    buf = torch.randn(size, device="cuda", generator=g).to(dtype)
    start = size - n * d if where == "end" else where
    return buf[start:].view(n, d)


def gram_edges(checks):
    """Krum's kernels (check_krum: the Gram's bitwise properties and its
    float64 limit included) at GRAM_EDGES: rows off a 16-byte boundary
    (d = 1, 2, 3 mod 4 in f32, odd d in bf16), tiny d, n in {1, 4, 5, 20,
    128}, many steps of misaligned rows, and a last row ending at the end
    of its allocation."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(17)
    for n, d, name, where in GRAM_EDGES:
        dtype = torch.float32 if name == "f32" else torch.bfloat16
        check_krum(checks, _placed(n, d, dtype, where, g),
                   _placed(n, d, dtype, where, g),
                   f"n={n} d={d} {name} at {where}")


STREAM_DS = (1, 3, 4, 5, 7, 8, 9, 4095, 4097, 2 ** 20 + 3)
SCALE_LENS = (*range(1, 10), 4095, 4096, 4097, 3 * 2 ** 20 + 7)


def stream_edges(checks, x):
    """select_row and clipped_diff_scale at every alignment, exactly:
    select_row at the wide shape at winners 0-3 in f32 (d = 1 mod 4, so
    their rows start at every residue mod 4) and 0-7 in bf16 (every residue
    mod 8), and at n = 20 with d in STREAM_DS for every winner (the
    outputs of the 20 winners stacked into one comparison), in f32 and
    bf16, with an int64 winner; clipped_diff_scale at the lengths of
    SCALE_LENS starting 0-7 values past an aligned start, in f32 and bf16
    (the 8 outputs concatenated into one comparison)."""
    import torch

    kr, cd = _krum_mod(), _cd_mod()
    sc = torch.tensor(0.75, device="cuda")
    n, d = x.shape
    for tag, xs, residues in (("f32", x, 4), ("bf16", x.bfloat16(), 8)):
        for r in range(residues):
            win = torch.tensor(r, dtype=torch.int32, device="cuda")
            checks.compare("select_row", f"n={n} d={d} {tag} row {r}",
                           kr.select_row(xs, win, sc),
                           kr.select_row_plain(xs, win, sc), exact=True)
        del xs
    g = torch.Generator(device="cuda").manual_seed(41)
    for dd in STREAM_DS:
        x32 = torch.randn(20, dd, device="cuda", generator=g)
        for tag, xs in (("f32", x32), ("bf16", x32.bfloat16())):
            wins = [torch.tensor(r, dtype=torch.int64 if r % 2 else torch.int32,
                                 device="cuda") for r in range(20)]
            checks.compare(
                "select_row", f"n=20 d={dd} {tag} every row",
                torch.stack([kr.select_row(xs, w, sc) for w in wins]),
                torch.stack([kr.select_row_plain(xs, w, sc) for w in wins]),
                exact=True)
    factor = torch.tensor(0.6180339887, device="cuda")
    for length in SCALE_LENS:
        base = torch.randn(length + 8, device="cuda", generator=g)
        for tag, src in (("f32", base), ("bf16", base.bfloat16())):
            parts = [src[o:o + length] for o in range(8)]
            checks.compare(
                "clipped_diff_scale", f"len={length} {tag} offsets 0-7",
                torch.cat([cd.clipped_diff_scale(p, factor) for p in parts]),
                torch.cat([cd.clipped_diff_scale_plain(p, factor)
                           for p in parts]), exact=True)


def _gram_rows(x, y, plain_reps):
    """gram_matrix and cross_gram on (n, d) rows x and y: kernel, plain and
    library times (x @ x.T, x @ y.T; TF32 is off) and bounds."""
    kr = _krum_mod()
    n, d = x.shape
    nt = -(-n // 4)  # the kernels' 4 x 4 tiles per side
    t = _row(lambda: kr.gram_matrix(x), lambda: kr.gram_matrix_plain(x),
             lambda: x @ x.T, plain_reps=plain_reps)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + n * n),
                                          2 * 16 * nt * (nt + 1) // 2 * d)
    c = _row(lambda: kr.cross_gram(x, y), lambda: kr.cross_gram_plain(x, y),
             lambda: x @ y.T, plain_reps=plain_reps)
    c["bound_ms"], c["bound_by"] = _bound(4 * (2 * n * d + n * n),
                                          2 * 16 * nt * nt * d)
    return {"gram_matrix": t, "cross_gram": c}


def time_krum(x, y):
    """Krum's kernels at the wide shape: kernel, plain and library times
    (TF32 is off for the library products); the Gram kernels also at the
    serve shape (n = 16, d = 4,096), under ``serve`` in their rows."""
    import torch

    kr = _krum_mod()
    n, d = x.shape
    w = torch.rand(n, device="cuda") + 0.5  # every row read
    out = _gram_rows(x, y, plain_reps=2)
    t = _row(lambda: kr.weighted_row_sum(x, w),
             lambda: kr.weighted_row_sum_plain(x, w), lambda: w @ x)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + d + n), 2 * n * d)
    out["weighted_row_sum"] = t
    _print_rows(out)
    g = torch.Generator(device="cuda").manual_seed(4)
    serve = _gram_rows(torch.randn(16, 4096, device="cuda", generator=g),
                       torch.randn(16, 4096, device="cuda", generator=g),
                       plain_reps=5)
    print("  at the serve shape n=16 d=4096:")
    _print_rows(serve, digits=6)
    for name, v in serve.items():
        out[name]["serve"] = v
    out["select_row"] = time_select_row(x)
    return out


def _variant(kernel, plain, library, bound):
    """A streaming kernel's row at one input (``_row``), with its bound and
    the host enqueue us a call of the kernel and of its library call."""
    t = _row(kernel, plain, library, reps=20, plain_reps=5)
    t["bound_ms"], t["bound_by"] = bound
    t["enqueue_us"] = _enqueue_us(kernel)
    t["library_enqueue_us"] = _enqueue_us(library)
    return t


def _print_variants(name, variants):
    for tag, v in variants.items():
        print(f"  {name:18s} {tag:22s} kernel {v['ms']:.4f} ms (one call "
              f"{v['call_ms']:.4f}, {100 * v['bound_ms'] / v['ms']:.0f}% of "
              f"bound {v['bound_ms']:.4f})  library {v['library_ms']:.4f} ms "
              f"(one call {v['library_call_ms']:.4f})  plain "
              f"{v['plain_ms']:.4f} ms  enqueue {v['enqueue_us']:.1f} us, "
              f"library {v['library_enqueue_us']:.1f} us")


def time_select_row(x):
    """select_row at the wide shape with an int32 winner (the engine's),
    at an aligned winner (r = 8: its row starts 8 d values in, a multiple
    of 4 and 8) and a misaligned one (r = n // 2 = 10: 8 bytes past a
    16-byte boundary in f32, 4 in bf16), in f32 and bf16.  The library
    call is x[r] * s with r a Python int: a view, then one multiply (in
    bf16 x[r] * s.view(1), which promotes to f32 as select_row does),
    held equal to the kernel first.  The row of the kernels line is f32 at
    r = 10; every input is in ``variants``."""
    import torch

    kr = _krum_mod()
    n, d = x.shape
    sc = torch.tensor(0.5, device="cuda")
    variants = {}
    for tag, xs, lib_sc in (("f32", x, sc), ("bf16", x.bfloat16(), sc.view(1))):
        for r in (8, n // 2):
            win = torch.tensor(r, dtype=torch.int32, device="cuda")
            got, want = kr.select_row(xs, win, sc), xs[r] * lib_sc
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"select_row {tag} r={r}: x[r] * s "
                                     "(library) differs from the kernel")
            del got, want
            variants[f"{tag} r={r}"] = _variant(
                lambda: kr.select_row(xs, win, sc),
                lambda: kr.select_row_plain(xs, win, sc),
                lambda: xs[r] * lib_sc,
                _bound((xs.element_size() + 4) * d, d))
    _print_variants("select_row", variants)
    return dict(variants[f"f32 r={n // 2}"], variants=variants)


def _cc_mod():
    return sys.modules["repro_torch.kernels.centered_clip"]


def _cclip_plain(x, radius, mask, idx, s, tau=CCLIP_TAU):
    """The plain clip_then_centered_clip: same dispatch and composition."""
    return _cc_mod().clip_then_centered_clip_plain(
        x, radius, mask, idx, tau=tau, iters=CCLIP_ITERS, bucket_s=s)[0]


def check_cclip(checks, x, mask, idx, s, tag, expect=None):
    """The two CenteredClip kernels and the whole clip_then_centered_clip
    against their plain versions on one input (tau at the median distance,
    so that some rows are clipped); ``expect`` is the schedule the whole
    call must take."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cc = _cc_mod()
    n, d = x.shape
    norms = ca.row_norms_plain(x)
    radius = float(norms.median())
    f = ca.clip_factor(norms, radius)
    bidx = idx if s >= 2 else None
    m, fp, ip = cc.pad_bucket_aux(mask.float(), f, bidx, n, s)
    rows = m.shape[0] // s
    fits = (cc.resident_smem_bytes(rows, d, "cclip")
            <= cc.smem_budget(x.device, "cclip"))
    tau = 0.5 * radius
    t = f"{tag} s={s}"
    if fits:
        checks.compare("cclip_resident", t,
                       cc.cclip_resident(x, m, fp, ip, s, iters=CCLIP_ITERS,
                                         tau=tau),
                       cc.cclip_resident_plain(x, m, fp, ip, s,
                                               iters=CCLIP_ITERS, tau=tau),
                       exact=False)
    v = _cclip_plain(x, radius, mask, bidx, s, tau)
    sc = cc._cclip_scale(tau, cc.diff_row_ssq_plain(x, v, fp[:n]), m[:n])
    den = m[:n].sum().clamp(min=1.0)
    checks.compare("cclip_update", t, cc.cclip_update(x, sc, fp[:n], v, den),
                   cc.cclip_update_plain(x, sc, fp[:n], v, den), exact=False)
    checks.compare("cclip_update", f"{t} v0 (z = 0, s = m)",
                   cc.cclip_update(x, m[:n], fp[:n], None, den),
                   cc.cclip_update_plain(x, m[:n], fp[:n], None, den),
                   exact=False)
    ops.reset_launch_counts()
    got, _ = ops.clip_then_centered_clip(x, radius, mask, bidx, tau=tau,
                                         iters=CCLIP_ITERS, bucket_s=s)
    counts = ops.launch_counts()
    took = "resident" if counts["cclip_resident"] else "tiled"
    if took != ("resident" if fits else "tiled") or (expect and took != expect):
        raise AssertionError(f"{t}: the whole call took the {took} schedule "
                             f"(expected {expect}, fits={fits}): {counts}")
    checks.compare("clip_then_cclip", f"{t} whole call ({took})", got, v,
                   exact=False)
    none = torch.zeros_like(mask)
    zero = torch.zeros(d, device=x.device)
    checks.compare("clip_then_cclip", f"{t} all rows masked",
                   ops.clip_then_centered_clip(x, radius, none, bidx, tau=tau,
                                               bucket_s=s)[0], zero,
                   exact=True)
    checks.compare("clip_then_cclip", f"{t} all rows masked (plain)",
                   _cclip_plain(x, radius, none, bidx, s, tau), zero,
                   exact=True)
    return counts


def cclip_shapes(checks):
    """Phase 2's CenteredClip checks at the Fig. 1, odd-n and threshold
    shapes; returns the largest resident d at n = 20 under Bucketing(2)."""
    import torch

    cc = _cc_mod()
    budget = cc.smem_budget(torch.device("cuda"), "cclip")
    print(f"cclip shapes (opt-in shared memory per block: {budget} bytes)")

    def data(n, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, d, device="cuda", generator=g)
        mask = torch.rand(n, device="cuda", generator=g) > 0.3
        mask[0] = True
        return x, mask, torch.randperm(n, device="cuda", generator=g).int()

    for s in (2, 1):
        check_cclip(checks, *data(20, 40, 50 + s), s, "n=20 d=40",
                    expect="resident")
    for s in (2, 3):
        check_cclip(checks, *data(21, 700, 60 + s), s, "n=21 d=700",
                    expect="resident")
    largest = {}
    for s in (1, 2):
        rows = 20 // s
        d_max = 1
        while cc.resident_smem_bytes(rows, d_max + 1, "cclip") <= budget:
            d_max += 1
        largest[s] = d_max
        for d, expect in ((d_max, "resident"), (d_max + 1, "tiled")):
            check_cclip(checks, *data(20, d, 70 + d), s, f"n=20 d={d}",
                        expect=expect)
    return largest


def time_cclip(x, mask, idx, checks, largest):
    """CenteredClip at the wide shape (checks, then times): cclip_update
    with its library call, the whole tiled call for s = 1 and 2 with its
    launches; cclip_resident at the Fig. 1 shape and at the largest shape
    its rule admits."""
    import torch

    from repro_torch.kernels import ops

    cc = _cc_mod()
    n, d = x.shape
    nb = n // 2
    for s in (1, 2):
        check_cclip(checks, x, mask, idx, s, f"n={n} d={d}", expect="tiled")
    out = {}
    g = torch.Generator(device="cuda").manual_seed(21)
    z = torch.randn(d, device="cuda", generator=g)
    f = torch.rand(n, device="cuda", generator=g)
    sc = torch.rand(n, device="cuda", generator=g) * mask.float()
    den = mask.float().sum().clamp(min=1.0)
    # the library call: z + sum_i s_i (f_i x_i - z) / den = beta z + x^T w
    # with w_i = s_i f_i / den and beta = 1 - sum_i s_i / den, made before
    # the timing; a check of the yardstick, kept out of the kernel's error
    w = sc * f / den
    beta = float(1.0 - sc.sum() / den)
    # rtol 1e-5 of the summands' magnitude |z| + sum_i |w_i x_i|, as the
    # two sum them in different orders
    checks.compare("addmv (library)", f"n={n} d={d} vs cclip_update",
                   torch.addmv(z, x.T, w, beta=beta),
                   cc.cclip_update(x, sc, f, z, den), exact=False,
                   scale=z.abs() + w.abs() @ x.abs())
    t = _row(lambda: cc.cclip_update(x, sc, f, z, den),
             lambda: cc.cclip_update_plain(x, sc, f, z, den),
             lambda: torch.addmv(z, x.T, w, beta=beta))
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + 2 * d + 2 * n),
                                          4 * n * d + 2 * d)
    out["cclip_update"] = t

    # cclip_resident at the Fig. 1 shape (its path's) and the largest
    def resident(n_r, d_r, s):
        gr = torch.Generator(device="cuda").manual_seed(d_r)
        xr = torch.randn(n_r, d_r, device="cuda", generator=gr)
        mr = (torch.rand(n_r, device="cuda", generator=gr) > 0.3).float()
        fr = torch.rand(n_r, device="cuda", generator=gr)
        ir = torch.randperm(n_r, device="cuda", generator=gr).int()
        rows = n_r // s
        t = _row(lambda: cc.cclip_resident(xr, mr, fr, ir, s,
                                           iters=CCLIP_ITERS, tau=1.0),
                 lambda: cc.cclip_resident_plain(xr, mr, fr, ir, s,
                                                 iters=CCLIP_ITERS, tau=1.0),
                 reps=20, plain_reps=10)
        t["bound_ms"], t["bound_by"] = _bound(
            4 * (n_r * d_r + d_r + 3 * n_r),
            3 * n_r * d_r + 2 * rows * d_r + CCLIP_ITERS * 6 * rows * d_r)
        return t

    out["cclip_resident"] = resident(20, 40, 2)
    big = resident(20, largest[2], 2)
    _print_rows(out, digits=6)
    print(f"  {'cclip_resident':18s} at n=20 d={largest[2]} s=2 (the largest "
          f"it takes): kernel {big['ms']:.4f} ms (one call "
          f"{big['call_ms']:.4f})  bound {big['bound_ms']:.6f} ms "
          f"({big['bound_by']})  plain {big['plain_ms']:.4f} ms")

    # the whole call, clipped, per schedule, with its launches
    for s in (1, 2):
        rows = n if s == 1 else nb
        moved = (4 * n * d  # pass 1
                 + (4 * (n + nb) * d if s == 2 else 0)  # bucket means
                 + 4 * (rows * d + d)  # v0
                 + CCLIP_ITERS * 4 * (2 * rows * d + 3 * d))  # per step
        bidx = idx if s == 2 else None
        ops.reset_launch_counts()
        ops.clip_then_centered_clip(x, 1.0, mask, bidx, bucket_s=s)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        ms = _time_ms(lambda: ops.clip_then_centered_clip(
            x, 1.0, mask, bidx, bucket_s=s), 5)
        plain = _time_ms(lambda: _cclip_plain(x, 1.0, mask, bidx, s), 3)
        print(f"  clip_then_cclip s={s}  whole call {ms:.4f} ms  launches "
              f"{launched}  schedule bytes {moved / 1e9:.3f} GB -> "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms  function bound "
              f"{4 * (n * d + d) / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)  "
              f"plain {plain:.4f} ms  library none")
    return out


def _cd_mod():
    return sys.modules["repro_torch.kernels.clipped_diff"]


def check_clipped_diff(checks, gn, go, keep, tag):
    """clipped_diff against its plain version: the norm to rtol 1e-6, the
    output bit for bit given the same factor (the plain d rescaled by the
    factor of the kernel's norm)."""
    import torch

    from repro_torch.kernels import ops

    cd = _cd_mod()
    radius = 0.25 * float(gn.numel()) ** 0.5  # clips: ||d|| ~ sqrt(0.6 N)
    scale = 10.0 / 3.0
    got, norm = ops.clipped_diff(gn, go, radius, keep, scale)
    d, psum = cd.clipped_diff_ssq_plain(gn.view(-1), go.view(-1),
                                        keep.view(-1), scale)
    checks.compare("clipped_diff_ssq", f"{tag} norm", norm,
                   torch.sqrt(psum.sum()), exact=False, rtol=NORM_RTOL,
                   atol=0.0)
    kd, _ = cd.clipped_diff_ssq(gn.view(-1), go.view(-1),
                                (keep if keep.dtype == torch.bool
                                 else keep.to(gn.dtype)).view(-1), scale)
    checks.compare("clipped_diff_ssq", f"{tag} d", kd, d, exact=True)
    factor = sys.modules["repro_torch.kernels.clip_aggregate"].clip_factor(
        norm, torch.tensor(radius, device=gn.device))
    checks.compare("clipped_diff_scale", f"{tag} out (same factor)",
                   got.view(-1), cd.clipped_diff_scale_plain(d, factor),
                   exact=True)
    return radius, scale


def time_scale(kd, factor):
    """clipped_diff_scale on 2^24+37 values in f32 and bf16 (d aligned, as
    the entry point makes it), beside its library call: d * f in f32; in
    bf16 torch.mul(d, f.view(1), out=bf16), which multiplies in f32 and
    rounds once, as the kernel does; each held equal to the kernel first.
    The row of the kernels line is f32."""
    import torch

    cd = _cd_mod()
    variants = {}
    kb = kd.bfloat16()
    buf = torch.empty_like(kb)
    for tag, dv, library in (
            ("f32", kd, lambda: kd * factor),
            ("bf16", kb, lambda: torch.mul(kb, factor.view(1), out=buf))):
        got = cd.clipped_diff_scale(dv, factor)
        want = library()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"clipped_diff_scale {tag}: the library call "
                                 "differs from the kernel")
        variants[tag] = _variant(
            lambda: cd.clipped_diff_scale(dv, factor),
            lambda: cd.clipped_diff_scale_plain(dv, factor), library,
            _bound(2 * dv.element_size() * dv.numel() + 4, dv.numel()))
    _print_variants("clipped_diff_scale", variants)
    return dict(variants["f32"], variants=variants)


def time_entry_points(checks, x, mask):
    """The worker-side clipped_diff (sites 13-14) on one vector of
    2^24+37 values and the bucketed coordinate median (site 15) at the
    wide shape: checks (f32 with a bool and a numeric keep mask, bf16),
    the entry-points run whose launches the kernels line reports, and
    kernel, plain and library times."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cd = _cd_mod()
    n, d = x.shape
    g = torch.Generator(device="cuda").manual_seed(31)
    gn = torch.randn(WIDE_D, device="cuda", generator=g)
    go = torch.randn(WIDE_D, device="cuda", generator=g)
    keep = torch.rand(WIDE_D, device="cuda", generator=g) < 0.3
    radius, scale = check_clipped_diff(checks, gn, go, keep,
                                       f"len={WIDE_D} f32 bool keep")
    check_clipped_diff(checks, gn, go, keep.float(),
                       f"len={WIDE_D} f32 f32 keep")
    check_clipped_diff(checks, gn.bfloat16(), go.bfloat16(), keep,
                       f"len={WIDE_D} bf16 bool keep")
    check_clipped_diff(checks, gn[:1001].view(7, 143), go[:1001].view(7, 143),
                       keep[:1001].view(7, 143), "shape (7, 143) f32")
    n_p = n + n % 2
    perm = torch.randperm(n_p, device="cuda", generator=g).int()
    checks.compare("bucketed_cm", f"n={n} d={d} s=2",
                   ops.bucketed_coordinate_median(x, perm, mask.float()),
                   ca.bucketed_cm_plain(x, perm, mask.float(), 2), exact=True)
    xb = x[:, :4133].bfloat16().contiguous()
    checks.compare("bucketed_cm", "n=20 d=4133 s=2 bf16",
                   ops.bucketed_coordinate_median(xb, perm, mask.float()),
                   ca.bucketed_cm_plain(xb, perm, mask.float(), 2)
                   .bfloat16(), exact=True)
    x16 = x[:16, :4133].contiguous()
    perm18 = torch.randperm(18, device="cuda", generator=g).int()
    checks.compare("bucketed_cm", "n=16 d=4133 s=3 (2 padded slots)",
                   ops.bucketed_coordinate_median(x16, perm18, mask[:16], s=3),
                   ca.bucketed_cm_plain(x16, perm18, mask[:16].float(), 3),
                   exact=True)

    # the entry points, through the calls a user makes, counted from 0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.clipped_diff(gn, go, radius, keep, scale)
    ops.bucketed_coordinate_median(x, perm, mask.float())
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    out = {}
    keep_f = keep.float()
    kd, _ = cd.clipped_diff_ssq(gn, go, keep, scale)
    factor = torch.tensor(0.5, device="cuda")
    # bool keep: g_new, g_old (4 bytes), keep (1), d written (4), partials
    t = _row(lambda: cd.clipped_diff_ssq(gn, go, keep, scale),
             lambda: cd.clipped_diff_ssq_plain(gn, go, keep, scale), reps=20,
             plain_reps=5)
    t["bound_ms"], t["bound_by"] = _bound(13 * WIDE_D + 4 * 1024, 5 * WIDE_D)
    out["clipped_diff_ssq"] = t
    t_f = _device_ms(lambda: cd.clipped_diff_ssq(gn, go, keep_f, scale))
    out["clipped_diff_scale"] = time_scale(kd, factor)
    nb = n_p // 2
    t = _row(lambda: ops.bucketed_coordinate_median(x, perm, mask.float()),
             lambda: ca.bucketed_cm_plain(x, perm, mask.float(), 2))
    t["bound_ms"], t["bound_by"] = _bound(
        4 * n * d + 4 * d + 4 * (n + n_p), (3 * n_p + nb + _bitonic_ops(nb)) * d)
    out["bucketed_cm"] = t
    _print_rows({k: v for k, v in out.items() if k != "clipped_diff_scale"})
    f32_bound, _ = _bound(16 * WIDE_D + 4 * 1024, 5 * WIDE_D)
    print(f"  {'clipped_diff_ssq':18s} with an f32 keep mask: kernel {t_f:.4f}"
          f" ms  bound {f32_bound:.4f} ms (bytes)")
    return out, counts


def _optimum(prob):
    import torch

    x = prob.x0.clone()
    for _ in range(2000):
        x = x - 2.0 * prob.grad(x)
    return float(prob.loss(x)), torch.linalg.vector_norm(prob.grad(x))


_NO_LAUNCHES = {"row_norms": 0, "clip_bucket_select": 0,
                "coordinate_median": 0, "diff_row_ssq": 0, "bucket_means": 0,
                "gm_resident": 0, "gm_update": 0, "gram_matrix": 0,
                "cross_gram": 0, "weighted_row_sum": 0, "select_row": 0,
                "bucketed_cm": 0, "cclip_resident": 0, "cclip_update": 0,
                "clipped_diff_ssq": 0, "clipped_diff_scale": 0}


def _predicted(name, n_diff):
    """Launches per kernel that a run of ``STEPS`` steps with ``n_diff``
    difference rounds makes: g^0 and every full round aggregate without
    clip, every difference round clips (pass 1) and aggregates."""
    n_full = STEPS - n_diff
    if name == "cm-unbucketed":  # the clip goes through pass 2 with s = 1
        return dict(_NO_LAUNCHES, row_norms=n_diff, clip_bucket_select=n_diff,
                    coordinate_median=1 + n_full)
    return dict(_NO_LAUNCHES, row_norms=n_diff if name == "clipped" else 0,
                clip_bucket_select=1 + STEPS)


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


def _compress_predicted(rule, steps, n_diff):
    """Launches of a compressed or CenteredClip Algorithm-1 run: g^0 and
    every step aggregate once over Bucketing(2) (d = 40 or 30: CenteredClip
    takes its resident kernel), every difference round clips (pass 1).
    Compression is elementwise work on the clients' rows, no kernel."""
    agg = "cclip_resident" if rule == "centered_clip" else \
        "clip_bucket_select"
    return dict(_NO_LAUNCHES, row_norms=n_diff, **{agg: 1 + steps})


def compress_path():
    """Phase 3's compressed and CenteredClip runs of Algorithm 1 on the
    card: fig1-randk-{40,20,5} (bench_ablation.py's sweep, 400 steps),
    fig1-cclip, fig1-theory (300 steps) and the reference's
    test_compression_still_converges problem (d = 30, 400 steps).  Each
    agrees with the CPU plain path at rtol 1e-4 and launches what its own
    coins predict.  Returns each run's launch counts."""
    import dataclasses

    import torch

    from repro_torch.api import (AggregatorSpec, BucketSpec, ClipSpec,
                                 CompressSpec, ScheduleSpec, ServerPlan)
    from repro_torch.configs.paper import (fig1_marina_pp, fig1_problem_kwargs,
                                           paper_plan)
    from repro_torch.core import (ByzVRMarinaPP, MarinaPPConfig,
                                  logistic_problem)
    from repro_torch.kernels import ops

    fig1 = fig1_marina_pp(True)
    problems = {  # kwargs, optimum on the CPU
        "fig1": (fig1_problem_kwargs(), lambda p: _optimum(p)[0]),
        "d30": (dict(n_clients=20, n_good=15, m=200, dim=30,
                     homogeneous=True), _optimum_d30),
    }

    def plan_cfg(plan):
        return lambda prob, dev: ByzVRMarinaPP(
            prob, dataclasses.replace(fig1, plan=plan), device=dev)

    def theory(prob, dev):
        return ByzVRMarinaPP.from_theory(
            prob, C=4, C_hat=20, p=0.2, delta=0.25, theorem="4.2",
            aggregator="centered_clip", compressor="rand_k",
            compressor_kwargs=(("k", 10),), attack="shb", device=dev)

    def d30_run(prob, dev):  # tests/test_marina_pp.py's _run settings
        return ByzVRMarinaPP(prob, MarinaPPConfig(
            gamma=0.5, p=0.2, C=4, C_hat=20, batch=32, attack="shb", seed=1,
            plan=ServerPlan(aggregate=AggregatorSpec("cm"),
                            clip=ClipSpec(alpha=1.0),
                            compress=CompressSpec("rand_k", k=10),
                            bucket=BucketSpec(s=2),
                            schedule=ScheduleSpec(backend="auto"))),
            device=dev)

    runs = {  # name: (problem, engine factory, steps, rule)
        **{f"fig1-randk-{k}": ("fig1", plan_cfg(
            dataclasses.replace(paper_plan("cm", 1.0),
                                compress=CompressSpec("rand_k", k=k))),
            RANDK_STEPS, "cm") for k in RANDK_KS},
        "fig1-cclip": ("fig1", plan_cfg(paper_plan("centered_clip", 1.0)),
                       STEPS, "centered_clip"),
        "fig1-theory": ("fig1", theory, STEPS, "centered_clip"),
        "d30-randk-10": ("d30", d30_run, RANDK_STEPS, "cm"),
    }
    optima = {k: opt(logistic_problem(0, device="cpu", **kw))
              for k, (kw, opt) in problems.items()}
    print("optima of the data (GD on the CPU): "
          + ", ".join(f"{k} {v:.6f}" for k, v in optima.items()))
    counts, final = {}, {}
    for name, (pname, make, steps, rule) in runs.items():
        kw = problems[pname][0]
        f_star = optima[pname]
        prob = logistic_problem(0, device="cuda", **kw)
        algo = make(prob, "cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, met = algo.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        loss = met["loss"]
        cpu = logistic_problem(0, device="cpu", **kw)
        final[name] = (float(loss[0]), float(loss[-1]), f_star)
        marks = ", ".join(f"{i + 1}: {float(loss[i]):.6f}"
                          for i in (0, 99, 199, steps - 1))
        print(f"  {name:14s} loss at steps {{{marks}}}  gap to the optimum "
              f"{float(loss[-1]) - f_star:.3e}  wall {wall / steps * 1e3:.3f}"
              f" ms/step" + (f"  gamma {algo.cfg.gamma:.6f} alpha "
                             f"{algo.plan.clip.alpha:.6f}"
                             if name == "fig1-theory" else ""))
        if not torch.isfinite(loss).all():
            raise AssertionError(f"{name}: non-finite loss")
        # the plain path on the CPU makes the same draws from the same seeds
        _, ref = make(cpu, "cpu").run(steps)
        err = float(((loss - ref["loss"]).abs() / ref["loss"].abs()).max())
        print(f"  {name:14s} vs the CPU plain path, steps 1-{steps}: max rel "
              f"err {err:.3e} [rtol 1e-4]; CPU final "
              f"{float(ref['loss'][-1]):.6f}")
        if err > 1e-4 or not torch.equal(met["full_round"], ref["full_round"]):
            raise AssertionError(f"{name}: the card and the CPU disagree")
        n_diff = int((~met["full_round"]).sum())
        predicted = _compress_predicted(rule, steps, n_diff)
        print(f"  {name:14s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    for name, (first, last, f_star) in final.items():
        if name == "fig1-theory":
            ok = last < first  # the reference's criterion for from_theory
        elif name == "d30-randk-10":
            ok = last - f_star < 2e-2  # test_compression_still_converges
        else:
            ok = last - f_star < SWEEP_GAP_BELOW
        if not ok:
            raise AssertionError(f"{name} did not converge: first {first}, "
                                 f"last {last}, optimum {f_star}")
    return counts


def _optimum_d30(prob):
    """The reference's optimum of its d = 30 problem: 3,000 GD steps of
    0.5 (tests/test_marina_pp.py ``fstar``)."""
    x = prob.x0.clone()
    for _ in range(3000):
        x = x - 0.5 * prob.grad(x)
    return float(prob.loss(x))


def _fig2_predicted(name):
    """Launches per kernel of a Fig. 2 run: g^0 and every step aggregate
    once, every clipped step (the 3.4e37 warm-up step 0 too) runs pass 1.
    d = 698 fits the resident kernel; d = 101,770 under Bucketing(2) takes
    one bucket_means pass, z0 and 8 Weiszfeld steps of diff_row_ssq +
    gm_update per call."""
    if name == "fig2-rfa-wide":
        calls = WIDE_STEPS + 1
        return dict(_NO_LAUNCHES, row_norms=WIDE_STEPS, bucket_means=calls,
                    diff_row_ssq=GM_ITERS * calls,
                    gm_update=(GM_ITERS + 1) * calls)
    clipped = name != "fig2-rfa-unbucketed-noclip"
    return dict(_NO_LAUNCHES, row_norms=STEPS if clipped else 0,
                gm_resident=STEPS + 1)


def fig2_path():
    """The Fig. 2 runs on the card; returns each run's launch counts."""
    import torch

    from repro_torch.api import AggregatorSpec, ClipSpec, ServerPlan
    from repro_torch.configs.paper import fig2_heuristic, fig2_problem_kwargs
    from repro_torch.core import (ClippedPPConfig, ClippedPPMomentum,
                                  mlp_problem)
    from repro_torch.kernels import ops

    def unbucketed(clip):
        return ClippedPPConfig(gamma=0.15, C=3, attack="shb", plan=ServerPlan(
            aggregate=AggregatorSpec("rfa"),
            clip=ClipSpec(alpha=1.0) if clip else None))

    fig2 = (0, fig2_problem_kwargs("shb"))
    runs = {  # name: (problem seed and kwargs, config, steps)
        "fig2-rfa": (fig2, fig2_heuristic("rfa", "shb", True), STEPS),
        "fig2-rfa-unbucketed-clip": ((5, MAJORITY), unbucketed(True), STEPS),
        "fig2-rfa-unbucketed-noclip": ((5, MAJORITY), unbucketed(False),
                                       STEPS),
        "fig2-rfa-wide": ((0, dict(fig2_problem_kwargs("shb"), in_dim=784,
                                   hidden=128)),
                          fig2_heuristic("rfa", "shb", True), WIDE_STEPS),
    }
    counts, final = {}, {}
    for name, ((seed, kw), cfg, steps) in runs.items():
        prob = mlp_problem(seed, device="cuda", **kw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, met = ClippedPPMomentum(prob, cfg, device="cuda").run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        loss = met["loss"]
        final[name] = float(loss[-1])
        marks = ", ".join(f"{i + 1}: {float(loss[i]):.6f}"
                          for i in (0, 49, 99, 199, 299) if i < steps)
        print(f"  {name:26s} d={prob.dim} loss at steps {{{marks}}}  wall "
              f"{wall / steps * 1e3:.3f} ms/step")
        # the plain path on the CPU makes the same draws from the same seeds
        cpu = mlp_problem(seed, device="cpu", **kw)
        _, ref = ClippedPPMomentum(cpu, cfg, device="cpu").run(steps)
        agree = 100 if name.endswith("noclip") else steps
        if not torch.isfinite(loss[:agree]).all():
            raise AssertionError(f"{name}: non-finite loss")
        err = float(((loss[:agree] - ref["loss"][:agree]).abs()
                     / ref["loss"][:agree].abs()).max())
        print(f"  {name:26s} vs the CPU plain path, steps 1-{agree}: max rel "
              f"err {err:.3e} [rtol 1e-4]; CPU final {float(ref['loss'][-1]):.6f}")
        if err > 1e-4:
            raise AssertionError(f"{name}: the card and the CPU disagree")
        predicted = _fig2_predicted(name)
        print(f"  {name:26s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    if not final["fig2-rfa-unbucketed-clip"] < CLIPPED_BELOW:
        raise AssertionError(f"clipped unbucketed run ended at "
                             f"{final['fig2-rfa-unbucketed-clip']}, not below "
                             f"{CLIPPED_BELOW}")
    if not final["fig2-rfa-unbucketed-noclip"] > UNCLIPPED_ABOVE:
        raise AssertionError(f"unclipped unbucketed run ended at "
                             f"{final['fig2-rfa-unbucketed-noclip']}, not "
                             f"above {UNCLIPPED_ABOVE}")
    return counts


SERVE_RUNS = (  # name, rule, bucket_s, radius, arrival, rounds, dim
    ("serve-krum-steady", "krum", 0, 5.0, "steady", 8, 4096),
    ("serve-krum-burst", "krum", 0, 5.0, "burst", 8, 4096),
    ("serve-multikrum-bucketed", "multi_krum", 2, 5.0, "steady", 8, 4096),
    ("serve-cm", "cm", 0, None, "steady", 8, 4096),
    ("serve-krum-wide", "krum", 0, 5.0, "steady", 4, 1 << 20),
    ("serve-cclip", "centered_clip", 0, 5.0, "steady", 8, 4096),
)
SERVE_SLOTS, SERVE_BYZ, SERVE_COHORT, SERVE_SEED = 16, 4, 12, 0


class _Audit:
    """An ``on_close`` hook that records, at every close, the round's
    selection (winner and the rows of non-zero weight) and, when asked,
    the one-shot ServerStep on the assembled buffer and mask."""

    def __init__(self, one_shot):
        self.one_shot = one_shot
        self.server = None
        self.records = []

    def __call__(self, result, state):
        import torch

        from repro_torch.serve import round_key

        srv = self.server
        ex = srv.executor
        buf, arrived, stats = state
        picked = once = None
        if ex.two_phase:  # (n, n) algebra only: no kernel launches
            sel = ex.aggregator.finalize(
                stats, mask=arrived,
                key=round_key(srv.config.seed, result.round_id),
                radius=ex.radius)
            picked = (int(sel.winner),
                      tuple(torch.nonzero(sel.weights).flatten().tolist()))
        if self.one_shot:
            once = ex.step(buf, mask=arrived,
                           key=round_key(srv.config.seed, result.round_id))
            once = once.cpu().numpy()
        self.records.append((result, picked, once))


def _audited(plan, cfg, device, one_shot=False):
    """An AggregationServer with an _Audit on its closes."""
    from repro_torch.serve import AggregationServer

    audit = _Audit(one_shot)
    audit.server = AggregationServer(plan, cfg, device=device,
                                     on_close=audit)
    return audit


def _serve_predicted(rule, bucket_s, rounds, chunks):
    """Launches of a checked serve run: one cross-Gram per chunk; per
    round one apply at the close and one Gram + apply for the one-shot
    check; CM closes (and checks) through the standalone CM kernel.
    CenteredClip at n = 16, d = 4,096 (262 KB of rows) takes the tiled
    schedule at every close and check: pass 1, v0 and CCLIP_ITERS steps
    of diff_row_ssq + cclip_update."""
    if rule == "cm":
        return dict(_NO_LAUNCHES, coordinate_median=2 * rounds)
    if rule == "centered_clip":
        return dict(_NO_LAUNCHES, row_norms=2 * rounds,
                    diff_row_ssq=2 * CCLIP_ITERS * rounds,
                    cclip_update=2 * (CCLIP_ITERS + 1) * rounds)
    apply = "select_row" if rule == "krum" and bucket_s < 2 \
        else "weighted_row_sum"
    return dict(_NO_LAUNCHES, cross_gram=chunks, gram_matrix=rounds,
                **{apply: 2 * rounds})


def serve_path():
    """Phase 5: the streaming server on the card; returns each run's
    launch counts and its rows/s and latency."""
    import numpy as np
    import torch

    from repro_torch.api import (AggregatorSpec, BucketSpec, ClipSpec,
                                 ScheduleSpec, ServerPlan)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import latency_ms, run_stream
    from repro_torch.scenarios import SyntheticCohort
    from repro_torch.serve import AggregationServer, ServeConfig

    counts, rates = {}, {}
    for name, rule, bucket_s, radius, arrival, rounds, dim in SERVE_RUNS:
        plan = ServerPlan(
            aggregate=AggregatorSpec(rule, byz_bound=SERVE_BYZ),
            clip=ClipSpec(radius=radius) if radius else None,
            bucket=BucketSpec(s=bucket_s) if bucket_s else None,
            schedule=ScheduleSpec(placement="naive", backend="auto"))
        cfg = ServeConfig(n_slots=SERVE_SLOTS, dim=dim,
                          cohort_size=SERVE_COHORT, seed=SERVE_SEED)
        per = SERVE_COHORT if arrival == "burst" else 1

        def drive(server):
            cohort = SyntheticCohort("alie", n_slots=SERVE_SLOTS, dim=dim,
                                     n_byz=SERVE_BYZ)
            return run_stream(server, cohort, rounds=rounds, seed=SERVE_SEED,
                              rows_per_pump=per)

        card = _audited(plan, cfg, "cuda", one_shot=True)
        if not card.server.executor.kernels:
            raise AssertionError(f"{name}: the executor did not take the "
                                 "kernel form on the card")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        drive(card.server)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        cpu = _audited(plan, cfg, "cpu")
        drive(cpu.server)
        timed = AggregationServer(plan, cfg, device="cuda")
        tickets, wall = drive(timed)
        lat = latency_ms(tickets)
        rates[name] = dict(rows_per_s=timed.metrics.rows_ingested / wall,
                           **lat)

        worst = 0.0
        for server in (card.server, cpu.server, timed):
            m = server.metrics
            if (m.rounds_closed != rounds or m.executor_faults
                    or m.rounds_degraded):
                raise AssertionError(f"{name}: {m.snapshot()}")
        for (rc, pc, once), (rp, pp, _), rt in zip(card.records, cpu.records,
                                                    _closed(tickets)):
            if not np.array_equal(once, rc.aggregate):
                raise AssertionError(f"{name} round {rc.round_id}: the close "
                                     "differs from the one-shot ServerStep")
            if not np.array_equal(rt, rc.aggregate):
                raise AssertionError(f"{name} round {rc.round_id}: the timed "
                                     "run closed another aggregate")
            if (rc.round_id, rc.close_reason, rc.cohort_fill) != \
                    (rp.round_id, rp.close_reason, rp.cohort_fill) \
                    or pc != pp:
                raise AssertionError(f"{name} round {rc.round_id}: card "
                                     f"{pc} vs CPU {pp}")
            err = np.abs(rc.aggregate - rp.aggregate)
            if not np.all(err <= 1e-7 + 1e-5 * np.abs(rp.aggregate)):
                raise AssertionError(f"{name} round {rc.round_id}: card and "
                                     "CPU aggregates differ")
            worst = max(worst, float((err / np.maximum(
                np.abs(rp.aggregate), 1e-30)).max()))
        predicted = _serve_predicted(rule, bucket_s, rounds,
                                     card.server.metrics.chunks_ingested)
        picks = [p for _, p, _ in card.records]
        print(f"  {name:25s} d={dim} rounds {rounds} bitwise == one-shot: ok;"
              f" vs CPU max rel err {worst:.3e} [rtol 1e-5], same winners")
        print(f"  {name:25s} winners (row, rows of non-zero weight) "
              f"{picks[:3]}{' ...' if len(picks) > 3 else ''}")
        print(f"  {name:25s} launches {counts[name]}  predicted {predicted}")
        print(f"  {name:25s} {rates[name]['rows_per_s']:.1f} rows/s  p50 "
              f"{rates[name]['p50_ms']:.3f} ms  p99 {rates[name]['p99_ms']:.3f}"
              f" ms ({len(tickets)} rows, {wall:.3f} s, unchecked run)")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    return counts, rates


def _closed(tickets):
    """The aggregates of a finished run's rounds, in round order."""
    seen = {}
    for t in tickets:
        if t.done:
            seen[t.result.round_id] = t.result.aggregate
    return [seen[k] for k in sorted(seen)]


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
    gm_shapes(checks)
    times.update(time_gm(*wide[:3], checks))
    print("krum shapes")
    for n, d, seed in ((16, 4096, 4), (17, 4097, 5)):
        g = torch.Generator(device="cuda").manual_seed(seed)
        check_krum(checks, torch.randn(n, d, device="cuda", generator=g),
                   torch.randn(n, d, device="cuda", generator=g),
                   f"n={n} d={d}")
    krum_edges(checks)
    print("gram kernels at misaligned, tiny and end-of-allocation shapes")
    gram_edges(checks)
    wide_y = torch.randn_like(wide[0])
    check_krum(checks, wide[0], wide_y, f"n=20 d={WIDE_D}")
    print("streaming kernels at every alignment")
    stream_edges(checks, wide[0])
    times.update(time_krum(wide[0], wide_y))
    del wide_y
    largest = cclip_shapes(checks)
    times.update(time_cclip(*wide[:3], checks, largest))
    print("entry points: clipped_diff, bucketed_coordinate_median")
    entry_times, entry_counts = time_entry_points(checks, *wide[:2])
    times.update(entry_times)
    del wide
    torch.cuda.empty_cache()

    # 3. Algorithm 1: Fig. 1, then the compressed and CenteredClip runs
    counts = main_path()
    counts.update(compress_path())
    counts["entry-points"] = entry_counts

    # 4. Fig. 2
    counts.update(fig2_path())

    # 5. serving
    serve_counts, _ = serve_path()
    counts.update(serve_counts)

    # 6. the kernels line, the card, the result
    meta = {  # source, TPU kernel, the run of the path it serves
        "row_norms": ("csrc/row_norms.cu", "clip_aggregate.py:53",
                      "clipped"),
        "clip_bucket_select": ("csrc/clip_aggregate.cu",
                               "clip_aggregate.py:67", "clipped"),
        "coordinate_median": ("csrc/clip_aggregate.cu",
                              "coordinate_median.py:65", "cm-unbucketed"),
        "gm_resident": ("csrc/geometric_median.cu", "geometric_median.py:39",
                        "fig2-rfa"),
        "diff_row_ssq": ("csrc/geometric_median.cu", "centered_clip.py:149",
                         "fig2-rfa-wide"),
        "bucket_means": ("csrc/geometric_median.cu", "centered_clip.py:164",
                         "fig2-rfa-wide"),
        "gm_update": ("csrc/geometric_median.cu", "geometric_median.py:61",
                      "fig2-rfa-wide"),
        "gram_matrix": ("csrc/krum.cu", "krum.py:111", "serve-krum-steady"),
        "cross_gram": ("csrc/krum.cu", "krum.py:140", "serve-krum-steady"),
        "weighted_row_sum": ("csrc/krum.cu", "krum.py:185",
                             "serve-multikrum-bucketed"),
        "select_row": ("csrc/krum.cu", "krum.py:225", "serve-krum-steady"),
        "cclip_resident": ("csrc/centered_clip.cu", "centered_clip.py:104",
                           "fig1-cclip"),
        "cclip_update": ("csrc/centered_clip.cu", "centered_clip.py:156",
                         "serve-cclip"),
        "clipped_diff_ssq": ("csrc/clipped_diff.cu", "clipped_diff.py:28",
                             "entry-points"),
        "clipped_diff_scale": ("csrc/clipped_diff.cu", "clipped_diff.py:38",
                               "entry-points"),
        "bucketed_cm": ("csrc/clip_aggregate.cu", "bucketing.py:26",
                        "entry-points"),
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
