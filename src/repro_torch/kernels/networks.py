"""Comparator networks of the selection kernels, and the header made from
them.

The selection template (``csrc/select.cuh``) sorts each coordinate's nb
values (rows, or bucket means) as order-preserving int32 keys in
registers.  Where nb and the bucket size s form one of the pairs of
``EXACT``, it runs a network of exactly nb wires written out in
``csrc/select_networks.cuh``; every other nb runs the generic bitonic
network over the least power of two of ``NB_CAPS`` that holds it.

The exact networks are Batcher's odd-even merge sort over the least power
of two P >= W, every comparator ascending (the smaller key to the lower
wire), with each comparator that touches a wire >= W dropped: a wire past
W would hold a key above every other, so such a comparator never moves a
key.  The median reads only wires 0..W//2 (positions (cnt-1)//2 and
cnt//2 of cnt <= W values), so its network is pruned backwards to the
comparators those wires depend on; a comparator of which only one output
is read afterwards keeps only that side (``"min"`` or ``"max"``).  The
trimmed mean reads every wire and keeps the whole sort.

    python -m repro_torch.kernels.networks           # rewrite the header
    python -m repro_torch.kernels.networks --check   # exit 1 if it is stale

The header is committed; ``tests/test_torch_kernels.py`` holds it equal to
``header()`` and every network here to the 0-1 principle.
"""
from __future__ import annotations

import sys
from pathlib import Path

__all__ = ["EXACT", "HEADER", "MEDIAN_COUNTS", "batcher", "pruned",
           "network", "live_wires", "median_wires", "median_network",
           "header"]

# (nb, s): the bucket counts and sizes with a network of the exact width nb.
# n = 20 at s = 1 and 2 (Fig. 1 and Fig. 2, configs/paper.py) and n = 16 at
# s = 1, 2 and 3 (the serve launcher; chip_smoke.py's bucketed median).
EXACT = ((20, 1), (16, 1), (10, 2), (8, 2), (6, 3))
HEADER = Path(__file__).resolve().parent / "csrc" / "select_networks.cuh"
# kept-row counts with a median network of their own: every count an exact
# width at s = 1 can hold
MEDIAN_COUNTS = range(1, max(w for w, s in EXACT if s == 1) + 1)


def batcher(width: int) -> list:
    """Batcher's odd-even merge sort of ``width`` wires, as (i, j) pairs
    with i < j in the order they run, every comparator ascending."""
    size = 1
    while size < width:
        size *= 2
    pairs = []
    p = 1
    while p < size:
        k = p
        while k >= 1:
            for j in range(k % p, size - k, 2 * k):
                for i in range(min(k, size - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return [(i, j) for i, j in pairs if j < width]


def pruned(pairs, live) -> list:
    """The comparators of ``pairs`` that the wires ``live`` depend on, as
    (i, j, kind): "cx" keeps both outputs, "min" only wire i's (the
    smaller), "max" only wire j's."""
    need = set(live)
    out = []
    for i, j in reversed(pairs):
        lo, hi = i in need, j in need
        if lo or hi:
            out.append((i, j, "cx" if lo and hi else ("min" if lo else "max")))
            need |= {i, j}
    return out[::-1]


def live_wires(width: int, median: bool) -> range:
    """The wires the selection reads after the network."""
    return range(width // 2 + 1 if median else width)


def network(width: int, median: bool) -> list:
    """The exact-width network the kernel runs: (i, j, kind) triples."""
    return pruned(batcher(width), live_wires(width, median))


_CALL = {"cx": "cx", "min": "cx_min", "max": "cx_max"}


def median_wires(count: int) -> list:
    """The two wires the median of ``count`` values reads: (count-1)//2 and
    count//2 (one wire when count is odd)."""
    return sorted({(count - 1) // 2, count // 2})


def median_network(count: int) -> list:
    """The network of ``count`` wires that sorts only ``median_wires``:
    the median of the kept rows at s = 1, one network for each count."""
    return pruned(batcher(count), median_wires(count))


def _ops(net) -> int:
    return sum(2 if kind == "cx" else 1 for _, _, kind in net)


def _body(net, per_line: int = 5) -> list:
    calls = [f"{_CALL[kind]}(v[{i}], v[{j}]);" for i, j, kind in net]
    return ["    " + " ".join(calls[k:k + per_line])
            for k in range(0, len(calls), per_line)]


def header() -> str:
    """The text of ``csrc/select_networks.cuh``."""
    lines = [
        "// Generated by `python -m repro_torch.kernels.networks` from",
        "// src/repro_torch/kernels/networks.py, which says how the networks are",
        "// made; do not edit by hand.",
        "//",
        "// Network<W, MEDIAN>::apply sorts W int32 keys in registers in place",
        "// (MEDIAN: only wires 0..W/2 come out sorted); MedianNetwork<C>::apply",
        "// sorts only wires (C-1)/2 and C/2 of C keys.  REPRO_EXACT_WIDTHS lists",
        "// the (nb, s) pairs that have an exact-width kernel.",
        "#pragma once",
        "",
        "namespace repro {",
        "",
        "__device__ __forceinline__ void cx(int& a, int& b) {",
        "  const int lo = min(a, b);",
        "  b = max(a, b);",
        "  a = lo;",
        "}",
        "__device__ __forceinline__ void cx_min(int& a, int b) { a = min(a, b); }",
        "__device__ __forceinline__ void cx_max(int a, int& b) { b = max(a, b); }",
        "",
        "template <int W, bool MEDIAN>",
        "struct Network;",
    ]
    widths = sorted({w for w, _ in EXACT}, reverse=True)
    for w in widths:
        for median in (False, True):
            net = network(w, median)
            what = (f"median: wires 0..{w // 2}" if median else "sort")
            lines += [
                "",
                f"// W = {w}, {what}: {len(net)} comparators, {_ops(net)} "
                "min/max",
                "template <>",
                f"struct Network<{w}, {'true' if median else 'false'}> {{",
                f"  static __device__ __forceinline__ void apply(int (&v)[{w}]) {{",
                *_body(net),
                "  }",
                "};",
            ]
    lines += ["", "template <int C>", "struct MedianNetwork;"]
    for c in MEDIAN_COUNTS:
        net = median_network(c)
        wires = " and ".join(str(w) for w in median_wires(c))
        lines += [
            "",
            f"// C = {c}, wires {wires}: {len(net)} comparators, {_ops(net)} "
            "min/max",
            "template <>",
            f"struct MedianNetwork<{c}> {{",
            f"  static __device__ __forceinline__ void apply(int (&v)[{c}]) {{",
            *_body(net),
            "  }",
            "};",
        ]
    pairs = " ".join(f"X({w}, {s})" for w, s in EXACT)
    lines += ["", f"#define REPRO_EXACT_WIDTHS(X) {pairs}", "",
              "}  // namespace repro", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    text = header()
    if args == ["--check"]:
        if HEADER.read_text() != text:
            print(f"{HEADER} is stale: run python -m "
                  "repro_torch.kernels.networks", file=sys.stderr)
            return 1
        return 0
    if args:
        print(__doc__.split("\n\n")[-2], file=sys.stderr)
        return 2
    HEADER.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
