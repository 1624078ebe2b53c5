"""The port's kernel modules against the JAX reference, on the CPU.

On a CPU tensor every wrapper of ``repro_torch.kernels`` runs its
kernel's plain PyTorch version, so these sweeps hold the plain versions
(the kernels' arithmetic) against ``repro.kernels.ref``, against the
port's own oracles and against the Pallas kernels in interpret mode
(``repro.kernels.ops``, as tests/test_kernels.py runs them).  Inputs are
numpy arrays made from seeds.  The CUDA kernels themselves are held
against the plain versions in tests/test_torch_cuda.py, on the card.

Tolerances: the coordinate median picks input values and averages two of
them with the same f32 operations in every implementation, so it must
match exactly; sums (row norms, trimmed means, bucket means after a clip
by norms computed in another order) agree to f32 rtol 1e-5.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import _build, networks, ops
from repro_torch.kernels import clip_aggregate as ca
from repro_torch.kernels import ref as tref

# the package re-exports the function under the module's name
cmk = importlib.import_module("repro_torch.kernels.coordinate_median")

SHAPES = [(3, 64), (8, 512), (11, 700), (16, 1024), (5, 1), (32, 130)]
BUCKET_CASES = [(10, 300, 2), (11, 700, 3), (16, 1024, 2), (8, 64, 4),
                (21, 40, 2)]
SUM_TOL = dict(rtol=1e-5, atol=1e-6)


def _data(shape, seed, masked):
    rng = np.random.RandomState(seed)
    xs = rng.randn(*shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros(shape[0], bool)
        mask[: max(1, shape[0] // 2)] = True
        rng.shuffle(mask)
    return xs, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# coordinate_median.py (site 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_cm_plain_matches_reference_exactly(shape, masked):
    xs, mask = _data(shape, 1 + shape[0] * 7 + shape[1], masked)
    out = ops.coordinate_median(_t(xs), _t(mask)).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(rref.coordinate_median_ref(_j(xs), _j(mask))))
    np.testing.assert_array_equal(
        out, tref.coordinate_median_ref(_t(xs), _t(mask)).numpy())
    sel = xs if mask is None else xs[mask]
    np.testing.assert_allclose(out, np.median(sel, axis=0), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("trim", [0.0, 0.1, 0.25])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_tm_plain_matches_reference(shape, trim, masked):
    xs, mask = _data(shape, 2 + shape[0] * 5 + shape[1], masked)
    out = ops.trimmed_mean(_t(xs), _t(mask), trim_ratio=trim).numpy()
    np.testing.assert_allclose(
        out, np.asarray(rref.trimmed_mean_ref(_j(xs), _j(mask), trim)),
        **SUM_TOL)
    np.testing.assert_allclose(
        out, tref.trimmed_mean_ref(_t(xs), _t(mask), trim).numpy(), **SUM_TOL)


@pytest.mark.parametrize("shape", [(11, 700), (5, 1), (32, 130)], ids=str)
@pytest.mark.parametrize("trim", [-1.0, 0.1])
def test_cm_tm_plain_matches_pallas_interpret(shape, trim):
    xs, mask = _data(shape, 3 + shape[1], True)
    out = ops.trimmed_mean(_t(xs), _t(mask), trim_ratio=trim).numpy() \
        if trim >= 0 else ops.coordinate_median(_t(xs), _t(mask)).numpy()
    ref = rops.trimmed_mean(_j(xs), _j(mask), trim_ratio=trim) if trim >= 0 \
        else rops.coordinate_median(_j(xs), _j(mask))
    if trim < 0:
        np.testing.assert_array_equal(out, np.asarray(ref))
    else:  # the Pallas kernel sums in row order, the port in sorted order
        np.testing.assert_allclose(out, np.asarray(ref), **SUM_TOL)


def test_cm_bf16_plain_matches_reference():
    xs, mask = _data((11, 700), 4, True)
    xt = _t(xs).to(torch.bfloat16)
    out = ops.coordinate_median(xt, _t(mask))
    assert out.dtype == torch.bfloat16
    ref = rref.coordinate_median_ref(jnp.asarray(xs, jnp.bfloat16), _j(mask))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_all_masked_count_zero_pinned():
    """cnt = 0 (every row masked out).  The jnp reference gives 3.4e37 for
    the median; the Pallas kernel gives 1.7e37 (0.5 * the value at rank
    0).  The port takes the jnp semantics in the kernel and its plain
    version alike.  The trimmed mean gives 1.7e37 everywhere (t = -1
    keeps position 0, divided by cnt - 2t = 2)."""
    xs = np.random.RandomState(5).randn(6, 33).astype(np.float32)
    none = np.zeros(6, bool)
    big = np.float32(3.4e37)
    cm = ops.coordinate_median(_t(xs), _t(none)).numpy()
    np.testing.assert_array_equal(cm, np.full(33, big))
    np.testing.assert_array_equal(
        cm, np.asarray(rref.coordinate_median_ref(_j(xs), _j(none))))
    np.testing.assert_array_equal(
        np.asarray(rops.coordinate_median(_j(xs), _j(none))),
        np.full(33, big / 2))
    tm = ops.trimmed_mean(_t(xs), _t(none), 0.1).numpy()
    np.testing.assert_array_equal(tm, np.full(33, big / 2))
    np.testing.assert_array_equal(
        tm, np.asarray(rref.trimmed_mean_ref(_j(xs), _j(none), 0.1)))
    fused, _ = ops.clip_then_aggregate(_t(xs), 1.0, _t(none),
                                       _t(np.arange(6, dtype=np.int32)),
                                       bucket_s=2)
    np.testing.assert_array_equal(fused.numpy(), np.full(33, big))


@pytest.mark.parametrize("n_nan", [1, 6], ids=["one-nan-row", "nan-majority"])
@pytest.mark.parametrize("trim", [-1.0, 0.1])
def test_nan_rows_sort_last_as_in_reference(n_nan, trim):
    """A NaN message (a Byzantine worker can send one) sorts after every
    value, as jnp.sort and torch.sort order it, even after the 3.4e37 of
    masked rows: one NaN row leaves the result finite, and a NaN majority
    selects NaN or a masked row's 3.4e37, as in the reference.  The
    kernel's integer sort keys keep this order (tests/test_torch_cuda.py)."""
    rng = np.random.RandomState(40 + n_nan)
    xs = rng.randn(11, 70).astype(np.float32)
    xs[rng.permutation(11)[:n_nan]] = np.nan
    mask = np.ones(11, bool)
    mask[rng.randint(11)] = False
    if trim < 0:
        out = ops.coordinate_median(_t(xs), _t(mask)).numpy()
        ref = rref.coordinate_median_ref(_j(xs), _j(mask))
    else:
        out = ops.trimmed_mean(_t(xs), _t(mask), trim).numpy()
        ref = rref.trimmed_mean_ref(_j(xs), _j(mask), trim)
    assert (np.abs(out) < 1e30).all() == (n_nan == 1)
    np.testing.assert_allclose(out, np.asarray(ref), equal_nan=True,
                               **SUM_TOL)
    idx = rng.permutation(11).astype(np.int32)
    fused, _ = ops.clip_then_aggregate(_t(xs), 1.5, _t(mask), _t(idx),
                                       trim_ratio=trim, bucket_s=2)
    rfused, _ = rref.clip_then_aggregate_ref(_j(xs), 1.5, _j(mask), _j(idx),
                                             trim_ratio=trim, bucket_s=2)
    np.testing.assert_allclose(fused.numpy(), np.asarray(rfused),
                               equal_nan=True, **SUM_TOL)


def test_slot_limit_raises_value_error():
    with pytest.raises(ValueError, match="at most 128"):
        ops.coordinate_median(torch.zeros(129, 4))
    with pytest.raises(ValueError, match="at most 128"):
        ops.clip_then_aggregate(torch.zeros(300, 4), 1.0, bucket_s=2)
    assert cmk.nb_cap(10) == 16 and cmk.nb_cap(20) == 32
    assert cmk.nb_cap(128) == 128


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(4, dtype=torch.float32), ValueError),
    (torch.zeros(3, 4, dtype=torch.int32), TypeError),
    (torch.zeros(0, 4), ValueError),
])
def test_wrappers_reject_bad_inputs(bad, err):
    with pytest.raises(err):
        ops.coordinate_median(bad)
    with pytest.raises(err):
        ops.row_norms(bad)


def test_wrappers_reject_mismatched_row_vectors():
    xs = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="mask must have shape"):
        ops.coordinate_median(xs, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="bucket_idx must have shape"):
        ops.clip_then_aggregate(xs, 1.0, None, torch.arange(4), bucket_s=2)


# ---------------------------------------------------------------------------
# clip_aggregate.py (sites 1 and 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_row_norms_plain_matches_reference(shape):
    xs, _ = _data(shape, 6 + shape[1], False)
    _, rnorms = rref._clip_rows_ref(_j(xs), 1.0, None)
    np.testing.assert_allclose(ops.row_norms(_t(xs)).numpy(),
                               np.asarray(rnorms), **SUM_TOL)


def test_clip_factor_matches_reference():
    from repro.kernels.clip_aggregate import clip_factor as rclip_factor

    norms = np.array([0.0, 1e-31, 0.5, 2.0, 1e6, np.inf], np.float32)
    for radius in (0.0, 1.5, np.inf):
        np.testing.assert_array_equal(
            ca.clip_factor(_t(norms), radius).numpy(),
            np.asarray(rclip_factor(_j(norms), radius)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("trim", [-1.0, 0.1])
def test_fused_unbucketed_plain_matches_reference(shape, masked, trim):
    xs, mask = _data(shape, 7 + shape[0] + shape[1], masked)
    out, norms = ops.clip_then_aggregate(_t(xs), 1.5, _t(mask),
                                         trim_ratio=trim)
    rout, rnorms = rref.clip_then_aggregate_ref(_j(xs), 1.5, _j(mask),
                                                trim_ratio=trim)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **SUM_TOL)
    np.testing.assert_allclose(norms.numpy(), np.asarray(rnorms), **SUM_TOL)
    tout, _ = tref.clip_then_aggregate_ref(_t(xs), 1.5, _t(mask),
                                           trim_ratio=trim)
    np.testing.assert_allclose(out.numpy(), tout.numpy(), **SUM_TOL)


@pytest.mark.parametrize("n,d,s", BUCKET_CASES, ids=str)
@pytest.mark.parametrize("trim", [-1.0, 0.1])
@pytest.mark.parametrize("use_clip", [True, False], ids=["clip", "noclip"])
def test_fused_bucketed_plain_matches_reference(n, d, s, trim, use_clip):
    rng = np.random.RandomState(n * 17 + s)
    xs = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n) > 0.25
    idx = rng.permutation(n).astype(np.int32)
    out, norms = ops.clip_then_aggregate(_t(xs), 1.2, _t(mask), _t(idx),
                                         trim_ratio=trim, bucket_s=s,
                                         use_clip=use_clip)
    radius = 1.2 if use_clip else np.inf
    rout, _ = rref.clip_then_aggregate_ref(_j(xs), radius, _j(mask), _j(idx),
                                           trim_ratio=trim, bucket_s=s)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **SUM_TOL)
    assert (norms is None) == (not use_clip)
    tout, _ = tref.clip_then_aggregate_ref(_t(xs), radius, _t(mask), _t(idx),
                                           trim_ratio=trim, bucket_s=s)
    np.testing.assert_allclose(out.numpy(), tout.numpy(), **SUM_TOL)


@pytest.mark.parametrize("n,d,s", [(11, 700, 3), (21, 40, 2), (9, 130, 1)],
                         ids=str)
@pytest.mark.parametrize("trim", [-1.0, 0.1])
def test_fused_plain_matches_pallas_interpret(n, d, s, trim):
    """Given the same per-row factors, the plain version repeats the
    Pallas kernel's arithmetic (x*f, mask-weighted bucket sums, one
    division), so the median matches bit for bit; with pass 1 the
    factors come from norms summed in another order."""
    rng = np.random.RandomState(n * 3 + d)
    xs = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n) > 0.3
    idx = rng.permutation(n).astype(np.int32)
    factors = rng.uniform(0.2, 1.0, n).astype(np.float32)
    kw = dict(trim_ratio=trim, bucket_s=s)
    out = ca.clip_bucket_select(_t(xs), _t(factors), _t(mask).float(),
                                _t(idx) if s > 1 else None, s, trim)
    rout, _ = rops.clip_then_aggregate(_j(xs), 0.9, _j(mask), _j(idx),
                                       _j(factors), **kw)
    if trim < 0:
        np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **SUM_TOL)
    out, norms = ops.clip_then_aggregate(_t(xs), 0.9, _t(mask), _t(idx), **kw)
    rout, rnorms = rops.clip_then_aggregate(_j(xs), 0.9, _j(mask), _j(idx),
                                            **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **SUM_TOL)
    np.testing.assert_allclose(norms.numpy(), np.asarray(rnorms), **SUM_TOL)


def test_bucket_padding_and_out_of_range_indices_are_empty_slots():
    """n = 5, s = 2 pads one slot; an index outside [0, n) is an empty
    slot too, so both orders give the same buckets {0,1}, {2,3}, {4}."""
    xs = torch.arange(15, dtype=torch.float32).view(5, 3)
    a, _ = ops.clip_then_aggregate(xs, 0.0, None, torch.arange(5),
                                   bucket_s=2, use_clip=False)
    means = torch.stack([xs[0:2].mean(0), xs[2:4].mean(0), xs[4]])
    np.testing.assert_array_equal(a.numpy(), means.median(0).values.numpy())
    b = ca.clip_bucket_select_plain(xs, torch.ones(5), torch.ones(5),
                                    torch.tensor([0, 1, 2, 3, 4]), 2, -1.0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = ca.clip_bucket_select_plain(xs, torch.ones(5),
                                    torch.tensor([1., 1, 1, 1, 0]),
                                    torch.tensor([0, 1, 2, 3, 99]), 2, -1.0)
    # bucket {4} is empty in c: the median of the first two bucket means
    np.testing.assert_array_equal(c.numpy(), (0.5 * (means[0] + means[1]))
                                  .numpy())


def test_slot_table_limit_raises_value_error():
    """The kernel keeps 4 shared-memory words a row slot and 2 a bucket in
    48 KiB: 3,000 slots in 100 buckets fit, 3,060 in 102 raise."""
    ok = torch.zeros(3000, 2)
    ca.clip_bucket_select(ok, torch.ones(3000), torch.ones(3000), None, 30,
                          -1.0)
    big = torch.zeros(3060, 2)
    with pytest.raises(ValueError, match="4 words per row slot"):
        ca.clip_bucket_select(big, torch.ones(3060), torch.ones(3060), None,
                              30, -1.0)


# ---------------------------------------------------------------------------
# networks.py: the selection template's comparator networks
# ---------------------------------------------------------------------------

def _zero_one_inputs(width):
    """(width, 2^width) int8: column c holds the bits of c."""
    cols = np.arange(2 ** width, dtype=np.int64)
    return ((cols[None, :] >> np.arange(width)[:, None]) & 1).astype(np.int8)


@pytest.mark.parametrize("width", range(1, 21))
@pytest.mark.parametrize("median", [False, True], ids=["sort", "median"])
def test_network_sorts_its_live_wires_by_the_0_1_principle(width, median):
    """Every network the generator makes for W <= 20, on all 2^W inputs of
    0s and 1s: its live wires hold the sorted values (a comparator network
    that sorts every 0-1 input sorts every input)."""
    v = list(_zero_one_inputs(width))
    for i, j, kind in networks.network(width, median):
        lo, hi = np.minimum(v[i], v[j]), np.maximum(v[i], v[j])
        if kind in ("cx", "min"):
            v[i] = lo
        if kind in ("cx", "max"):
            v[j] = hi
    want = np.sort(_zero_one_inputs(width), axis=0)
    for k in networks.live_wires(width, median):
        np.testing.assert_array_equal(v[k], want[k])


@pytest.mark.parametrize("count", networks.MEDIAN_COUNTS)
def test_median_network_sorts_its_two_wires_by_the_0_1_principle(count):
    """The median network of each kept-row count, on all 2^count 0-1
    inputs: wires (count-1)//2 and count//2 hold the sorted values."""
    v = list(_zero_one_inputs(count))
    for i, j, kind in networks.median_network(count):
        assert 0 <= i < j < count
        lo, hi = np.minimum(v[i], v[j]), np.maximum(v[i], v[j])
        if kind in ("cx", "min"):
            v[i] = lo
        if kind in ("cx", "max"):
            v[j] = hi
    want = np.sort(_zero_one_inputs(count), axis=0)
    for k in networks.median_wires(count):
        np.testing.assert_array_equal(v[k], want[k])


def test_networks_are_ascending_and_pruned_to_width():
    """Every comparator puts the smaller key on the lower wire and touches
    only wires < W; the counts at the widths of Fig. 1 and Fig. 2."""
    for width, _ in networks.EXACT:
        for median in (False, True):
            for i, j, kind in networks.network(width, median):
                assert 0 <= i < j < width and kind in ("cx", "min", "max")
    assert len(networks.network(20, False)) == 103
    assert len(networks.network(20, True)) == 92
    assert len(networks.network(10, False)) == 32
    assert len(networks.median_network(20)) == 84
    assert len(networks.median_network(13)) == 39
    assert len(networks.batcher(32)) == 191


def test_network_header_is_generated_from_the_package():
    """csrc/select_networks.cuh is header() as committed, and lists the
    exact widths the wrappers' nb and s can take."""
    assert networks.HEADER.read_text() == networks.header()
    assert networks.main(["--check"]) == 0
    for width, s in networks.EXACT:
        assert f"X({width}, {s})" in networks.header()
        assert cmk.nb_cap(width) >= width


def test_launch_counts_move_only_on_launch():
    ops.reset_launch_counts()
    xs = torch.randn(6, 20)
    ops.clip_then_aggregate(xs, 1.0, bucket_s=2)
    ops.coordinate_median(xs)
    ops.clip_then_geometric_median(xs, 1.0, bucket_s=2)
    ops.geometric_median(xs)
    ops.clip_then_krum(xs, 1.0, bucket_s=2, multi=True)
    ops.krum(xs)
    ops.krum_cross_gram(xs, xs)
    ops.clip_then_centered_clip(xs, 1.0, bucket_s=2)
    ops.centered_clip(xs)
    ops.clipped_diff(xs, xs.flip(0), 1.0, xs > 0, 2.0)
    ops.bucketed_coordinate_median(xs, torch.arange(6))
    assert ops.launch_counts() == {"row_norms": 0, "clip_bucket_select": 0,
                                   "coordinate_median": 0, "diff_row_ssq": 0,
                                   "bucket_means": 0, "gm_resident": 0,
                                   "gm_update": 0, "gram_matrix": 0,
                                   "cross_gram": 0, "weighted_row_sum": 0,
                                   "select_row": 0, "bucketed_cm": 0,
                                   "cclip_resident": 0, "cclip_update": 0,
                                   "clipped_diff_ssq": 0,
                                   "clipped_diff_scale": 0}


def test_failed_launch_and_build_raise_kernel_error(monkeypatch, tmp_path):
    """Build and launch failures are KernelErrors, which callers that
    degrade on other errors let through."""

    class Lib:
        @staticmethod
        def repro_cuda_error_string(rc):
            return b"an illegal memory access was encountered"

    _build.check(Lib, "gram_matrix", 0)
    with pytest.raises(_build.KernelError, match="gram_matrix launch failed"):
        _build.check(Lib, "gram_matrix", 700)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build.build_all(("krum",))
    assert issubclass(_build.KernelError, RuntimeError)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A failed build raises; there is no fallback to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert set(_build.SOURCES) == {"row_norms", "clip_aggregate",
                                   "geometric_median", "krum",
                                   "centered_clip", "clipped_diff"}
    # each library is named by a hash of its sources and flags
    assert _build._lib_path("row_norms") != _build._lib_path("clip_aggregate")


def test_build_starts_nvcc_and_returns(monkeypatch, tmp_path):
    """``_build.start_all`` starts one nvcc per source and returns before
    they end (the caller runs other work meanwhile); ``finish_all`` waits,
    keeps each nvcc's output as the library's build log, and raises after
    every nvcc has ended when one failed, and gives each source's nvcc
    seconds.  A stand-in nvcc script plays the compiler (this container
    has none)."""
    import os
    import time

    from repro_torch.kernels import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=''\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=\"$2\"; shift; done\n"
        "echo 'ptxas info    : Used 32 registers'\n"
        "sleep 0.5\n"
        "case \"$out\" in *krum*) echo 'error: planted'; exit 1;; esac\n"
        "touch \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    started = _build.start_all(("row_norms", "clipped_diff"))
    assert time.perf_counter() - started[0] < 0.4  # nvcc still running
    seconds = {}
    assert _build.finish_all(started, seconds) >= 0.5
    assert sorted(seconds) == ["clipped_diff", "row_norms"]
    assert all(0.4 < v < 5 for v in seconds.values()), seconds
    assert "Used 32 registers" in _build.build_log("row_norms")
    assert _build._lib_path("clipped_diff").exists()
    assert _build.build_all(("row_norms",)) < 0.4  # built: no nvcc
    with pytest.raises(_build.KernelError, match="planted"):
        _build.build_all(("krum", "centered_clip"))
    assert _build._lib_path("centered_clip").exists()  # its nvcc ended
    assert not _build._lib_path("krum").exists()
