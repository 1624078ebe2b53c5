"""The port's tree helpers (``repro_torch.core.tree_utils``) against the
reference's (``repro.core.tree_utils``), mirroring tests/test_superleaf.py:
superleaf packing round-trips, a size-0 leaf alone in its group, grouping,
validation, bf16 never up-cast, and the port's chunks bit for bit the
reference's on the same numpy tree; then ravel/unravel, the global norm
and the tree arithmetic."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import tree_utils as R
from repro_torch.core import tree_utils as T

N = 6


def _ragged_np(n=N, seed=0):
    """The reference test's ragged tree as numpy: odd widths, a stacked
    0-d scalar, a nested bf16 leaf."""
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(n, 3, 5).astype(np.float32),
        "scalar": rng.randn(n).astype(np.float32),
        "nested": {
            "b16": rng.randn(n, 17).astype(ml_dtypes.bfloat16),
            "odd": rng.randn(n, 2, 1, 3).astype(np.float32),
        },
    }


def _to_torch(tree):
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree_util.tree_map(leaf, tree)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_flatten_order_is_jaxs():
    tree = _ragged_np()
    leaves, treedef = T.tree_flatten(_to_torch(tree))
    ref = jax.tree_util.tree_leaves(tree)
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in ref]
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(_np(a), b)
    back = T.tree_unflatten(treedef, leaves)
    assert sorted(back) == ["nested", "scalar", "w"]
    assert back["nested"]["odd"] is leaves[1]


@pytest.mark.parametrize("chunk", [1, 7, 16, 1000])
def test_pack_unpack_roundtrip_is_identity(chunk):
    tree = _to_torch(_ragged_np())
    chunks, groups, unpack = T.tree_superleaf_pack(tree, chunk)
    assert all(tuple(c.shape) == (N, chunk) for c in chunks)
    assert len(groups) == len(chunks)
    # aggregate == "take worker 2's row": unpack gives worker 2's subtree
    got = unpack([c[2] for c in chunks])
    want = T.tree_map(lambda x: x[2], tree)
    assert T.tree_flatten(got)[1] == T.tree_flatten(want)[1]
    for a, b in zip(T.tree_leaves(got), T.tree_leaves(want)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_pack_handles_size_zero_leaf_alone_in_its_group():
    tree = {"a": torch.ones(4, 3), "empty": torch.zeros(4, 0,
                                                        dtype=torch.bfloat16)}
    chunks, _, unpack = T.tree_superleaf_pack(tree, 8)
    assert len(chunks) == 1  # only the f32 group gives a chunk
    got = unpack([c[0] for c in chunks])
    assert tuple(got["empty"].shape) == (0,)
    assert got["empty"].dtype == torch.bfloat16
    assert torch.equal(got["a"], torch.ones(3))


def test_pack_grouping_separates_groups():
    tree = {"a": torch.ones(4, 10), "b": torch.zeros(4, 3),
            "c": 2.0 * torch.ones(4, 5)}
    chunks, groups, unpack = T.tree_superleaf_pack(
        tree, 8, group_ids=["g0", "g1", "g0"])
    # g0: 15 columns -> 2 chunks; g1: 3 columns -> 1 chunk
    assert groups == ["g0", "g0", "g1"]
    assert torch.equal(chunks[2], torch.zeros(4, 8))
    got = unpack([c[0] for c in chunks])
    assert torch.equal(got["c"], 2.0 * torch.ones(5))


def test_pack_validation_errors():
    tree = _to_torch(_ragged_np())
    with pytest.raises(ValueError):
        T.tree_superleaf_pack({}, 8)
    with pytest.raises(ValueError):
        T.tree_superleaf_pack(tree, 0)
    with pytest.raises(ValueError):
        T.tree_superleaf_pack(tree, 8, group_ids=["only-one"])
    with pytest.raises(ValueError):
        T.tree_superleaf_pack({"a": torch.ones(3, 2), "b": torch.ones(4, 2)},
                              8)
    chunks, _, unpack = T.tree_superleaf_pack(tree, 8)
    with pytest.raises(ValueError):
        unpack([c[0] for c in chunks[:-1]])


def test_bf16_leaf_is_never_upcast():
    tree = _to_torch(_ragged_np())
    chunks, _, _ = T.tree_superleaf_pack(tree, 16)
    dtypes = [c.dtype for c in chunks]
    assert torch.bfloat16 in dtypes and torch.float32 in dtypes
    # the bf16 group's chunks hold the leaf's own bits, zero padded
    b16 = torch.cat([c for c in chunks if c.dtype == torch.bfloat16], dim=1)
    assert torch.equal(b16[:, :17], tree["nested"]["b16"])
    assert not b16[:, 17:].any()


@pytest.mark.parametrize("chunk", [1, 7, 13, 16, 64, 1000])
@pytest.mark.parametrize("grouped", [False, True])
def test_pack_matches_the_reference_bit_for_bit(chunk, grouped):
    tree = _ragged_np()
    gids = ["x", ("data", "model"), "x", None] if grouped else None
    rc, rg, _ = R.tree_superleaf_pack(
        jax.tree_util.tree_map(jnp.asarray, tree), chunk, group_ids=gids)
    tc, tg, _ = T.tree_superleaf_pack(_to_torch(tree), chunk, group_ids=gids)
    assert tg == rg and len(tc) == len(rc)
    for a, b in zip(tc, rc):
        assert a.is_contiguous()
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_ravel_unravel_and_batch_ravel_match_the_reference():
    tree = _ragged_np()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = _to_torch(tree)
    vec, unravel = T.tree_ravel(tt)
    rvec, _ = R.tree_ravel(jt)
    assert vec.dtype == torch.float32  # the widest dtype present
    np.testing.assert_array_equal(vec.numpy(), np.asarray(rvec))
    back = unravel(vec)
    for a, b in zip(T.tree_leaves(back), T.tree_leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    again = T.tree_unravel(tt, vec)
    assert all(torch.equal(a, b) for a, b in
               zip(T.tree_leaves(again), T.tree_leaves(tt)))
    mat, unravel_row = T.tree_batch_ravel(tt)
    rmat, _ = R.tree_batch_ravel(jt)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(rmat))
    row = unravel_row(mat[3])
    assert torch.equal(row["nested"]["b16"], tt["nested"]["b16"][3])


def test_global_norm_and_tree_arithmetic_match_the_reference():
    rng = np.random.RandomState(4)
    a = {"x": rng.randn(3, 4).astype(np.float32),
         "y": {"z": rng.randn(7).astype(np.float32)}}
    b = jax.tree_util.tree_map(lambda v: v[::-1].copy() * 0.5, a)
    ja, jb = (jax.tree_util.tree_map(jnp.asarray, t) for t in (a, b))
    ta, tb = (jax.tree_util.tree_map(torch.from_numpy, t) for t in (a, b))
    pairs = [
        (T.tree_add(ta, tb), R.tree_add(ja, jb)),
        (T.tree_sub(ta, tb), R.tree_sub(ja, jb)),
        (T.tree_scale(ta, 0.25), R.tree_scale(ja, 0.25)),
        (T.tree_axpy(-2.0, ta, tb), R.tree_axpy(-2.0, ja, jb)),
        (T.tree_zeros_like(ta), R.tree_zeros_like(ja)),
    ]
    for got, want in pairs:
        for g, w in zip(T.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(float(T.tree_dot(ta, tb)),
                               float(R.tree_dot(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(T.global_norm(ta)),
                               float(R.global_norm(ja)), rtol=1e-6)
    assert T.global_norm is T.tree_norm
    assert T.tree_size(ta) == R.tree_size(ja) == 19
