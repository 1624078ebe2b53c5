"""Tree <-> flat-vector helpers, the counterpart of
``repro.core.tree_utils``.

A parameter tree is nested dicts of tensors (lists and tuples are nodes
too), flattened as JAX flattens it: dict keys in sorted order, depth
first, so ``{"a": ..., "b": {"c": ...}}`` gives the leaves a, b.c."""
from __future__ import annotations

import math

import torch

__all__ = [
    "tree_flatten",
    "tree_unflatten",
    "tree_leaves",
    "tree_map",
    "tree_ravel",
    "tree_unravel",
    "tree_batch_ravel",
    "tree_superleaf_pack",
    "tree_add",
    "tree_sub",
    "tree_scale",
    "tree_axpy",
    "tree_zeros_like",
    "tree_dot",
    "tree_norm",
    "global_norm",
    "tree_size",
]


_NONE = ("none",)  # the treedef of a None: a node with no leaves, as in JAX


def _walk(node, leaves, is_leaf):
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return None
    if node is None:
        return _NONE
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, keys, [_walk(node[k], leaves, is_leaf) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), None, [_walk(c, leaves, is_leaf) for c in node])
    leaves.append(node)
    return None


def tree_flatten(tree, is_leaf=None):
    """(leaves, treedef) in JAX's order; anything that is not a dict, list,
    tuple or None is a leaf, and so is a node for which ``is_leaf`` is
    true.  None holds no leaf and comes back as None."""
    leaves = []
    return leaves, _walk(tree, leaves, is_leaf)


def _build(node, it):
    if node is None:
        return next(it)
    if node is _NONE:
        return None
    kind, keys, children = node
    values = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(keys, values))
    if hasattr(kind, "_fields"):  # a NamedTuple
        return kind(*values)
    return kind(values)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flatten order.  (The
    recursion is a module-level function: a nested one that refers to
    itself would form a reference cycle that keeps ``leaves`` alive until
    the garbage collector runs.)"""
    return _build(treedef, iter(leaves))


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn, tree, *rest):
    """``fn`` leafwise over ``tree`` and trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _result_dtype(dtypes):
    dtype = dtypes[0]
    for dt in dtypes[1:]:
        dtype = torch.promote_types(dtype, dt)
    return dtype


def _unraveler(treedef, shapes, dtypes):
    sizes = [math.prod(s) for s in shapes]

    def unravel(v):
        out, offset = [], 0
        for shape, dt, size in zip(shapes, dtypes, sizes):
            out.append(v[offset:offset + size].reshape(shape).to(dt))
            offset += size
        return tree_unflatten(treedef, out)

    return unravel


def tree_ravel(tree):
    """Flatten a tree into one 1-D vector of the widest dtype present.
    Returns (vector, unravel_fn)."""
    leaves, treedef = tree_flatten(tree)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    if leaves:
        dtype = _result_dtype(dtypes)
        vec = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    else:
        vec = torch.zeros((0,), dtype=torch.float32)
    return vec, _unraveler(treedef, shapes, dtypes)


def tree_unravel(template, vec):
    """``vec`` in the structure, shapes and dtypes of ``template``."""
    _, unravel = tree_ravel(template)
    return unravel(vec)


def _stacked(leaves) -> int:
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(
                f"leading worker axes disagree: {leaf.shape[0]} != {n}")
    return n


def tree_batch_ravel(tree):
    """Flatten a tree of per-worker tensors into ONE contiguous (n, d)
    matrix (so a multi-tensor gradient reaches the kernels in one launch).

    Every leaf carries the same leading worker axis n; leaf (n, *s)
    contributes prod(s) columns.  Returns (matrix, unravel_row) where
    ``unravel_row`` maps an aggregated (d,) row back to the tree of
    per-leaf shapes without the worker axis."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("tree_batch_ravel: empty tree")
    n = _stacked(leaves)
    shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    dtype = _result_dtype(dtypes)
    mat = torch.cat([leaf.reshape(n, math.prod(s)).to(dtype)
                     for leaf, s in zip(leaves, shapes)], dim=1)
    return mat, _unraveler(treedef, shapes, dtypes)


def tree_superleaf_pack(tree, chunk_elems: int, *, group_ids=None):
    """Pack a worker-stacked tree into UNIFORM (n, chunk_elems) chunks.

    The per-leaf coordinate spans are concatenated (per group) and re-cut
    into equal ``chunk_elems``-column chunks, zero-padding only the final
    chunk of each group, so a per-chunk kernel and collective pipeline
    runs one uniform dispatch per chunk.  Zero padding is neutral for
    every registry rule (a coordinate where all workers hold 0 aggregates
    to 0 and adds 0 to every row statistic) and ``unpack`` slices it off.

    ``group_ids`` (aligned with the flattened leaves) keeps leaves with
    different ids in different chunks (the mesh groups by shard axes, so
    each chunk has one cross-shard reduction); None packs the whole tree
    as one group.  Leaves are always split by dtype as well: a bf16 leaf
    is never up-cast into an f32 chunk.

    Returns ``(chunks, chunk_groups, unpack)``: the list of (n,
    chunk_elems) matrices, the group id of each, and ``unpack(rows)``,
    which maps the per-chunk aggregated rows (chunk_elems,) back to the
    tree of per-leaf shapes (worker axis dropped, dtypes restored)."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("tree_superleaf_pack: empty tree")
    if chunk_elems < 1:
        raise ValueError(f"chunk_elems must be >= 1, got {chunk_elems}")
    n = _stacked(leaves)
    if group_ids is None:
        group_ids = [None] * len(leaves)
    if len(group_ids) != len(leaves):
        raise ValueError(
            f"group_ids length {len(group_ids)} != {len(leaves)} leaves")
    shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [math.prod(s) for s in shapes]

    groups = {}  # (id, dtype) -> leaf indices, first-appearance order
    for i, gid in enumerate(group_ids):
        groups.setdefault((gid, dtypes[i]), []).append(i)

    chunks, chunk_groups, metas = [], [], []
    for (gid, _dt), idxs in groups.items():
        mat = torch.cat([leaves[i].reshape(n, sizes[i]) for i in idxs], dim=1)
        width = mat.shape[1]
        pad = (-width) % chunk_elems
        if pad:
            mat = torch.nn.functional.pad(mat, (0, pad))
        n_chunks = mat.shape[1] // chunk_elems
        for c in range(n_chunks):
            chunks.append(
                mat[:, c * chunk_elems:(c + 1) * chunk_elems].contiguous())
        chunk_groups.extend([gid] * n_chunks)
        metas.append((idxs, width, n_chunks))

    def unpack(rows):
        if len(rows) != len(chunks):
            raise ValueError(
                f"unpack expects {len(chunks)} rows, got {len(rows)}")
        out = [None] * len(leaves)
        off = 0
        for idxs, width, n_chunks in metas:
            if n_chunks:
                flat = torch.cat([r.reshape(-1)
                                  for r in rows[off:off + n_chunks]])[:width]
            else:
                # a group whose every leaf is size 0 packs to no chunks
                flat = torch.zeros((0,), dtype=torch.float32)
            off += n_chunks
            pos = 0
            for i in idxs:
                out[i] = flat[pos:pos + sizes[i]].reshape(shapes[i]).to(
                    dtypes[i])
                pos += sizes[i]
        return tree_unflatten(treedef, out)

    return chunks, chunk_groups, unpack


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_dot(a, b) -> torch.Tensor:
    """Sum over the leaves, in flatten order, of the f32 sums of their
    products."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        part = (x.float() * y.float()).sum()
        total = part if total is None else total + part
    return torch.zeros((), dtype=torch.float32) if total is None else total


def tree_norm(tree) -> torch.Tensor:
    """Global l2 norm (f32) of a tensor or a tree of tensors."""
    return torch.sqrt(tree_dot(tree, tree))


# the alias of common framework naming
global_norm = tree_norm


def tree_size(a) -> int:
    """Total number of scalar coordinates."""
    return int(sum(math.prod(leaf.shape) for leaf in tree_leaves(a)))
