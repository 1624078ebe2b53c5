"""Tree checkpointing on top of ``np.savez``, the counterpart of
``repro.checkpoint``, in the same on-disk format: each package reads the
other's files.

Layout: ``<dir>/step_<k>.npz`` holds the flattened leaves, keyed by their
path strings, and ``<dir>/step_<k>.json`` is the manifest, which marks
bf16 leaves (npz has no bfloat16; they are stored as their uint16 bits).
A tree is nested dicts (keys in sorted order), NamedTuples, lists and
tuples; a leaf is a numpy array or scalar, a torch tensor or a Python
number; None holds no leaf.  A path string is the reference's:
``['name']`` a dict key, ``.name`` a NamedTuple field, ``[i]`` a sequence
index, joined by ``%%`` (``"['extra']%%['cursor']"``, ``".a%%['w']"``).

Restore takes a template tree, whose structure, dtypes and shapes the
result takes: numpy template leaves come back as numpy arrays of their
exact dtype (int64 stays int64), torch template leaves as tensors on the
template's device and dtype.

Crash safety: both files of a step land through a temp file, fsync and
``os.replace``, the manifest first and the ``.npz`` last, so the moment
``step_<k>.npz`` exists the step is complete.  ``latest_step`` checks the
candidates newest first and skips any that does not read, so a writer
killed mid-save never poisons the reader's resume point.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "verify_step", "has_leaf"]

_SEP = "%%"


def _piece(key) -> str:
    """One step of a path: ``str()`` of JAX's ``DictKey`` (``['name']``)
    or ``SequenceKey`` (``[0]``)."""
    return f"[{key!r}]"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> list:
    """(path piece, child) pairs of a node in JAX's flatten order: dict
    keys sorted, NamedTuple fields as ``.name`` (JAX's ``GetAttrKey``),
    sequence items as ``[i]``."""
    if isinstance(tree, dict):
        return [(_piece(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return [(_piece(i), v) for i, v in enumerate(tree)]


def _flatten_with_paths(tree, prefix=()) -> dict:
    """Path string -> leaf, dict keys in sorted order (JAX's order)."""
    if tree is None:
        return {}
    if not isinstance(tree, (dict, list, tuple)):
        return {_SEP.join(prefix): tree}
    out = {}
    for piece, child in _children(tree):
        out.update(_flatten_with_paths(child, prefix + (piece,)))
    return out


def _rebuild(template, leaves: dict, prefix=()):
    """``template``'s structure with each leaf replaced from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, prefix + (_piece(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        values = [_rebuild(v, leaves, prefix + (piece,))
                  for piece, v in _children(template)]
        if _is_namedtuple(template):
            return type(template)(*values)
        return type(template)(values)
    return leaves[_SEP.join(prefix)]


def _to_numpy(leaf) -> tuple[np.ndarray, bool]:
    """(host array, is_bf16): a bf16 leaf comes out as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array, as JAX gives
        return arr.view(np.uint16), True
    return arr, False


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) as the float32 values they denote."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _replace_atomic(tmp_path: str, final_path: str, write_fn) -> None:
    """Write via ``write_fn(file_object)`` to ``tmp_path``, fsync, then
    ``os.replace`` into place: a SIGKILL at any instruction leaves
    ``final_path`` either absent or complete, never truncated."""
    with open(tmp_path, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_path, final_path)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` as step ``step`` of ``ckpt_dir``; returns the npz
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, meta = {}, {}
    for k, v in _flatten_with_paths(tree).items():
        arr, bf16 = _to_numpy(v)
        if bf16:
            meta[k] = "bfloat16"
        arrays[k] = arr
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    meta_path = os.path.join(ckpt_dir, f"step_{step}.json")
    # manifest first, npz last: the npz is the publication marker
    _replace_atomic(meta_path + ".tmp", meta_path,
                    lambda f: f.write(json.dumps(meta).encode()))
    _replace_atomic(path + ".tmp.npz", path,
                    lambda f: np.savez(f, **arrays))
    return path


def verify_step(ckpt_dir: str, step: int) -> bool:
    """True iff step ``step`` is complete and readable (the manifest
    parses, the npz archive opens)."""
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    meta_path = os.path.join(ckpt_dir, f"step_{step}.json")
    try:
        with open(meta_path) as f:
            json.load(f)
        with np.load(path) as data:
            data.files  # forces the zip central directory read
        return True
    except Exception:  # noqa: BLE001 — any unreadability means incomplete
        return False


def _restore_leaf(arr: np.ndarray, bf16: bool, tmpl):
    if isinstance(tmpl, torch.Tensor):
        if bf16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(dtype=tmpl.dtype).reshape(tmpl.shape).to(tmpl.device)
    tmpl_dtype = np.asarray(tmpl).dtype
    if bf16:
        arr = arr.view(tmpl_dtype) if tmpl_dtype.name == "bfloat16" \
            else _bf16_bits_to_f32(arr)
    # numpy (and Python number) template leaves stay numpy, at their
    # exact dtype: no narrowing of int64 or float64 host state
    return np.asarray(arr).astype(tmpl_dtype).reshape(np.shape(tmpl))


def restore(ckpt_dir: str, step: int, template: Any) -> Any:
    """Step ``step`` of ``ckpt_dir`` in the structure of ``template``."""
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    with open(os.path.join(ckpt_dir, f"step_{step}.json")) as f:
        meta = json.load(f)
    with np.load(path) as data:
        leaves = {k: _restore_leaf(data[k], meta.get(k) == "bfloat16", tmpl)
                  for k, tmpl in _flatten_with_paths(template).items()}
    return _rebuild(template, leaves)


def has_leaf(ckpt_dir: str, step: int, path: str) -> bool:
    """Whether step ``step`` of ``ckpt_dir`` holds a leaf at the path
    string ``path`` (a reader can then leave a newer key out of its
    template for an older file)."""
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as data:
        return path in data.files


def latest_step(ckpt_dir: str, *, verify: bool = True) -> Optional[int]:
    """Newest complete step in ``ckpt_dir`` (None when there is none).
    With ``verify`` (the default) damaged or truncated steps are
    skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        (int(m.group(1)) for f in os.listdir(ckpt_dir)
         if (m := re.fullmatch(r"step_(\d+)\.npz", f))),
        reverse=True)
    for step in steps:
        if not verify or verify_step(ckpt_dir, step):
            return step
    return None
