"""Logical-axis sharding rules, the counterpart of
``repro.sharding.constraints``.

Model code annotates activations with *logical* axis names; the mapping to
physical mesh axes lives here.  The port has no ambient mesh
(``launch.mesh.set_mesh`` is a no-op and placement is explicit in
``api/mesh_exec.py``), so ``maybe_constrain`` returns its input; the
rules themselves (``logical_to_spec``, ``axis_size``) resolve over any
mesh's axis names and sizes, and the trainer uses them to place a leaf.

The tensor-parallel split is explicit too: :class:`model_axis` is a
context that carries the "model" group, this rank's coordinate on it, its
size and the pieces this rank holds (a :class:`ModelAxis`).  The trainer
enters it around a worker's forward and backward pass;
``models.model.apply_train`` reads it once (:func:`current_model_axis`)
and hands it down, so that a layer recomputed under activation
checkpointing (in the backward pass, maybe on another thread) splits as
its forward pass did.  With no context, or an axis of size 1 that
carries no "data" axis, the models run whole, exactly as before.  The
axis may also carry the axis that the held pieces are split over besides
Megatron's (a :class:`DataAxis`): "data" under fsdp_tp, and under zero3,
whose pass runs whole (``ModelAxis.held`` None: Megatron's split off),
"model" itself; each layer's leaves come whole over it just before use
(``models.tp.gather_from_data``).

Logical names:
  "data"   -> batch-like dims      -> ("pod","data") if pod axis else "data"
  "model"  -> TP dims              -> "model"
  "heads"  -> attention head dims  -> "model" when divisible, else replicated
  "kv"     -> kv head dims         -> "model" when divisible, else replicated
  "expert" -> MoE expert dim       -> "model"
  None     -> replicated

A mesh here is a ``torch.distributed`` ``DeviceMesh``, anything with
``axis_names`` and a ``shape`` mapping name -> size (JAX's meshes), or an
:class:`AbstractMesh`, which gives only names and sizes and starts no
rank.
"""
from __future__ import annotations

import contextvars
import dataclasses
from typing import Optional

from repro_torch.launch.mesh import P

__all__ = [
    "AbstractMesh",
    "ModelAxis",
    "DataAxis",
    "model_axis",
    "current_model_axis",
    "maybe_constrain",
    "logical_to_spec",
    "axis_size",
    "suspend_data_axis",
    "override_data_axes",
]

# When the trainer maps the model over the worker dim, inner "data"
# annotations must not also claim the axes the workers sit on:
# suspend_data_axis(axes) removes exactly those axes from "data"
# resolution inside its block.  override_data_axes routes "data" onto
# other axes (zero3: batch dims shard over "model").  Both are context
# variables, so a block's setting ends with it and stays in its thread.
_SUSPENDED = contextvars.ContextVar("suspended_data_axes",
                                    default=frozenset())
_DATA_OVERRIDE = contextvars.ContextVar("data_axes_override", default=None)
_MODEL_AXIS = contextvars.ContextVar("model_axis", default=None)


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The axis that a rank's held pieces are split over besides
    Megatron's: "data" under fsdp_tp, "model" under zero3 (whose pass is
    not split over "model" otherwise).  ``group`` (the ranks that differ
    only along the axis), this rank's coordinate ``rank``, its ``size``;
    ``held``, the params tree's ``P`` of the held specs' entries on the
    axis (the leaves gathered over it before use); ``worker``, whether it
    is a worker axis (each of its ranks another worker: fsdp_tp's "data"
    with "data" workers); ``rows``, whether the worker's batch rows are
    split over it (a pass's choice: not a worker axis and its size
    dividing the rows); ``sinks``, where it is a worker axis, the tree of
    buffers (whole over the axis) into which the gradient of each
    gathered leaf is written."""

    group: object
    rank: int
    size: int
    held: object = dataclasses.field(compare=False)
    worker: bool = True
    rows: bool = False
    sinks: object = dataclasses.field(default=None, compare=False)

    @property
    def grad(self) -> str:
        """What the gather's backward does with the gradient of a
        gathered leaf: "keep" (a worker axis: the worker's gradient, whole
        over "data", written to its sink), "reduce_scatter" (the rows
        split: the ranks' partial gradients summed, this rank's piece
        kept) or "narrow" (every rank has every row: this rank's piece)."""
        if self.worker:
            return "keep"
        return "reduce_scatter" if self.rows else "narrow"


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" axis a forward and backward pass is split over:
    ``group`` (a ``torch.distributed`` process group of the ranks that
    differ only along "model", in coordinate order), this rank's
    coordinate ``rank`` on it, its ``size``, and ``held``: the params
    tree's ``P`` of the "model" pieces (``sharding.rules.held_specs``),
    from which the models read which leaves are split, or None where
    Megatron's split is off (zero3; a "model" axis of one rank); ``data``:
    the :class:`DataAxis` of the pieces held besides Megatron's (fsdp_tp's
    "data", zero3's "model"), or None."""

    group: object
    rank: int
    size: int
    held: object = dataclasses.field(compare=False)
    data: Optional[DataAxis] = None

    @property
    def megatron(self) -> Optional["ModelAxis"]:
        """This axis where Megatron's split is on, else None: what the
        models take as ``tp``."""
        return self if self.held is not None and self.size > 1 else None

    def rows_axis(self) -> Optional[DataAxis]:
        """The axis the worker's rows are split over in this pass, or
        None: where the sums over rows (the loss's count, the MoE
        routing's means and slots) must add up the axis's ranks."""
        return self.data if self.data is not None and self.data.rows \
            else None


class model_axis:
    """Split the models' forward and backward passes over ``axis`` (a
    :class:`ModelAxis`, or None: whole) inside the block."""

    def __init__(self, axis: Optional[ModelAxis]):
        self._axis = axis

    def __enter__(self):
        self._token = _MODEL_AXIS.set(self._axis)
        return self._axis

    def __exit__(self, *exc):
        _MODEL_AXIS.reset(self._token)
        return False


def current_model_axis() -> Optional[ModelAxis]:
    """The :class:`ModelAxis` of the enclosing :class:`model_axis` block,
    or None when there is none, or its size is 1 and it carries no
    :class:`DataAxis` (nothing is split)."""
    axis = _MODEL_AXIS.get()
    if axis is None or (axis.size <= 1 and axis.data is None):
        return None
    return axis


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks behind them:
    ``AbstractMesh((2, 16, 16), ("pod", "data", "model"))``."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


class override_data_axes:
    """Route logical "data" onto different physical axes (zero3: batch dims
    shard over "model" because params hold no TP there)."""

    def __init__(self, axes):
        self._axes = tuple(axes)

    def __enter__(self):
        self._token = _DATA_OVERRIDE.set(self._axes)
        return self

    def __exit__(self, *exc):
        _DATA_OVERRIDE.reset(self._token)
        return False


class suspend_data_axis:
    def __init__(self, axes=("pod", "data")):
        self._axes = frozenset(axes)

    def __enter__(self):
        self._token = _SUSPENDED.set(_SUSPENDED.get() | self._axes)
        return self

    def __exit__(self, *exc):
        _SUSPENDED.reset(self._token)
        return False


def _sizes(mesh) -> dict:
    """Axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a torch DeviceMesh
        return {a: mesh.size(i) for i, a in enumerate(names)}
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    return _sizes(mesh).get(name, 1)


def _resolve(sizes: dict, logical: Optional[str], dim_size: int):
    if logical is None:
        return None
    if logical == "data":
        override = _DATA_OVERRIDE.get()
        pool = override if override is not None else ("pod", "data")
        suspended = _SUSPENDED.get()
        axes = tuple(a for a in pool if a in sizes and a not in suspended)
        if not axes:
            return None
        total = 1
        for a in axes:
            total *= sizes[a]
        if dim_size % total != 0:
            return None
        return axes if len(axes) > 1 else axes[0]
    if logical in ("model", "expert", "heads", "kv"):
        # indivisible head counts stay replicated
        if "model" not in sizes or dim_size % sizes["model"]:
            return None
        return "model"
    raise ValueError(f"unknown logical axis {logical!r}")


def logical_to_spec(mesh, logical_axes, shape) -> P:
    """Resolve logical axes; earlier dims win on physical-axis conflicts
    (zero3 routes "data" onto "model", so a later "model" dim replicates)."""
    sizes = _sizes(mesh)
    used: set = set()
    out = []
    for ax, s in zip(logical_axes, shape):
        r = _resolve(sizes, ax, s)
        flat = (r,) if isinstance(r, str) else tuple(r or ())
        if any(a in used for a in flat):
            r = None
            flat = ()
        used.update(flat)
        out.append(r)
    return P(*out)


def maybe_constrain(x, *logical_axes):
    """``x`` itself: the port has no ambient mesh to constrain against
    (placement is explicit in ``api/mesh_exec.py``)."""
    return x
