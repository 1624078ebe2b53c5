"""Parameter / cache / batch partition rules for the production mesh, the
counterpart of ``repro.sharding.rules``.

Modes:
  "tp"       params replicated over data, tensor-parallel over "model"
  "fsdp_tp"  additionally split each kernel's remaining large dim over
             "data" (deepseek-v3-671b, arctic-480b, llama-3.2-vision-90b)
  "zero3"    no tensor parallelism: the "fsdp" slot of a kernel takes the
             model axis, the tensor-parallel slots replicate

Rules key off the *leaf name*: the last string key on the leaf's path
(a dict key or a NamedTuple field; tuple positions have none).  Stacked
leading dims (the period axis) are never split, and a dim that the axis
size does not divide is replicated.

A mesh is a ``torch.distributed`` ``DeviceMesh`` or the
:class:`~repro_torch.sharding.constraints.AbstractMesh` of
``constraints`` (names and sizes, no ranks), so that the specs of the
(16, 16) and (2, 16, 16) meshes can be built anywhere.  Specs are the
port's ``P`` (``repro_torch.launch.mesh``).

The port has no ``NamedSharding``: placement is explicit, every rank
holds plain local tensors.  :func:`state_sharding` therefore gives, for
each leaf, a :class:`LocalShard`: the rule that cuts this rank's piece
out of a whole tensor (the trainer cuts its worker's whole gradient with
it before the mesh aggregation, ``repro_torch.launch.train``).

Which part of that the model compute follows is :func:`model_split`:
"tp" for every family under "tp" and fsdp_tp (the token decoders: GQA,
MHA or MLA attention, the Mamba-2 mixer, or both interleaved; the SwiGLU
MLP, the MoE layer or none; the cross-attention decoder, with vision
tokens as the cross-attention's keys and values; the audio encoder on
frame inputs, its ``frontend`` column-split), whose forward and backward
passes split over "model" as ``models.tp`` writes out; "zero3" under
zero3, whose pass runs whole on the rank's rows (split over "model"
where it divides them), each layer's leaves gathered over "model" just
before use.  Either way a rank holds only its pieces (:func:`held_specs`,
the reference's ``state_specs``: its ``param_specs`` pieces; under
fsdp_tp its "data" x "model" pieces, each layer's leaves gathered over
"data" just before use, as the reference's GSPMD gathers them inside its
layer scan).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from ..core.tree_utils import tree_flatten, tree_unflatten
from ..launch.mesh import P
from .constraints import _sizes

__all__ = [
    "param_specs",
    "batch_specs",
    "cache_specs",
    "state_sharding",
    "needs_fsdp",
    "LocalShard",
    "model_split",
    "held_specs",
    "only_axis",
    "local_shape",
]

# (core_rank, spec over the trailing core dims); "col" = output-dim split,
# "row" = input-dim split (Megatron convention)
_RULES: Dict[str, tuple] = {
    # embeddings / heads
    "embed": (2, ("model", "fsdp")),
    "unembed": (2, ("fsdp", "model")),
    "frontend": (2, (None, "model")),
    # attention (GQA + MLA + cross)
    "wq": (2, ("fsdp", "model")),
    "wk": (2, ("fsdp", "model")),
    "wv": (2, ("fsdp", "model")),
    "wo": (2, ("model", "fsdp")),
    "wq_a": (2, ("fsdp", "model")),
    "wq_b": (2, ("fsdp", "model")),
    "wkv_a": (2, ("fsdp", "model")),
    "wkv_b": (2, ("fsdp", "model")),
    "proj": (2, ("fsdp", "model")),
    # dense mlp
    "w_gate": (2, ("fsdp", "model")),
    "w_up": (2, ("fsdp", "model")),
    "w_down": (2, ("model", "fsdp")),
    # moe (expert-parallel over "model"; fsdp over the d_model dim)
    "router": (2, (None, None)),
    # ssm
    "in_proj": (2, ("fsdp", "model")),
    "out_proj": (2, ("model", "fsdp")),
    "conv_w": (2, (None, "model")),
}

_MOE_RULES: Dict[str, tuple] = {
    "w_gate": (3, ("model", "fsdp", None)),
    "w_up": (3, ("model", "fsdp", None)),
    "w_down": (3, ("model", None, "fsdp")),
}

# parameter-count threshold above which fsdp_tp is selected automatically
_FSDP_THRESHOLD = 60e9


def model_split(cfg, mode: str = "tp") -> str:
    """How a worker's forward and backward pass runs over "model": "tp"
    (Megatron's column and row split, ``models.tp``) under "tp" and
    fsdp_tp, for every family ``models`` builds (attention, GQA or MLA,
    Mamba-2 and the hybrids of both, cross-attention to vision tokens;
    dense, MoE or no MLP, a dense prefix and an MTP head included; token
    or frame inputs); "zero3" under zero3, which splits no model compute:
    the pass runs whole on the rank's share of the worker's rows, each
    layer's leaves gathered over "model" (``models.tp.gather_from_data``
    on the "model" group)."""
    del cfg  # every family splits
    return "zero3" if mode == "zero3" else "tp"


def needs_fsdp(cfg, param_count: Optional[int] = None) -> bool:
    if param_count is None:
        from ..models.model import param_count as pc

        param_count = pc(cfg)
    return param_count > _FSDP_THRESHOLD


def _divides(sizes: dict, axis: str, dim: int) -> bool:
    return axis in sizes and dim % sizes[axis] == 0


def _resolve_token(sizes: dict, token, dim: int, mode: str):
    if token is None:
        return None
    if mode == "zero3":
        # no TP: the "fsdp" slot takes the model axis, TP slots replicate
        if token == "fsdp" and _divides(sizes, "model", dim):
            return "model"
        return None
    if token == "model":
        return "model" if _divides(sizes, "model", dim) else None
    if token == "fsdp" and mode == "fsdp_tp" and _divides(sizes, "data", dim):
        return "data"
    return None


def _leaf_spec(sizes: dict, name: str, shape, mode: str) -> P:
    rank = len(shape)
    rule = None
    if name in _MOE_RULES and rank >= _MOE_RULES[name][0]:
        rule = _MOE_RULES[name]
    if rule is None:
        rule = _RULES.get(name)
    if rule is None or rank < rule[0]:
        return P()  # norms, biases, gates, scalars: replicate
    cr, tokens = rule
    lead = rank - cr
    return P(*([None] * lead), *(
        _resolve_token(sizes, t, shape[lead + i], mode)
        for i, t in enumerate(tokens)))


def _map_with_name(fn, node, name=""):
    """``fn(name, leaf)`` over a dict / tuple / list / NamedTuple tree, in
    its structure; ``name`` is the last string key on the leaf's path.
    None stays None (a node without leaves, as in JAX)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map_with_name(fn, v, k if isinstance(k, str) else name)
                for k, v in node.items()}
    if hasattr(node, "_fields"):  # a NamedTuple: its fields are names
        return type(node)(*(_map_with_name(fn, v, f)
                            for f, v in zip(node._fields, node)))
    if isinstance(node, (tuple, list)):
        return type(node)(_map_with_name(fn, v, name) for v in node)
    return fn(name, node)


def param_specs(mesh, cfg, params_shape, mode: str = "tp"):
    """Tree of ``P`` matching ``params_shape`` (a tree of tensors, meta
    tensors included, or of anything with a ``shape``)."""
    sizes = _sizes(mesh)
    return _map_with_name(
        lambda name, leaf: _leaf_spec(sizes, name, tuple(leaf.shape), mode),
        params_shape)


def only_axis(spec, axes) -> P:
    """``spec`` with only the entries on ``axes`` (a name or a tuple of
    names) kept: an entry that splits over one of them becomes that axis
    (a tuple entry that names two of them, the tuple of those), the
    others None."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)

    def keep(entry):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept = tuple(a for a in names if a in axes)
        return kept if len(kept) > 1 else (kept[0] if kept else None)

    return P(*(keep(e) for e in spec))


def held_specs(mesh, cfg, params_shape, mode: str = "tp"):
    """Tree of ``P``: the piece of each leaf a rank holds, its
    ``param_specs`` piece (the reference's ``state_specs``): under "tp"
    its "model" piece, under fsdp_tp its "data" x "model" piece, under
    zero3 its piece of the "fsdp" slot over "model".  ``params_shape``:
    the whole tree (meta tensors do)."""
    return param_specs(mesh, cfg, params_shape, mode=mode)


def local_shape(mesh, shape, spec) -> tuple:
    """The shape of a rank's piece of a ``shape`` leaf under ``spec``."""
    sizes = _sizes(mesh)
    out = list(shape)
    for j, entry in enumerate(spec):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        out[j] //= math.prod(sizes[a] for a in axes if a is not None)
    return tuple(out)


def batch_specs(mesh, batch_shape, worker_axes=("data",)):
    """Split the leading (batch or worker) dim of every batch leaf."""
    sizes = _sizes(mesh)
    axes = tuple(a for a in worker_axes if a in sizes)
    total = math.prod(sizes[a] for a in axes)

    def spec_for(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        first = ((axes if len(axes) > 1 else axes[0])
                 if total > 1 and shape[0] % total == 0 else None)
        return P(first, *([None] * (len(shape) - 1)))

    return _map_with_name(spec_for, batch_shape)


def _split_if(sizes: dict, axis: str, dim: int):
    return axis if _divides(sizes, axis, dim) else None


def cache_specs(mesh, cfg, cache_shape):
    """Decode-cache specs: the batch dim over "data" when divisible; the
    cache-length dim of attention caches over "model"; SSM states: batch
    over "data", heads over "model"."""
    sizes = _sizes(mesh)

    def spec_for(name, leaf):
        shape = tuple(leaf.shape)
        rank = len(shape)
        # stacked caches carry a leading layer dim: the dims shift
        if name in ("k", "v", "ckv", "krope"):
            lead = rank - (4 if name in ("k", "v") else 3)
            spec = [None] * lead + [
                _split_if(sizes, "data", shape[lead]),
                _split_if(sizes, "model", shape[lead + 1])]
        elif name == "h":  # SSM state (layers, B, H, P, N)
            lead = rank - 4
            spec = [None] * lead + [
                _split_if(sizes, "data", shape[lead]),
                _split_if(sizes, "model", shape[lead + 1])]
        elif name == "conv":  # (layers, B, K-1, C)
            lead = rank - 3
            spec = [None] * lead + [_split_if(sizes, "data", shape[lead])]
        else:
            spec = []
        return P(*spec, *([None] * (rank - len(spec))))

    return _map_with_name(spec_for, cache_shape)


class LocalShard:
    """The rule that cuts this rank's piece of a whole tensor under
    ``spec`` on ``mesh`` (a ``DeviceMesh``): along each dimension that
    ``spec`` splits over axes (a1, a2, ...), the rank takes block
    ``c1 * |a2| + c2 ...`` of equal blocks, ci its coordinate on ai (the
    first axis major, as ``repro_torch.api.mesh_exec`` reads a spec)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __call__(self, whole):
        from ..api.mesh_exec import _local_piece

        return _local_piece(whole, self.spec, self.mesh)

    def __repr__(self):
        return f"LocalShard({self.spec!r})"


def state_sharding(mesh, specs):
    """Tree of ``P`` -> tree of :class:`LocalShard` (this rank's piece of
    each whole leaf)."""
    leaves, treedef = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))
    return tree_unflatten(treedef, [LocalShard(mesh, sp) for sp in leaves])
