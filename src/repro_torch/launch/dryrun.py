"""Dry run of the production meshes on the CPU, the counterpart of
``repro.launch.dryrun``: what one rank of a (16, 16) or (2, 16, 16) mesh
holds, computes and sends, traced without a card.

The reference lowers each step against ``ShapeDtypeStruct``s on 512
faked devices and reads XLA's memory and cost analyses and its HLO.  The
port has no compiler to ask, so it runs the real step function once, as
rank 0 of a process group of the mesh's size on torch's "fake" backend
(``launch.mesh.fake_world``: collectives return at once), on "meta"
tensors (shapes and dtypes, nothing allocated, nothing computed):

  train    ``launch.train.make_train_step`` on the rank's held state
           (``abstract_state(..., mesh)``: its ``param_specs`` pieces,
           ``sharding.rules.held_specs``: under the tensor-parallel split,
           ``model_split``, its "model" pieces, under fsdp_tp its "data" x
           "model" pieces, each layer gathered over "data" in the period
           loop; under zero3 its pieces over "model", each layer gathered
           over "model", the worker's rows split over it) and the global
           batch (with the pods the workers, as under fsdp_tp on the
           multi-pod mesh, the worker's rows split over "data"; its piece
           split over "model" too under zero3, as the reference's
           ``batch_specs``), for one difference round
           (two gradients, the clip and the aggregation: the larger of
           the two rounds);
  prefill  ``launch.serve.make_prefill_step`` and
  decode   ``make_serve_step`` on the mesh, one process each: under "tp"
           and fsdp_tp the split step (``model_split`` "tp") on the
           rank's ``param_specs`` pieces (under fsdp_tp each layer
           gathered over "data" in the period loop) and, for decode, its
           ``cache_specs`` pieces of the cache (``init_cache(...,
           mesh=)``: the attention caches' length and the SSM states'
           heads over "model", the rows over "data" where it divides
           them), the rank's rows of the batch (those of its cache piece:
           split over "data" alone, so both pods of the multi-pod mesh
           run the same rows); under zero3 params whole, the batch and
           cache split per ``batch_specs`` (``model_split`` "none").

It records, under the reference's JSON keys:

  memory.argument_size_in_bytes  the rank's held state (or params, cache)
                                 plus its piece of the batch
  memory.output_size_in_bytes    the new state (or logits, tokens, cache)
  memory.temp_size_in_bytes      the peak of the bytes allocated during
                                 the step, above the arguments (a dispatch
                                 mode that follows each storage the step
                                 creates until it is freed)
  cost.flops                     the formulas of ``torch.utils.flop_counter``
                                 over every op of the step
  collectives                    ``api.mesh_exec.collective_counts()``: the
                                 aggregation's and the split's collectives
                                 (the "data" gathers among the all-gathers,
                                 the reduce-scatters of the split rows'
                                 gradients), recomputed ones included, in
                                 bytes by the reference's conventions
                                 (all-reduce 2x its result, reduce-scatter
                                 x its group: its input)

plus ``model_split``, ``rank``, ``round``, ``trace_s``, ``state_bytes``
(the rank's params, or its train state) and, for decode,
``cache_bytes`` (its pieces of the cache).  The kernel
wrappers take their plain path on "meta" tensors (they launch only on
CUDA tensors), so the aggregation's arithmetic is the plain rule's
(``plain_rule``).  A rule that needs a value (Krum's winner: ``.item()``
fails on "meta") is reported as not traced, with the reason, and the run
goes on.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --mesh 2x2
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron_8b \\
        --shape train_4k --multi-pod both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from ..api import AggregatorSpec, ClipSpec, CompressSpec, ScheduleSpec
from ..api import ServerPlan
from ..configs.registry import get_config, get_smoke_config, list_archs
from ..configs.shapes import (SHAPES, Shape, decode_variant, input_specs,
                              mode_for)
from ..core.tree_utils import tree_flatten, tree_leaves, tree_unflatten
from ..models.model import init_cache, init_params, param_count
from ..sharding.rules import batch_specs, held_specs, local_shape
from ..sharding.rules import model_split, needs_fsdp
from .mesh import P, fake_world, worker_axes
from .serve import make_prefill_step, make_serve_step
from .train import (ByzTrainConfig, TrainTape,
                    abstract_state, make_train_step, resolve_plan, train_key)

__all__ = ["run_one", "mesh_shape", "main"]

# the reference's collective kinds, and the port's op names for them
_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "broadcast": "broadcast", "reduce": "reduce"}


def mesh_shape(multi_pod: bool, override: str = "") -> tuple:
    """(shape, axis names) of the production mesh, or of ``override``
    ("2x2": data x model; "2x2x2": pod x data x model)."""
    if override:
        dims = tuple(int(x) for x in override.split("x"))
    else:
        dims = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return dims, names


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _piece(mesh, tree, specs):
    """This rank's piece of every leaf of ``tree`` under ``specs``, on
    "meta"."""
    leaves, treedef = tree_flatten(tree)
    sps = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return tree_unflatten(treedef, [
        torch.empty(local_shape(mesh, x.shape, sp), dtype=x.dtype,
                    device="meta") for x, sp in zip(leaves, sps)])


class _Tally:
    """A dispatch mode that counts, over every op it sees, the flops of
    ``torch.utils.flop_counter``'s formulas (matmuls, attention,
    convolutions) and the bytes of the storages the ops create that are
    alive at once (each freed when its last tensor goes), keeping the
    peak: one pass, light enough for the SSM's per-chunk loop."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        tally = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                count = flop_registry.get(func._overloadpacket)
                if count is not None:
                    tally.flops += int(count(*args, **kwargs, out_val=out))
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        tally.track(t)
                return out

        self.mode = Mode()
        self.flops = self.live = self.peak = 0
        self.alive = set()

    def track(self, t):
        import weakref

        st = t.untyped_storage()
        key = st._cdata
        if key in self.alive:
            return
        self.alive.add(key)
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self.free, key, st.nbytes())

    def free(self, key, nbytes):
        self.alive.discard(key)
        self.live -= nbytes


def _traced(fn, inputs=()):
    """(output, flops, peak bytes allocated during ``fn``); the storages
    of the tensors of ``inputs`` (a tree) exist before it, so that a view
    of them is not counted as an allocation."""
    tally = _Tally()
    for t in tree_leaves(inputs):
        if isinstance(t, torch.Tensor):
            tally.alive.add(t.untyped_storage()._cdata)
    with tally.mode:
        out = fn()
    return out, tally.flops, tally.peak


def _collectives(counts: dict) -> dict:
    """``collective_counts()`` in the reference's ``parse_collectives``
    form and byte conventions."""
    out = {"bytes": {}, "counts": {}, "routes": {}}
    for op, c in counts.items():
        kind = _KINDS.get(op, op)
        b = c["bytes"] * (2 if op == "all_reduce" else 1)
        out["bytes"][kind] = out["bytes"].get(kind, 0) + b
        out["counts"][kind] = out["counts"].get(kind, 0) + c["calls"]
        out["routes"][kind] = c["route"]
    out["total_bytes"] = sum(out["bytes"].values())
    return out


def _default_train_cfg(cfg, smoke: bool, multi_pod: bool) -> ByzTrainConfig:
    fsdp = not smoke and needs_fsdp(cfg)
    # FSDP-scale archs on the multi-pod mesh: one worker per pod, so that
    # "data" stays free for FSDP (the reference's choice)
    return ByzTrainConfig(shard_mode="fsdp_tp" if fsdp else "tp",
                          worker_axes_override=(("pod",) if fsdp and multi_pod
                                                else ()),
                          n_byz=1)


def _train(cfg, shape, mesh, tc, result):
    from ..api.mesh_exec import collective_counts

    state = abstract_state(cfg, tc, mesh)
    state = state._replace(key=train_key(tc.seed),
                           step=torch.zeros((), dtype=torch.int32))
    batch = input_specs(cfg, shape)
    waxes = tuple(tc.worker_axes_override) or worker_axes(mesh)
    W = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in waxes)
    # zero3 splits each worker's rows over "model" too
    baxes = waxes + (("model",) if tc.shard_mode == "zero3" else ())
    bpiece = _piece(mesh, batch, batch_specs(mesh, batch, baxes))
    # one difference round over every worker
    tape = TrainTape(c=np.array([False]), sampled=np.ones((1, W), bool),
                     order=np.arange(W)[None])
    step = make_train_step(cfg, mesh, tc)
    new, flops, peak = _traced(lambda: step(state, batch, tape),
                               (state, batch))
    held = _nbytes((state.params, state.g, state.key, state.step))
    result["round"] = "difference"
    result["state_bytes"] = held
    result["memory"] = {
        "argument_size_in_bytes": held + _nbytes(bpiece),
        "output_size_in_bytes": _nbytes(tuple(new)),
        "temp_size_in_bytes": peak,
    }
    result["cost"] = {"flops": float(flops)}
    result["collectives"] = _collectives(collective_counts())
    result["plain_rule"] = resolve_plan(tc).aggregate.rule


def _serve(cfg, shape, mesh, mode, tc, result):
    from ..api.mesh_exec import collective_counts

    batch = input_specs(cfg, shape)
    split = tc.shard_mode != "zero3"
    dcfg = cfg if mode == "prefill" else decode_variant(cfg, shape)
    b = batch if mode == "prefill" else batch["batch"]
    params = init_params(0, dcfg, device="meta")
    if split:  # the rank's param_specs pieces, its rows of the batch
        params = _piece(mesh, params, held_specs(mesh, dcfg, params,
                                                 tc.shard_mode))
        rows = _piece(mesh, b, batch_specs(mesh, b, ("data",)))
    else:
        b = rows = _piece(mesh, b, batch_specs(mesh, b, worker_axes(mesh)))
    smesh = mesh if split else None
    cache = None
    if mode == "prefill":
        step = make_prefill_step(dcfg, smesh, tc.shard_mode)

        def run():
            return step(params, b)
    else:
        n = next(iter(rows.values())).shape[0]
        cache = init_cache(dcfg, shape.global_batch if split else n,
                           shape.seq_len, device="meta", mesh=smesh)
        step = make_serve_step(dcfg, smesh, tc.shard_mode)

        def run():
            return step(params, b, cache, shape.seq_len - 1)

    out, flops, peak = _traced(run, (params, b, cache))
    result["model_split"] = "tp" if split else "none"
    result["state_bytes"] = _nbytes(params)
    if cache is not None:
        result["cache_bytes"] = _nbytes(cache)
    result["memory"] = {
        "argument_size_in_bytes": _nbytes((params, rows, cache)),
        "output_size_in_bytes": _nbytes(out),
        "temp_size_in_bytes": peak,
    }
    result["cost"] = {"flops": float(flops)}
    result["collectives"] = _collectives(collective_counts())


def run_one(arch: str, shape_name, *, multi_pod: bool,
            smoke: bool = False, mesh: str = "",
            train_cfg: "ByzTrainConfig | None" = None,
            out_dir: str = "experiments/dryrun", verbose: bool = True,
            no_remat: bool = False, cfg=None) -> dict:
    """Trace ``arch`` x ``shape_name`` as rank 0 of the (multi-pod)
    production mesh or ``mesh`` ("2x2", "2x2x2") and return (and write)
    the JSON record (module docstring).  ``shape_name`` is a name of
    ``SHAPES`` or a ``Shape`` (a cut batch); ``cfg`` overrides the arch's
    config (a cut-down one).  Needs a process with no process group."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..api.mesh_exec import reset_collective_counts

    shape = shape_name if isinstance(shape_name, Shape) else \
        SHAPES[shape_name]
    shape_name = shape.name
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if no_remat:
        cfg = cfg.replace(remat=False)
    mode = mode_for(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "mode": mode, "smoke": smoke}
    if mode is None:
        result["skipped"] = "encoder-only architecture has no decode step"
        return result
    dims, names = mesh_shape(multi_pod, mesh)
    n_chips = math.prod(dims)
    result.update(mesh="x".join(map(str, dims)), n_chips=n_chips, rank=0)
    tc = train_cfg or _default_train_cfg(cfg, smoke, multi_pod)
    plan = resolve_plan(tc)
    result.update(shard_mode=tc.shard_mode,
                  agg_schedule=plan.schedule.placement,
                  params=param_count(cfg),
                  model_split=model_split(cfg, tc.shard_mode))
    t0 = time.time()
    with fake_world(n_chips):
        dmesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        reset_collective_counts()
        try:
            if mode == "train":
                _train(cfg, shape, dmesh, tc, result)
            else:
                _serve(cfg, shape, dmesh, mode, tc, result)
        except (RuntimeError, NotImplementedError) as err:
            if "meta" not in str(err) and "item" not in str(err):
                raise
            result["not_traced"] = (
                f"{type(err).__name__}: {str(err)[:300]} (a value was "
                "needed on meta tensors)")
    result["trace_s"] = round(time.time() - t0, 3)
    if verbose:
        mem = result.get("memory", {})
        print(f"[dryrun] {arch} x {shape_name} mesh={result['mesh']} "
              f"mode={mode} split={result['model_split']} shard="
              f"{tc.shard_mode} agg={plan.schedule.placement}: args "
              f"{mem.get('argument_size_in_bytes', 0):.4e} B, temp "
              f"{mem.get('temp_size_in_bytes', 0):.4e} B, flops "
              f"{result.get('cost', {}).get('flops', 0):.4e}, collectives "
              f"{result.get('collectives', {}).get('total_bytes', 0):.4e} B"
              f" ({result['trace_s']} s)"
              + (f"; NOT TRACED: {result['not_traced']}"
                 if "not_traced" in result else ""), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "multipod" if multi_pod else "pod"
        if plan.schedule.placement != "sharded":
            suffix += f"_{plan.schedule.placement}"
        if tc.shard_mode == "zero3":
            suffix += "_zero3"
        if plan.compress is not None and plan.compress.kind == \
                "rand_fraction":
            suffix += f"_rk{plan.compress.frac}"
        if no_remat:
            suffix += "_noremat"
        if smoke:
            suffix += "_smoke"
        path = os.path.join(out_dir, f"{arch.replace('.', '')}_{shape_name}"
                                     f"_{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        result["artifact"] = path
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="false",
                    choices=["false", "true", "both"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="override mesh, e.g. 2x2 (data x model) or 2x2x2")
    ap.add_argument("--agg-schedule", default="sharded",
                    choices=["sharded", "naive"])
    ap.add_argument("--shard-mode", default="",
                    choices=["", "tp", "fsdp_tp", "zero3"])
    ap.add_argument("--compress-frac", type=float, default=0.0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"false": [False], "true": [True],
            "both": [False, True]}[args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tc = None
                if (args.shard_mode or args.agg_schedule != "sharded"
                        or args.compress_frac):
                    cfg0 = get_smoke_config(arch) if args.smoke \
                        else get_config(arch)
                    sm = args.shard_mode or (
                        "fsdp_tp" if (not args.smoke and needs_fsdp(cfg0))
                        else "tp")
                    # resolve_plan()'s default, with the placement and
                    # compression stages the flags control
                    plan = ServerPlan(
                        aggregate=AggregatorSpec("cm", trim_ratio=0.25,
                                                 byz_bound=1),
                        clip=ClipSpec(alpha=2.0),
                        compress=(CompressSpec(kind="rand_fraction",
                                               frac=args.compress_frac)
                                  if args.compress_frac else None),
                        schedule=ScheduleSpec(placement=args.agg_schedule))
                    tc = ByzTrainConfig(shard_mode=sm, plan=plan, n_byz=1)
                try:
                    run_one(arch, shape, multi_pod=mp, smoke=args.smoke,
                            mesh=args.mesh, train_cfg=tc,
                            out_dir=args.out_dir, no_remat=args.no_remat)
                except Exception as e:  # noqa: BLE001 — report, go on
                    failures.append((arch, shape, mp, repr(e)[:300]))
                    print(f"[dryrun] FAIL {arch} x {shape} mp={mp}: "
                          f"{e!r}"[:500], flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES")
        raise SystemExit(1)
    print("[dryrun] every combination traced")


if __name__ == "__main__":
    main()
