"""Device meshes on ``torch.distributed``, the counterpart of
``repro.launch.mesh``.

Single pod:  (data=16, model=16)          -- 256 ranks
Multi-pod:   (pod=2, data=16, model=16)   -- 512 ranks

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, whose world size must equal the mesh's size: the caller
starts the group (``init_process_group``, or :func:`spawn` for ranks on
one host), then builds the mesh.  Rank r sits at the row-major
coordinates of r in the mesh shape, and ``mesh.get_group(axis)`` is the
group of the ranks that differ only along ``axis``, ordered by their
coordinate on it.

``P`` is the port's PartitionSpec: one entry per dimension of an array,
each a mesh axis name, a tuple of names (the dimension split over those
axes, the first one major) or None (not split).
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import tempfile
import time
import traceback

import torch.distributed as dist

__all__ = [
    "P",
    "make_production_mesh",
    "make_debug_mesh",
    "set_mesh",
    "worker_axes",
    "num_workers",
    "axis_size",
    "model_group",
    "fake_world",
    "spawn",
]


class P(tuple):
    """PartitionSpec: ``P(None, "model")`` splits an array's second
    dimension over the mesh axis "model" and keeps its first whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _device_type() -> str:
    """"cuda" under NCCL, else "cpu": gloo's ranks may share one card, and
    the mesh's device type places no tensor (every collective here takes
    the tensors it is given, on the card or not; the fake world's, meta
    tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _make_mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a started process group of "
            f"{_size(shape)} ranks (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != _size(shape):
        raise ValueError(
            f"a mesh of shape {shape} over {names} needs a world size of "
            f"{_size(shape)}; the process group has {world} ranks")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or, multi-pod, (2, 16, 16) mesh.  Raises unless the
    process group has exactly that many ranks: it never builds a smaller
    mesh in silence."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """A small (data, model) or (pod, data, model) mesh, for tests and
    for one card."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"))
    return _make_mesh((data, model), ("data", "model"))


def set_mesh(mesh):
    """A no-op context manager over ``mesh``.  JAX keeps an ambient mesh;
    here every call that runs on a mesh takes it as an argument
    (``ServerPlan.build(mesh)``), so there is nothing to activate."""
    return contextlib.nullcontext(mesh)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def model_group(mesh):
    """The process group of this rank's "model" axis (the ranks that
    differ only along it), or None on a mesh without one."""
    if "model" not in mesh.mesh_dim_names:
        return None
    return mesh.get_group("model")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks in which this
    process is rank 0 and no other rank exists: torch's "fake" backend
    (``torch.testing._internal.distributed.fake_pg``), whose collectives
    return at once and move nothing.  On "meta" tensors it traces one
    rank's step of a mesh of any size in one process (the dry run)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def worker_axes(mesh) -> tuple:
    """Mesh axes that enumerate Byz-VR-MARINA-PP workers/clients."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def num_workers(mesh) -> int:
    n = 1
    for a in worker_axes(mesh):
        n *= axis_size(mesh, a)
    return n


# ---------------------------------------------------------------------------
# ranks on one host
# ---------------------------------------------------------------------------

# a collective that waits longer than this on a lost rank raises
COLLECTIVE_TIMEOUT_S = 120.0


def _rank_main(rank, nprocs, init, fn, args, results):
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, None, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn, nprocs: int, args=(), *, timeout: float = 600.0):
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes joined in one
    gloo process group (a ``file://`` rendezvous in a temporary
    directory, so concurrent jobs never share a port) and return the
    ranks' return values in rank order.  Every rank keeps the default
    CUDA device, so on a host with a card all ranks share cuda:0.  ``fn`` (a module-level function)
    and its results must pickle.  Raises, after stopping every process,
    when a rank fails or the job outlives ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    outs, err = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nprocs, init, fn, args, results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(outs) < nprocs and err is None:
                if not results.empty():
                    rank, out, tb = results.get()
                    if tb is None:
                        outs[rank] = out
                    else:
                        err = f"rank {rank} failed:\n{tb}"
                elif time.monotonic() > deadline:
                    err = f"{nprocs} ranks did not finish in {timeout} s"
                elif any(p.exitcode not in (None, 0) for p in procs):
                    err = ("a rank died without a report (exit codes "
                           f"{[p.exitcode for p in procs]})")
                else:
                    time.sleep(0.02)
        finally:
            for p in procs:
                p.join(timeout=10 if err is None else 0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if err is not None:
        raise RuntimeError(f"spawn: {err}")
    return [outs[r] for r in range(nprocs)]
