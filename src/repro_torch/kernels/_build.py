"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so

at first use, from the sources of this checkout only.  ``<hash>`` covers
the source, the headers and the flags, so an edited source is rebuilt.
``--fmad=false`` keeps the kernels' multiply-adds rounded as the plain
PyTorch versions round them.  ``-Xptxas -v`` writes each kernel's
registers, shared memory and spills into ``<name>-<hash>.log`` beside the
library.

A failed build raises :class:`KernelError`, and so does a refused
launch: every C entry point returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.  Nothing falls back to a plain
version, and callers that degrade on other errors (the streaming server)
let a :class:`KernelError` through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "BUILD_DIR", "KernelError", "cuda_available",
           "build_all", "load", "check", "stream_ptr"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/repro_torch: src/repro_torch/kernels/_build.py is 4 levels down
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("row_norms", "clip_aggregate", "geometric_median", "krum",
           "centered_clip", "clipped_diff")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# the C signature of each library's entry points: (name, restype, argtypes)
_SIGNATURES = {
    "row_norms": (
        ("row_ssq_chunk", _I, ()),
        ("row_ssq_launch", _I, (_VP, _VP, _I, _I, ctypes.c_longlong, _I, _VP)),
    ),
    "clip_aggregate": (
        ("clip_bucket_select_launch", _I,
         (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, ctypes.c_longlong, _I, _I,
          ctypes.c_float, _I, _VP)),
        ("bucketed_cm_launch", _I,
         (_VP, _VP, _VP, _VP, _I, _I, _I, _LL, _I, _I, _I, _VP)),
    ),
    "geometric_median": (
        ("gm_smem_optin", _I, ()),
        ("gm_resident_launch", _I,
         (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _LL, _I, _I, _F, _LL, _VP)),
        ("diff_row_ssq_chunk", _I, ()),
        ("diff_row_ssq_launch", _I, (_VP, _VP, _VP, _VP, _I, _I, _LL, _I, _VP)),
        ("bucket_means_launch", _I,
         (_VP, _VP, _VP, _VP, _VP, _I, _I, _LL, _I, _I, _VP)),
        ("gm_update_launch", _I, (_VP, _VP, _VP, _VP, _VP, _I, _I, _LL, _VP)),
    ),
    "krum": (
        ("krum_gram_launch", _I,
         (_VP, _VP, _VP, _VP, _I, _I, _LL, _I, _I, _VP)),
        ("weighted_row_sum_launch", _I, (_VP, _VP, _VP, _I, _I, _LL, _VP)),
        ("select_row_launch", _I, (_VP, _VP, _VP, _VP, _I, _I, _LL, _VP)),
    ),
    "centered_clip": (
        ("cclip_smem_optin", _I, ()),
        ("cclip_resident_launch", _I,
         (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _LL, _I, _I, _F, _LL, _VP)),
        ("cclip_update_launch", _I,
         (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _LL, _VP)),
    ),
    "clipped_diff": (
        ("clipped_diff_blocks", _I, (_LL,)),
        ("clipped_diff_ssq_launch", _I,
         (_VP, _VP, _VP, _F, _VP, _VP, _I, _I, _LL, _VP)),
        ("clipped_diff_scale_launch", _I, (_VP, _VP, _VP, _I, _LL, _VP)),
    ),
}

_LIBS: dict = {}


class KernelError(RuntimeError):
    """A kernel did not build, load or launch."""


@functools.cache
def cuda_available() -> bool:
    """Memoized CUDA probe: whether this process has a usable card."""
    return torch.cuda.is_available()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from src/repro_torch/kernels/csrc at first use"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, target, temp, log) or
    None when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    # the output to the log file, not a pipe: nvcc never waits for a
    # reader while the caller does other work (``start_all``)
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return proc, target, tmp, log


def _finish_build(name: str, job) -> None:
    proc, target, tmp, log = job
    proc.wait()
    out = log.read_text()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build_all(names=SOURCES) -> float:
    """Compile every source that is not built yet, one nvcc per source,
    all started together.  Returns the wall seconds it took."""
    return finish_all(start_all(names))


def start_all(names=SOURCES):
    """Start one nvcc for every source that is not built yet, all
    together, and return at once: the caller may run work that needs no
    kernel meanwhile, then waits in :func:`finish_all` (given what this
    returns)."""
    t0, wall0 = time.perf_counter(), time.time()
    return t0, {name: _start_build(name) for name in names}, wall0


def finish_all(started, seconds=None) -> float:
    """Wait for the builds :func:`start_all` started; raises if one
    failed, after every nvcc has ended.  Returns the wall seconds since
    they started; with ``seconds`` (a dict), each source's nvcc seconds
    go into it by name: until its library (or, failed, its log) was last
    written, so that a source that ended before this call is timed too."""
    t0, jobs, wall0 = started
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        job[0].wait()
        if seconds is not None:
            done = job[2] if job[2].exists() else job[3]
            seconds[name] = done.stat().st_mtime - wall0
        try:
            _finish_build(name, job)
        except KernelError as e:  # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise KernelError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill lines) of the built library."""
    return _lib_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        try:
            lib = ctypes.CDLL(str(_lib_path(name)))
        except OSError as e:
            raise KernelError(f"cannot load csrc/{name}.cu's library: {e}") \
                from e
        for fn, restype, argtypes in _SIGNATURES[name]:
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = list(argtypes)
        err = lib.repro_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, what: str, rc: int) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise KernelError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_ptr() -> int:
    """The raw handle of PyTorch's current CUDA stream."""
    return torch.cuda.current_stream().cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' input-type code: 0 = f32, 1 = bf16."""
    return {torch.float32: 0, torch.bfloat16: 1}[t.dtype]
