"""Build and load the hand-written CUDA kernels.

Each source in ``iris_lama_tpu_torch/csrc/`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` (H100) into its own shared library
under ``build/torch_kernels/`` at the repository root, then loaded with
``ctypes``. The library name carries a hash of the source, the headers it
includes (``#include "..."``) and the flags, so an edited source or header
is rebuilt and a stale library is never loaded. All
missing libraries are compiled together, one ``nvcc`` process per source.

Nothing is built when this module is imported: the first launch of a
kernel builds what is missing (or call :func:`build_all` up front).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# flags of one source on top of NVCC_FLAGS: the Gauss-Newton kernels and
# the PF's motion step keep every float operation separately rounded, as
# their plain PyTorch versions do
_NO_FMA = ("-fmad=false",)
SOURCE_FLAGS = {"gn_solve": _NO_FMA, "match_eval": _NO_FMA,
                "motion": _NO_FMA}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C signature of every exported launcher: (argtypes); all return int
# (a cudaError_t, 0 = success)
SIGNATURES = {
    "deposit": {"deposit_counts": (_P, _P, _L, _I, _I, _I, _P, _P),
                "deposit_pair": (_P, _P, _L, _P, _P, _L, _I, _I, _I, _P, _P),
                "scatter_add_2d": (_P, _P, _P, _L, _I, _I, _I, _P, _P),
                "scatter_add_sorted": (_P, _L, _I, _I, _I, _P, _P)},
    "select4": {"select4_sq": (_P, _I, _I, _I, _P, _L, _P, _L, _I, _P, _P)},
    "edt": {"edt2d": (_P, _I, _I, _I, _I, _I, _P, _P, _P)},
    "gn_solve": {"gn_solve_batched": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                                      _L, _F, _F, _F, _F, _I, _F, _F, _I, _I,
                                      _I, _I, _P, _P)},
    "match_eval": {"gn_eval_sq": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _I, _F, _F, _F, _F, _I, _P, _P)},
    "motion": {"motion_apply": (_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F,
                                _F, _P, _P)},
    # an empty kernel: the launch floor (timed beside the kernels)
    "floor": {"launch_floor": (_I, _I, _P),
              "memset_floor": (_P, _L, _I, _I, _P),
              "launch_floor_cooperative": (_I, _I, _I, _P)},
}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "GPU machine (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: list) -> list:
    """``path`` and the csrc headers it includes with quotes, recursively,
    each once."""
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(CSRC / inc.decode(), seen)
    return seen


def _lib_path(name: str, extra: tuple) -> Path:
    h = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        h.update(path.read_bytes())
    h.update(" ".join(_flags(name) + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None, verbose: bool = False) -> dict:
    """Compile every missing kernel library, all ``nvcc`` runs at once.

    Returns {name: {"seconds": s, "log": compiler output}} for the
    libraries built by this call (``verbose`` adds ``-Xptxas=-v``, which
    reports registers, shared memory and spills per kernel). Raises
    RuntimeError with the compiler output if any build fails.
    """
    names = tuple(SIGNATURES) if names is None else tuple(names)
    extra = ("-Xptxas=-v",) if verbose else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _lib_path(name, ())
        if out.exists() and not verbose:
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    built, failed = {}, {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed[name] = log
            continue
        os.replace(tmp, out)   # atomic: concurrent builders never see half
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{log}" for n, log in failed.items()))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name, ())
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")


def stream_handle(device) -> int:
    """The raw handle of torch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (None:
    any) and ``ndim`` dims on ``device`` — what every launcher takes,
    unless it reads an operand through its strides
    (:func:`require_strided`)."""
    require_strided(t, name, dtype, ndim, device)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def sq_code(t, name: str) -> int:
    """The element-type code (csrc/gn_common.cuh: SqType) of a
    squared-distance grid ``t``: every dtype ``DistanceConfig.sq_dtype``
    returns has a kernel instantiation; any other raises TypeError."""
    import torch
    codes = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3}
    if t.dtype not in codes:
        raise TypeError(f"{name}: expected int8, uint8, int16 or int32, "
                        f"got {t.dtype}")
    return codes[t.dtype]


def require_strided(t, name: str, dtype, ndim: int, device) -> tuple:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` (None: any) and
    ``ndim`` dims on ``device``, in any layout; return its element strides,
    for a launcher that reads the operand through them."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    return t.stride()
