"""Build the CUDA sources of ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, ``build/<name>-<hash>.so`` at the repository root (a
directory git ignores), built for ``sm_90a`` at first use.  The hash
covers the source and the flags, so an edited source never loads a
stale library.  All sources build at once, one nvcc each, started
together.  Nothing is built when a module is imported.  ``register``
adds a source kept outside ``csrc/`` (an earlier design that a script
times beside the current one) to the same build.

Every C entry returns the ``cudaError_t`` of its launch; the wrappers
raise when it is not 0 (:func:`check`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

from ..obs import clock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# flash_bwd.cu's entry (v's width after hd); flash_bwd_sm90.cu's takes
# the same arguments
_FLASH_BWD = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 11 + [ctypes.c_void_p]
_GRAM_PRE = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])
_GRAM_GATHERED = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 4 \
    + [ctypes.c_void_p]
_SDDMM_PRE = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
              + [ctypes.c_int, ctypes.c_void_p])
_SDDMM_GATHERED = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
_SDDMM_PADDED = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
                 + [ctypes.c_int, ctypes.c_void_p])
_TOPK = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 9
         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# ctypes signatures of the C entries, by source: {entry: argtypes}
_SIGNATURES = {
    "gram": {"gram_f32": _GRAM_PRE, "gram_bf16": _GRAM_PRE,
             "gram_gathered_f32": _GRAM_GATHERED,
             "gram_gathered_bf16": _GRAM_GATHERED},
    "sddmm": {"sddmm_f32": _SDDMM_PRE, "sddmm_bf16": _SDDMM_PRE,
              "sddmm_gathered_f32": _SDDMM_GATHERED,
              "sddmm_gathered_bf16": _SDDMM_GATHERED,
              "sddmm_padded_f32": _SDDMM_PADDED,
              "sddmm_padded_bf16": _SDDMM_PADDED,
              "sddmm_padded_mixed": _SDDMM_PADDED},
    "topk_score": {"topk_score_f32": _TOPK, "topk_score_bf16": _TOPK},
    # the flash entries take v's width after hd, and lse's address as an
    # int64 after q_offset
    "flash": {"flash_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 21
              + [ctypes.c_void_p]},
    "flash_sm90": {"flash_sm90_fwd": [ctypes.c_void_p] * 4
                   + [ctypes.c_int64] * 20 + [ctypes.c_void_p]},
    "flash_bwd": {"flash_bwd": _FLASH_BWD},
    "flash_bwd_sm90": {"flash_bwd_sm90": _FLASH_BWD},
}

# sources outside csrc/ (a kept design timed beside the current one),
# by name; see register()
_SOURCES: Dict[str, Path] = {}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    """nvcc under ``CUDA_HOME`` (as PyTorch resolves it), else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built at "
        "first use; set CUDA_HOME to the CUDA toolkit or put nvcc on PATH")


def register(name: str, source, fn_name: str, argtypes) -> None:
    """Build ``source``, a .cu file with a plain C interface outside
    ``csrc/``, as library ``name`` beside the package's own sources,
    with the C entry ``fn_name`` of ctypes ``argtypes``."""
    _SOURCES[name] = Path(source)
    _SIGNATURES[name] = {fn_name: list(argtypes)}


def _source(name: str) -> Path:
    return _SOURCES.get(name, CSRC / f"{name}.cu")


def _target(name: str) -> Path:
    src = _source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    in parallel; returns each library's path.  Raises with nvcc's
    output when a build fails."""
    names = sorted(_SIGNATURES) if names is None else list(names)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            procs[n] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(n))],
                stdout=log, stderr=subprocess.STDOUT), tmp, log,
                clock.perf_counter())
        failed = []
        for n, (proc, tmp, log, t0) in procs.items():
            rc = proc.wait()
            build_seconds[n] = clock.perf_counter() - t0
            log.close()
            if rc == 0:
                os.replace(tmp, todo[n])
            else:
                failed.append(n)
        if failed:
            msgs = [f"--- {n}.cu ---\n" + todo[n].with_suffix(".log")
                    .read_text() for n in failed]
            raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return {n: _target(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, spills) of the current build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
