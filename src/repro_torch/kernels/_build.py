"""Build the CUDA sources of ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, ``build/<name>-<hash>.so`` at the repository root (a
directory git ignores), built for ``sm_90a`` at first use.  The hash
covers the source and the flags, so an edited source never loads a
stale library.  All sources build at once, one nvcc each, started
together.  Nothing is built when a module is imported.

Every C entry returns the ``cudaError_t`` of its launch; the wrappers
raise when it is not 0 (:func:`check`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# ctypes signatures of the C entries, by source
_SIGNATURES = {
    "gram": ("gram_f32", [ctypes.c_void_p] * 5
             + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]),
    "sddmm": ("sddmm_f32", [ctypes.c_void_p] * 3
              + [ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]),
    "topk_score": ("topk_score_f32", [ctypes.c_void_p] * 7
                   + [ctypes.c_int64] * 7 + [ctypes.c_int, ctypes.c_void_p]),
}

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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
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
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log,
                time.perf_counter())
        failed = []
        for n, (proc, tmp, log, t0) in procs.items():
            rc = proc.wait()
            build_seconds[n] = time.perf_counter() - t0
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
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
