"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
go to ``build/repro_torch_kernels/`` at the repository root, named by a hash
of the source, every shared header and the flags, so a changed source is rebuilt at first use and an
unchanged one is reused.  ``build_all`` starts one ``nvcc`` per source, all
together.  No ``--use_fast_math``: the router's integer outputs must match
its plain version exactly.

Building happens only when a kernel is first launched (or ``build_all`` is
called), never at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_decode_paged", "topk_router", "moe_gemm", "flash_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """Every shared header counts, so a changed ``csrc/*.cuh`` rebuilds the
    libraries that may include it."""
    h = hashlib.sha256()
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.tmp, proc.out = tmp, out      # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{log}")
    os.replace(proc.tmp, proc.out)     # type: ignore[attr-defined]
    return log


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library in parallel, one ``nvcc`` per source.
    Returns the compiler's log (``-Xptxas -v``: registers, shared memory,
    spills) for each library built now; cached ones map to ''."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not _lib_path(n).exists()}
    logs = {n: "" for n in names}
    for n, p in procs.items():
        logs[n] = _finish(n, p)
    return logs


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale;
    ``bind`` declares its C signatures once, when it is first loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            bind(lib)
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg}) at launch")
