"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), and loaded with ``ctypes``.  Libraries land in
``autoround_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the compiler flags, so an edited source rebuilds and an
unchanged one is reused.  :func:`build_all` compiles every source at once,
one ``nvcc`` process per file started together.

Nothing here runs when a module is imported: the first CUDA call of a
kernel wrapper builds (if needed) and loads its library.  CPU tensors never
reach this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["SOURCES", "NVCC_FLAGS", "COUNTED", "build_all", "load", "check",
           "counted"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "w4a16_matmul",
           "w4a16_matmul_grouped", "w4a16_asym_matmul", "decode_attention",
           "w4a8_matmul", "w8a8_matmul", "w8a16_matmul", "w2a16_matmul",
           "fp8_matmul", "mxfp4_matmul", "sage_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# every kernel wrapper with a ``launches`` count, registered by its module
# as it is imported (:func:`counted`)
COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Give the wrapper ``fn`` a ``launches`` count of 0 (its module adds
    one where it launches its kernel) and register it in ``COUNTED``."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "autoround_tpu_torch are built on first use and "
                           "need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: List[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in parallel; returns {name: seconds}
    (0.0 for a library already built).  Raises with the compiler's output
    if any build fails.  The compiler's resource report (registers, shared
    memory, spills) is kept next to each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.time() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
