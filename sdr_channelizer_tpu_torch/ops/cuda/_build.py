"""Builds the hand-written CUDA kernels at first use.

Every ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/libsdr_<name>_<hash>.so``, compiled by ``nvcc`` for
``sm_90a`` and loaded with ``ctypes``.  Nothing of PyTorch's headers is
included, so a source builds in seconds.  The hash is over the source's
content (plus the shared header and the flags): an edited source builds
anew, an unchanged one is loaded from the build directory.

``build_all()`` starts one ``nvcc`` per source, all together, and waits for
them; ``load(name)`` builds a single source when it is not there yet.
``ctypes``, ``subprocess`` and ``nvcc`` are touched only inside these
functions, so the package imports on a machine that has none of them.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

KERNEL_SOURCES = ("channelizer", "noise_floor", "latch", "pulse_stats",
                  "transpose")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, object] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    import shutil

    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of sdr_channelizer_tpu_torch "
        "are built from source at first use and need the CUDA toolkit")


def _source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _content_hash(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(
            [_source_path(name)]
            + [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libsdr_{name}_{_content_hash(name)}.so")


def _start_build(name: str, extra_flags: Optional[List[str]] = None):
    """Start ``nvcc`` for one source; returns ``(process, tmp, final)``."""
    import subprocess

    os.makedirs(BUILD_DIR, exist_ok=True)
    final = library_path(name)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *(extra_flags or []), "-I", CSRC_DIR,
           "-o", tmp, _source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final, cmd


def _finish_build(name: str, proc, tmp: str, final: str, cmd) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, final)  # atomic: a concurrent loader sees all or nothing
    return out


def build_all(verbose_ptxas: bool = False) -> Dict[str, str]:
    """Build every kernel source that is not built yet, one ``nvcc`` each,
    all started together.  Returns the compiler's output per source (empty
    for a source that was already built)."""
    extra = ["-Xptxas", "-v"] if verbose_ptxas else None
    with _lock:
        started = {}
        for name in KERNEL_SOURCES:
            if verbose_ptxas or not os.path.exists(library_path(name)):
                started[name] = _start_build(name, extra)
        return {name: _finish_build(name, *s) for name, s in started.items()}


def load(name: str):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    import ctypes

    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                _finish_build(name, *_start_build(name))
            lib = ctypes.CDLL(path)
            _libs[name] = lib
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch function."""
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel launch failed: {what} returned error {code} "
            f"(cudaError_t)")
