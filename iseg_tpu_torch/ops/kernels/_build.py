"""Build a CUDA source of ``iseg_tpu_torch/csrc`` with nvcc and load it.

Each source is compiled on first use into a shared library with a plain C
interface, for ``sm_90a`` (Hopper), under ``iseg_tpu_torch/_build/`` (listed
in ``.gitignore``). The library's file name carries a hash of the source and
the flags, so an edited source builds anew and an unchanged one loads from
the directory. A source is built by one thread at a time: a :func:`load` of a
source whose build is under way waits for it. Nothing here runs at import
time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# --split-compile=0: nvcc compiles a source's kernels on all the host's cores
# (window_attention.cu in about half the time one core takes)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0",
)


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: pathlib.Path
    compiled: bool  # False when an up-to-date library was loaded as it was
    seconds: float  # compile time, 0 when nothing was compiled
    log: str  # nvcc's output (ptxas register/spill report)


_LOADED: dict[str, Built] = {}
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels of iseg_tpu_torch need the CUDA toolkit")
    return found


def load(source: str) -> Built:
    """Compile ``csrc/<source>`` if needed and return the loaded library."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source not in _LOADED:
            _LOADED[source] = _compile_and_load(source)
        return _LOADED[source]


def _compile_and_load(source: str) -> Built:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    compiled, seconds, log = False, 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n{log}")
        os.replace(tmp, out)
        compiled = True
    return Built(ctypes.CDLL(str(out)), out, compiled, seconds, log)


def load_all(sources: list[str]) -> list[Built]:
    """:func:`load` every source, one nvcc process per source, all started
    together (a build's time is then the slowest source's, not the sum)."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(load, sources))


def load_later(sources: list[str]) -> concurrent.futures.Future:
    """Start :func:`load_all` of ``sources`` on a thread of its own and
    return its future (the caller goes on meanwhile; nvcc runs outside the
    interpreter's lock)."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(load_all, sources)
    finally:
        pool.shutdown(wait=False)
