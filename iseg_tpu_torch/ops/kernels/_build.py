"""Build a CUDA source of ``iseg_tpu_torch/csrc`` with nvcc and load it.

Each source is compiled on first use into a shared library with a plain C
interface, for ``sm_90a`` (Hopper), under ``iseg_tpu_torch/_build/`` (listed
in ``.gitignore``). The library's file name carries a hash of the source and
the flags, so an edited source builds anew and an unchanged one loads from
the directory. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: pathlib.Path
    compiled: bool  # False when an up-to-date library was loaded as it was
    seconds: float  # compile time, 0 when nothing was compiled
    log: str  # nvcc's output (ptxas register/spill report)


_LOADED: dict[str, Built] = {}


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
    if source in _LOADED:
        return _LOADED[source]
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
    built = Built(ctypes.CDLL(str(out)), out, compiled, seconds, log)
    _LOADED[source] = built
    return built
