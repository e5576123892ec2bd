"""Build a CUDA source of the package with plain ``nvcc`` and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into ``csrc/build/lib<name>-<hash>.so`` (``.gitignore`` lists the
directory). The hash covers the source bytes and the compiler flags, so an
edited source never loads a stale library. The compile goes to a temporary
name and is renamed into place, so concurrent first uses cannot load a
half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}  # name → {"seconds", "compiler_output", "path"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source exists."""
    target = library_path(name)
    if target.exists():
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "compiler_output": "", "path": str(target)})
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG[name] = {
        "seconds": time.perf_counter() - t0,
        "compiler_output": (proc.stdout + proc.stderr).strip(),
        "path": str(target),
    }
    return target


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first call."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
