"""Build a native source of the package and load it with ctypes.

Each ``csrc/<name>.cu`` (compiled with plain ``nvcc``) or ``csrc/<name>.cpp``
(compiled with the host's ``g++``) exposes a plain C interface and is
compiled at first use into ``csrc/build/lib<name>-<hash>.so`` (``.gitignore``
lists the directory). A source may need libraries of its own
(``LINK_FLAGS``). The hash covers the source bytes, the compiler flags and
the link flags, so an edited source or flag never loads a stale library. The
compile goes to a temporary name and is renamed into place, so concurrent
first uses cannot load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
# Libraries a source links against, after its source file on the command line.
LINK_FLAGS = {"jpeg_nvjpeg": ("-lnvjpeg",), "jpeg_cpu": ("-ljpeg",)}
BUILD_TIMEOUT_S = 300

_LOADED: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
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


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found:
        return found
    raise RuntimeError("no C++ compiler (g++) on PATH; the host decoder cannot be built")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` or ``csrc/<name>.cpp``."""
    for suffix in (".cu", ".cpp"):
        path = CSRC / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _command(name: str) -> tuple[list[str], tuple[str, ...]]:
    """(compiler and its flags, link flags) for the source ``name``."""
    source = source_path(name)
    if source.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS], LINK_FLAGS.get(name, ())
    return [_cxx(), *CXX_FLAGS], LINK_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    source = source_path(name)
    flags = NVCC_FLAGS if source.suffix == ".cu" else CXX_FLAGS
    key = source.read_bytes() + " ".join(flags).encode() + b"|" + " ".join(LINK_FLAGS.get(name, ())).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless the library for this source exists."""
    target = library_path(name)
    if target.exists():
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "compiler_output": "", "path": str(target)})
        return target
    compiler, link = _command(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [*compiler, "-o", tmp, str(source_path(name)), *link],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"build of {source_path(name).name} failed:\n{proc.stdout}\n{proc.stderr}")
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
    """The ctypes handle of ``csrc/<name>``, built on first call."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        return lib
