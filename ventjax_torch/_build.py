"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/ventjax_torch/`` (beside the
package), then loaded with ``ctypes``.  The library's file name carries a
hash of its sources and flags, so an edited kernel is rebuilt and a built one
is reused.  Nothing here runs at import time: the first kernel launch builds.

Flags: ``-O3`` for ``sm_90a`` (Hopper).  Never ``--use_fast_math``: the CI
head's exactness proof and N4's convergence test both rely on IEEE f32.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ventjax_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[tuple, ctypes.CDLL] = {}
# Seconds spent compiling per library in this process (0.0 when reused).
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda): "
        "the ventjax_torch CUDA kernels need the CUDA toolkit to build")


def _sources(name: str, csrc: Path):
    return [csrc / f"{name}.cu"] + sorted(csrc.glob("*.cuh"))


def library_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name, csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, csrc: Path = CSRC) -> Path:
    """Compile <csrc>/<name>.cu unless an identical build exists; return
    it.  ``csrc`` is the package's own ``csrc/`` unless a caller builds
    another copy of a source (a benchmark's older version)."""
    csrc = Path(csrc)
    out = library_path(name, csrc)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    nvcc = _nvcc()   # raises where there is none, before any file exists
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", tmp,
           str(csrc / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name if csrc == CSRC else str(csrc / name)] = \
        time.perf_counter() - t0
    return out


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library for <csrc>/<name>.cu, building it on first
    use."""
    key = (str(csrc), name)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, csrc)))
            _libs[key] = lib
        return lib
