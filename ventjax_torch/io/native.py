"""ctypes bindings to the native DICOM decoder (native/dicomscan.cpp).

The port's copy of the reference package's binding, over the same library
at the repository root.  The library is built on demand with
`make -C native`; if the build or load fails, callers fall back to the pure
Python codec (ventjax_torch.io.dicom).  ctypes releases the GIL for the
duration of each decode call, so the cohort loader's thread pool gets true
parallelism.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdicomscan.so")

_lib = None
_tried = False
# Minimum library version this binding expects (vj_version); a stale .so
# from an older checkout triggers a rebuild.
_EXPECTED_VERSION = 3


def build(force: bool = False) -> bool:
    """Build libdicomscan.so; returns True on success."""
    if os.path.exists(_LIB_PATH) and not force:
        return True
    try:
        cmd = ["make", "-C", _NATIVE_DIR, "-s"]
        if force:
            cmd.append("-B")
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _bind(lib):
    lib.vj_dicom_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vj_dicom_decode.restype = ctypes.c_int
    lib.vj_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.vj_version.restype = ctypes.c_int
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not build():
        return None
    try:
        lib = _bind(ctypes.CDLL(_LIB_PATH))
        if lib.vj_version() < _EXPECTED_VERSION:
            # A .so built from an older source tree; rebuild and retry.
            # dlopen may return the stale cached mapping if the linker
            # reused the inode, so re-check the version and fall back to
            # the Python codec rather than call mismatched symbols.
            if not build(force=True):
                _lib = None
                return None
            lib = _bind(ctypes.CDLL(_LIB_PATH))
            if lib.vj_version() < _EXPECTED_VERSION:
                _lib = None
                return None
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def decode_pixels(path: str) -> Optional[Tuple[np.ndarray, Tuple[float, float, float]]]:
    """Fast path: (pixel array [frames?, rows, cols(, samples)], spacing).

    Returns None when the native library is unavailable or the file needs
    the full Python codec (compressed syntaxes, odd layouts).
    """
    lib = _load()
    if lib is None:
        return None
    meta = (ctypes.c_int64 * 8)()
    spacing = (ctypes.c_double * 3)()
    pixels = ctypes.POINTER(ctypes.c_uint8)()
    nbytes = ctypes.c_int64()
    rc = lib.vj_dicom_decode(path.encode(), meta, spacing,
                             ctypes.byref(pixels), ctypes.byref(nbytes))
    if rc != 0:
        return None
    try:
        rows, cols, frames, samples, bits, pixrep = (int(meta[i]) for i in range(6))
        buf = ctypes.string_at(pixels, nbytes.value)
    finally:
        lib.vj_free(pixels)
    dt = {(8, 0): np.uint8, (8, 1): np.int8, (16, 0): np.uint16,
          (16, 1): np.int16, (32, 0): np.uint32, (32, 1): np.int32}.get(
        (bits, pixrep))
    if dt is None:
        return None
    arr = np.frombuffer(buf, dtype=np.dtype(dt).newbyteorder("<"))
    count = rows * cols * samples * frames
    if arr.size < count:
        return None  # header claims more pixels than the file holds
    arr = arr[:count]
    if samples > 1:
        shape = (frames, rows, cols, samples) if frames > 1 else (rows, cols, samples)
    else:
        shape = (frames, rows, cols) if frames > 1 else (rows, cols)
    sp = (float(spacing[0]), float(spacing[1]), float(spacing[2]))
    return arr.reshape(shape), sp
