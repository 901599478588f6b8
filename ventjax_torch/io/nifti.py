"""Minimal NIfTI-1 codec (nibabel is not available in this environment).

Covers the reference's export need — a float32 4-D array with an identity
affine (Vent_Analysis.py:273-290 exportNifti) — plus a reader for tests.
Header layout per the NIfTI-1 standard (348-byte header, single-file .nii).
"""
from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save(path: str, data: np.ndarray, affine: np.ndarray | None = None,
         vox: Tuple[float, ...] | None = None) -> None:
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    if affine is None:
        affine = np.eye(4)
    dims = list(data.shape)
    ndim = len(dims)
    if ndim > 7:
        raise ValueError(f"NIfTI-1 supports at most 7 dimensions, got {ndim}")
    if any(d > 32767 for d in dims):  # dim[] is int16 in the header
        raise ValueError(f"axis length over the NIfTI-1 int16 limit: {dims}")
    dim = [ndim] + dims + [1] * (7 - ndim)
    pixdim = [0.0] * 8
    if vox is not None:
        for i, v in enumerate(vox[:7]):
            pixdim[i + 1] = float(v)
    else:
        pixdim[1:4] = [1.0, 1.0, 1.0]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)                      # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, *dim)                   # dim
    struct.pack_into("<h", hdr, 70, _CODES[data.dtype])      # datatype
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8) # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)                # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                    # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                      # sform_code
    struct.pack_into("<h", hdr, 254, 1)
    struct.pack_into("<4f", hdr, 280, *affine[0])            # srow_x
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    # One copy at most: tobytes(order="F") serializes any layout in
    # Fortran order directly (a pure memcpy when the caller passes an
    # F-contiguous array — build_4d_array allocates its export array that
    # way for exactly this reason), and header/extender/payload are
    # written as three buffers instead of concatenated into a fourth.
    payload = data.tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(bytes(hdr))
            f.write(b"\x00\x00\x00\x00")
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(hdr)
            f.write(b"\x00\x00\x00\x00")
            f.write(payload)


def load(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (data, affine)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        buf = f.read()
    if len(buf) < 348:
        raise ValueError(
            f"file is {len(buf)} bytes, shorter than the 348-byte "
            "NIfTI-1 header")
    if struct.unpack_from("<i", buf, 0)[0] != 348:
        raise ValueError("not a little-endian NIfTI-1 file")
    if buf[344:347] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI-1 magic {buf[344:348]!r}")
    dim = struct.unpack_from("<8h", buf, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"NIfTI-1 dim[0]={ndim} outside 1..7")
    shape = dim[1:1 + ndim]
    if any(d < 1 for d in shape):
        raise ValueError(f"non-positive axis length in dim {shape}")
    code = struct.unpack_from("<h", buf, 70)[0]
    if code not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {code}")
    vox_offset = int(struct.unpack_from("<f", buf, 108)[0])
    dtype = np.dtype(_DTYPES[code]).newbyteorder("<")
    n = int(np.prod(shape))
    if vox_offset < 348 or vox_offset + n * dtype.itemsize > len(buf):
        raise ValueError(
            f"data range [{vox_offset}, {vox_offset + n * dtype.itemsize}) "
            f"outside the {len(buf)}-byte file")
    data = np.frombuffer(buf, dtype=dtype, count=n, offset=vox_offset)
    data = data.reshape(shape, order="F")
    affine = np.eye(4)
    affine[0] = struct.unpack_from("<4f", buf, 280)
    affine[1] = struct.unpack_from("<4f", buf, 296)
    affine[2] = struct.unpack_from("<4f", buf, 312)
    return data, affine
