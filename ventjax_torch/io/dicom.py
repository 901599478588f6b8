"""Self-contained DICOM codec (reader + writer), host-side.

The port's copy of the reference package's codec, for the cohort driver
(``pipeline/cohort.py``) and the synthetic studies (``io/synthetic.py``):

- read single multi-frame DICOMs and folders of per-slice DICOMs
  (``open_single_dicom``, ``open_dicom_folder``), with the per-frame
  functional-groups voxel-size lookup the driver makes;
- write Part-10 files (``write_file``, ``Dataset.save_as``);
- full-header dumps (``dicom_to_dict``).

Transfer syntaxes: Explicit VR Little Endian, Implicit VR Little Endian,
Deflated Explicit VR LE, Explicit VR Big Endian, RLE Lossless and the
Pillow-handled encapsulated family (JPEG Baseline .50, 8-bit JPEG Extended
.51, JPEG 2000 .90/.91), read and (Explicit VR LE, RLE Lossless) written
exactly as the reference package does.  Pillow is imported only when a
JPEG-family frame is decoded; where it is absent that decode raises a
ValueError.  JPEG Lossless (.57/.70) and JPEG-LS (.80/.81) stay rejected,
as in the reference package.
"""
from __future__ import annotations

import os
import secrets
import struct
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Tag dictionary (keyword <-> tag <-> VR) for the attributes the pipeline
# touches; unknown tags still round-trip by number.
# ---------------------------------------------------------------------------

_DICT: Dict[Tuple[int, int], Tuple[str, str]] = {
    (0x0002, 0x0001): ("OB", "FileMetaInformationVersion"),
    (0x0002, 0x0002): ("UI", "MediaStorageSOPClassUID"),
    (0x0002, 0x0003): ("UI", "MediaStorageSOPInstanceUID"),
    (0x0002, 0x0010): ("UI", "TransferSyntaxUID"),
    (0x0002, 0x0012): ("UI", "ImplementationClassUID"),
    (0x0008, 0x0016): ("UI", "SOPClassUID"),
    (0x0008, 0x0018): ("UI", "SOPInstanceUID"),
    (0x0008, 0x0020): ("DA", "StudyDate"),
    (0x0008, 0x0030): ("TM", "StudyTime"),
    (0x0008, 0x0031): ("TM", "SeriesTime"),
    (0x0008, 0x0060): ("CS", "Modality"),
    (0x0008, 0x103E): ("LO", "SeriesDescription"),
    (0x0010, 0x0010): ("PN", "PatientName"),
    (0x0010, 0x0020): ("LO", "PatientID"),
    (0x0010, 0x0030): ("DA", "PatientBirthDate"),
    (0x0010, 0x0040): ("CS", "PatientSex"),
    (0x0010, 0x1010): ("AS", "PatientAge"),
    (0x0010, 0x1020): ("DS", "PatientSize"),
    (0x0010, 0x1030): ("DS", "PatientWeight"),
    (0x0008, 0x0070): ("LO", "Manufacturer"),
    (0x0008, 0x1090): ("LO", "ManufacturerModelName"),
    (0x0018, 0x0050): ("DS", "SliceThickness"),
    (0x0018, 0x0080): ("DS", "RepetitionTime"),
    (0x0018, 0x0081): ("DS", "EchoTime"),
    (0x0018, 0x0087): ("DS", "MagneticFieldStrength"),
    (0x0018, 0x0088): ("DS", "SpacingBetweenSlices"),
    (0x0018, 0x1030): ("LO", "ProtocolName"),
    (0x0018, 0x1314): ("DS", "FlipAngle"),
    (0x0020, 0x000D): ("UI", "StudyInstanceUID"),
    (0x0020, 0x000E): ("UI", "SeriesInstanceUID"),
    (0x0020, 0x0011): ("IS", "SeriesNumber"),
    (0x0020, 0x0013): ("IS", "InstanceNumber"),
    (0x0020, 0x1041): ("DS", "SliceLocation"),
    (0x0028, 0x0002): ("US", "SamplesPerPixel"),
    (0x0028, 0x0004): ("CS", "PhotometricInterpretation"),
    (0x0028, 0x0006): ("US", "PlanarConfiguration"),
    (0x0028, 0x0008): ("IS", "NumberOfFrames"),
    (0x0028, 0x0010): ("US", "Rows"),
    (0x0028, 0x0011): ("US", "Columns"),
    (0x0028, 0x0030): ("DS", "PixelSpacing"),
    (0x0028, 0x0100): ("US", "BitsAllocated"),
    (0x0028, 0x0101): ("US", "BitsStored"),
    (0x0028, 0x0102): ("US", "HighBit"),
    (0x0028, 0x0103): ("US", "PixelRepresentation"),
    (0x5200, 0x9229): ("SQ", "SharedFunctionalGroupsSequence"),
    (0x5200, 0x9230): ("SQ", "PerFrameFunctionalGroupsSequence"),
    (0x0028, 0x9110): ("SQ", "PixelMeasuresSequence"),
    (0x7FE0, 0x0010): ("OW", "PixelData"),
}
_KEYWORD_TO_TAG = {kw: tag for tag, (_, kw) in _DICT.items()}
_TAG_VR = {tag: vr for tag, (vr, _) in _DICT.items()}

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"  # retired, still seen in archives
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"      # JPEG Baseline (Process 1)
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"      # JPEG Extended (Process 2&4)
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"  # JPEG 2000, lossless only
JPEG2000 = "1.2.840.10008.1.2.4.91"           # JPEG 2000

# Syntaxes decoded through Pillow.  JPEG Lossless (.57/.70) and JPEG-LS
# (.80/.81) need pylibjpeg/gdcm plugins, so they are rejected, as in the
# reference package.
_PIL_SYNTAXES = (JPEG_BASELINE, JPEG_EXTENDED, JPEG2000_LOSSLESS, JPEG2000)


class EncapsulatedPixelData:
    """Undecoded encapsulated PixelData: one compressed fragment per frame
    (PS3.5 A.4 requires exactly one fragment per frame for RLE Lossless).

    Kept raw at parse time so header-only reads (metadata scan, JSON export)
    never pay decompression; ``Dataset.pixel_array`` decodes on demand.
    """

    __slots__ = ("fragments", "offset_table")

    def __init__(self, fragments, offset_table=b""):
        self.fragments = list(fragments)
        self.offset_table = bytes(offset_table)

    def __repr__(self):
        return (f"EncapsulatedPixelData({len(self.fragments)} fragments, "
                f"{sum(len(f) for f in self.fragments)} bytes)")


def _rle_decode_segment(data: bytes, expected: int) -> bytes:
    """PackBits-style RLE segment decode (DICOM PS3.5 Annex G.3.1).

    Control byte n (unsigned): 0..127 -> copy the next n+1 literal bytes;
    129..255 -> repeat the next byte 257-n times; 128 -> no-op padding.
    """
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            j = i + h + 1
            if j > n:
                raise ValueError("RLE literal run past end of segment")
            out += data[i:j]
            i = j
        elif h > 128:
            if i >= n:
                raise ValueError("RLE replicate run past end of segment")
            out += data[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    if len(out) < expected:
        raise ValueError(
            f"RLE segment decoded to {len(out)} bytes, expected {expected}"
        )
    return bytes(out[:expected])


def _rle_decode_frame(
    frag: bytes, rows: int, cols: int, samples: int, bits: int
) -> np.ndarray:
    """Decode one RLE frame fragment to a [rows*cols*samples] uint array.

    Fragment = 64-byte header (uint32 segment count + up to 15 uint32
    segment offsets from fragment start) followed by the segments; segments
    are byte planes ordered MSB-first within each sample (PS3.5 G.2)."""
    if len(frag) < 64:
        raise ValueError("RLE fragment shorter than its 64-byte header")
    header = struct.unpack_from("<16I", frag, 0)
    nseg = header[0]
    bpp = bits // 8
    if nseg != samples * bpp or nseg > 15:
        # the 64-byte header holds at most 15 offsets, so nseg=16 (e.g.
        # 4 samples x 32 bits) can never be a valid fragment
        raise ValueError(
            f"RLE fragment has {nseg} segments, expected {samples * bpp} "
            f"({samples} samples x {bpp} bytes, max 15)"
        )
    offsets = list(header[1:1 + nseg])
    if any(o < 64 or o > len(frag) for o in offsets) or offsets != sorted(offsets):
        raise ValueError(f"invalid RLE segment offsets {offsets}")
    npix = rows * cols
    planes = []
    for k in range(nseg):
        end = offsets[k + 1] if k + 1 < nseg else len(frag)
        planes.append(np.frombuffer(
            _rle_decode_segment(frag[offsets[k]:end], npix), np.uint8
        ))
    out = np.empty((samples, npix), np.uint32)
    for s in range(samples):
        val = np.zeros(npix, np.uint32)
        for b in range(bpp):
            val = (val << np.uint32(8)) | planes[s * bpp + b].astype(np.uint32)
        out[s] = val
    return out


def _rle_encode_segment(data: bytes) -> bytes:
    """PackBits RLE segment encode (DICOM PS3.5 Annex G.3.1), inverse of
    _rle_decode_segment.

    Built from numpy run-length boundaries rather than a per-byte scan: the
    emit loop runs once per *run*, not per byte, so near-constant planes
    (high byte planes of 16-bit data, background-dominated masks) encode in
    a handful of iterations.  Runs of >= 2 identical bytes become replicate
    packets (257-n, byte); isolated bytes merge into literal packets of up
    to 128.  Output is padded to even length with the 0x80 no-op byte
    (segments must start on even boundaries, PS3.5 G.3.1).
    """
    a = np.frombuffer(data, np.uint8)
    out = bytearray()
    if a.size:
        change = np.flatnonzero(np.diff(a)) + 1
        starts = np.concatenate(([0], change)).tolist()
        ends = np.concatenate((change, [a.size])).tolist()
        lit_from: Optional[int] = None

        def flush_literal(upto: int) -> None:
            nonlocal lit_from
            if lit_from is None:
                return
            i = lit_from
            while i < upto:
                n = min(128, upto - i)
                out.append(n - 1)
                out.extend(data[i:i + n])
                i += n
            lit_from = None

        for s, e in zip(starts, ends):
            if e - s >= 2:
                flush_literal(s)
                i = s
                while i < e:
                    n = min(128, e - i)
                    if n == 1:
                        # a 128-chunked run can leave a 1-byte tail; fold it
                        # into a fresh literal instead of a length-1 replicate
                        lit_from = i
                        break
                    out += bytes((257 - n, data[i]))
                    i += n
            elif lit_from is None:
                lit_from = s
        flush_literal(a.size)
    if len(out) % 2:
        out.append(0x80)
    return bytes(out)


def _rle_encode_frame(frame: np.ndarray, bits: int) -> bytes:
    """Encode one [rows, cols, samples] frame as an RLE fragment: 64-byte
    header (segment count + offsets) followed by MSB-first byte-plane
    segments (PS3.5 G.2).  Inverse of _rle_decode_frame."""
    samples = frame.shape[2]
    bpp = bits // 8
    nseg = samples * bpp
    if nseg > 15:
        raise ValueError(
            f"RLE cannot encode {samples} samples x {bpp} bytes = {nseg} "
            "segments (the 64-byte header holds at most 15)")
    # two's-complement low `bits` of each value, signed or not
    vals = frame.astype(np.int64) & ((1 << bits) - 1)
    flat = vals.reshape(-1, samples)
    segs: List[bytes] = []
    for s in range(samples):
        for b in range(bpp):  # MSB first
            plane = ((flat[:, s] >> (8 * (bpp - 1 - b))) & 0xFF).astype(np.uint8)
            segs.append(_rle_encode_segment(plane.tobytes()))
    header = [nseg]
    off = 64
    for seg in segs:
        header.append(off)
        off += len(seg)
    header += [0] * (16 - len(header))
    return struct.pack("<16I", *header) + b"".join(segs)


def _encapsulated_frames(raw: "EncapsulatedPixelData", nframes: int) -> List[bytes]:
    """Group encapsulated fragments into one byte string per frame.

    PS3.5 A.4: a frame may span several fragments.  Resolution order —
    single frame: concatenate everything; one fragment per frame: identity;
    otherwise the Basic Offset Table (uint32 LE byte offsets of each frame's
    first fragment item, measured from the first byte after the BOT item)
    decides the grouping.  Anything else is ambiguous and fails loudly.
    """
    frags = raw.fragments
    if nframes == 1:
        return [b"".join(frags)]
    if len(frags) == nframes:
        return list(frags)
    bot = raw.offset_table
    if len(bot) == 4 * nframes:
        offsets = list(struct.unpack(f"<{nframes}I", bot))
        # byte position of each fragment's item tag relative to the first
        positions, pos = [], 0
        for f in frags:
            positions.append(pos)
            pos += 8 + len(f)  # item tag+length header precedes each fragment
        if offsets[0] != 0 or offsets != sorted(offsets) or not all(
                o in positions for o in offsets):
            raise ValueError(
                f"Basic Offset Table {offsets} does not align with "
                f"fragment positions {positions}")
        frames = []
        bounds = offsets + [pos]
        for f in range(nframes):
            frames.append(b"".join(
                frag for frag, p in zip(frags, positions)
                if bounds[f] <= p < bounds[f + 1]))
        if any(not fr for fr in frames):
            raise ValueError("Basic Offset Table leaves a frame empty")
        return frames
    raise ValueError(
        f"cannot map {len(frags)} encapsulated fragments to {nframes} "
        f"frames (no usable Basic Offset Table)")


def _pil_decode_frame(
    data: bytes, ts: str, rows: int, cols: int, samples: int, dtype,
) -> np.ndarray:
    """Decode one JPEG/JPEG-2000 frame via Pillow (the reference's handler).

    pydicom 2.3.0 routes these syntaxes to its Pillow handler
    (reference requirements.txt:4-5); decoding through PIL here gives
    byte-parity with what the reference app's ``pixel_array`` returns.
    """
    import io as _io

    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(
            f"decoding transfer syntax {ts} needs Pillow, which is not "
            "installed") from e
    try:
        with Image.open(_io.BytesIO(data)) as im:
            a = np.asarray(im)
    except Exception as e:  # e.g. 12-bit JPEG Extended: Pillow can't
        raise ValueError(
            f"Pillow could not decode a frame of transfer syntax {ts}: {e} "
            "(the reference's pydicom+Pillow stack has the same limit)"
        ) from e
    got_samples = a.shape[2] if a.ndim == 3 else 1
    if a.shape[:2] != (rows, cols) or got_samples != samples:
        raise ValueError(
            f"decoded frame is {a.shape} but the header claims "
            f"rows={rows} cols={cols} samples={samples}")
    return a.astype(dtype, copy=False)


MR_STORAGE = "1.2.840.10008.5.1.4.1.1.4"
ENHANCED_MR_STORAGE = "1.2.840.10008.5.1.4.1.1.4.1"
_UID_ROOT = "1.2.826.0.1.3680043.10.1453"  # ventjax org root (ad-hoc)

_STR_VRS = {"AE", "AS", "CS", "DA", "DS", "DT", "IS", "LO", "LT", "PN",
            "SH", "ST", "TM", "UC", "UI", "UR", "UT"}
_SHORT_LEN_VRS = _STR_VRS | {"AT", "FL", "FD", "SL", "SS", "UL", "US", "OB*"}


def generate_uid() -> str:
    """Unique UID under the ventjax root (pydicom.uid.generate_uid analog)."""
    return f"{_UID_ROOT}.{int(time.time() * 1e3)}.{secrets.randbelow(10**10)}"


class MultiValue(list):
    """DICOM multi-value (e.g. PixelSpacing) — a list that prints like one."""


class Element:
    __slots__ = ("tag", "vr", "value")

    def __init__(self, tag: Tuple[int, int], vr: str, value: Any):
        self.tag = tag
        self.vr = vr
        self.value = value

    @property
    def keyword(self) -> str:
        return _DICT.get(self.tag, (None, ""))[1]

    @property
    def name(self) -> str:
        return self.keyword or f"({self.tag[0]:04X},{self.tag[1]:04X})"

    @property
    def is_private(self) -> bool:
        return self.tag[0] % 2 == 1

    def __repr__(self):
        return f"<{self.tag[0]:04X},{self.tag[1]:04X} {self.vr} {self.name}>"


class Dataset:
    """Ordered tag->Element map with pydicom-style keyword attribute access."""

    def __init__(self):
        object.__setattr__(self, "_elems", {})

    # -- element access ------------------------------------------------------
    def add(self, tag: Tuple[int, int], vr: str, value: Any) -> None:
        self._elems[tag] = Element(tag, vr, value)

    def __contains__(self, key) -> bool:
        try:
            self._resolve(key)
            return True
        except KeyError:
            return False

    def _resolve(self, key) -> Tuple[int, int]:
        if isinstance(key, str):
            if key not in _KEYWORD_TO_TAG:
                raise KeyError(key)
            tag = _KEYWORD_TO_TAG[key]
        elif isinstance(key, tuple):
            tag = key
        else:
            raise KeyError(key)
        if tag not in self._elems:
            raise KeyError(key)
        return tag

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2 and all(
            isinstance(k, int) for k in key
        ):
            elem = self._elems[key]
        else:
            elem = self._elems[self._resolve(key)]
        if elem.vr == "SQ":
            return elem.value  # list of Dataset, indexable like pydicom
        return elem

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _KEYWORD_TO_TAG:
            tag = _KEYWORD_TO_TAG[name]
            if tag in self._elems:
                return self._elems[tag].value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in _KEYWORD_TO_TAG:
            tag = _KEYWORD_TO_TAG[name]
            self._elems[tag] = Element(tag, _TAG_VR[tag], value)
        else:
            object.__setattr__(self, name, value)

    def __iter__(self) -> Iterator[Element]:
        for tag in sorted(self._elems):
            yield self._elems[tag]

    def get(self, key, default=None):
        try:
            tag = self._resolve(key)
            return self._elems[tag].value
        except KeyError:
            return default

    # -- pixel data ------------------------------------------------------------
    @property
    def pixel_array(self) -> np.ndarray:
        """Decode PixelData to [frames?, rows, cols(, samples)] like pydicom."""
        raw = self.get("PixelData")
        if raw is None:
            raise AttributeError("no PixelData")
        bits = int(self.get("BitsAllocated", 16))
        signed = int(self.get("PixelRepresentation", 0)) == 1
        samples = int(self.get("SamplesPerPixel", 1))
        # ValueError, not AttributeError: an AttributeError escaping a
        # property is masked by __getattr__ into "AttributeError:
        # pixel_array", losing the actual cause.
        missing = [k for k in ("Rows", "Columns") if k not in self]
        if missing:
            raise ValueError(
                f"cannot decode PixelData: header element(s) "
                f"{', '.join(missing)} absent")
        rows = int(self.Rows)
        cols = int(self.Columns)
        nframes = int(self.get("NumberOfFrames", 1) or 1)
        if bits not in (8, 16, 32):
            raise ValueError(f"unsupported BitsAllocated {bits}")
        dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
        if signed:
            dtype = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
        if isinstance(raw, EncapsulatedPixelData):
            ts = self.get("TransferSyntaxUID")
            if ts == RLE_LOSSLESS:
                if len(raw.fragments) != nframes:
                    raise ValueError(
                        f"RLE PixelData has {len(raw.fragments)} fragments "
                        f"for {nframes} frames (RLE requires one fragment "
                        f"per frame)"
                    )
                frames = [
                    _rle_decode_frame(f, rows, cols, samples, bits)
                    for f in raw.fragments
                ]
                # [F, samples, npix] -> samples-last like pydicom
                a = np.stack(frames).astype(dtype)
                a = np.moveaxis(a, 1, 2)
            elif ts in _PIL_SYNTAXES:
                chunks = _encapsulated_frames(raw, nframes)
                a = np.stack([
                    _pil_decode_frame(c, ts, rows, cols, samples, dtype)
                    for c in chunks
                ])
            else:
                raise ValueError(
                    f"encapsulated PixelData with unsupported transfer "
                    f"syntax {ts} (JPEG Lossless and JPEG-LS need "
                    f"pylibjpeg/gdcm plugins, which are not used)"
                )
            if samples > 1:
                shape = ((nframes, rows, cols, samples) if nframes > 1
                         else (rows, cols, samples))
            else:
                shape = (nframes, rows, cols) if nframes > 1 else (rows, cols)
            return a.reshape(shape)
        bo = (">" if self.get("TransferSyntaxUID") == EXPLICIT_VR_BE
              else "<")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder(bo))
        count = rows * cols * samples * nframes
        # native byte order downstream; copy only when swapping (BE)
        arr = arr[:count].astype(dtype, copy=False)
        if samples > 1:
            shape = (nframes, rows, cols, samples) if nframes > 1 else (rows, cols, samples)
        else:
            shape = (nframes, rows, cols) if nframes > 1 else (rows, cols)
        return arr.reshape(shape)

    # -- io ---------------------------------------------------------------------
    def save_as(self, path: str,
                transfer_syntax: str = EXPLICIT_VR_LE) -> None:
        write_file(path, self, transfer_syntax=transfer_syntax)

    def copy(self) -> "Dataset":
        new = Dataset()
        for e in self:
            if e.vr == "SQ":
                new.add(e.tag, "SQ", [item.copy() for item in e.value])
            else:
                new.add(e.tag, e.vr, e.value)
        return new


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes, explicit: bool, big: bool = False):
        self.buf = buf
        self.pos = 0
        self.explicit = explicit
        self.bo = ">" if big else "<"

    def u16(self):
        v = struct.unpack_from(self.bo + "H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def u32(self):
        v = struct.unpack_from(self.bo + "I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def raw(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError(
                f"truncated DICOM stream: need {n} bytes at offset "
                f"{self.pos}, have {len(self.buf) - self.pos}"
            )
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def eof(self):
        return self.pos >= len(self.buf)

    def read_element(self):
        group = self.u16()
        elem = self.u16()
        tag = (group, elem)
        if tag == (0xFFFE, 0xE000) or tag == (0xFFFE, 0xE00D) or tag == (0xFFFE, 0xE0DD):
            length = self.u32()
            return tag, "NONE", length
        if self.explicit and group != 0xFFFE:
            vr = self.raw(2).decode("ascii", "replace")
            if vr in ("OB", "OW", "OF", "OD", "OL", "SQ", "UC", "UR", "UT", "UN"):
                self.pos += 2  # reserved
                length = self.u32()
            else:
                length = self.u16()
        else:
            vr = _TAG_VR.get(tag, "UN")
            length = self.u32()
        return tag, vr, length


def _parse_value(vr: str, raw: bytes, bo: str = "<"):
    if vr in _STR_VRS:
        s = raw.decode("latin-1").rstrip("\x00 ")
        if vr in ("DS", "IS") and "\\" in s:
            parts = s.split("\\")
            return MultiValue(_num(p, vr) for p in parts)
        if vr in ("DS", "IS"):
            return _num(s, vr) if s else ""
        if "\\" in s:
            return MultiValue(s.split("\\"))
        return s
    if vr == "US":
        vals = struct.unpack(f"{bo}{len(raw)//2}H", raw)
    elif vr == "SS":
        vals = struct.unpack(f"{bo}{len(raw)//2}h", raw)
    elif vr == "UL":
        vals = struct.unpack(f"{bo}{len(raw)//4}I", raw)
    elif vr == "SL":
        vals = struct.unpack(f"{bo}{len(raw)//4}i", raw)
    elif vr == "FL":
        vals = struct.unpack(f"{bo}{len(raw)//4}f", raw)
    elif vr == "FD":
        vals = struct.unpack(f"{bo}{len(raw)//8}d", raw)
    else:
        return raw
    if len(vals) == 1:
        return vals[0]
    return MultiValue(vals)


def _num(s: str, vr: str):
    s = s.strip()
    if not s:
        return ""
    return int(s) if vr == "IS" else float(s)


def _read_dataset(r: _Reader, stop_at: Optional[int] = None) -> Dataset:
    ds = Dataset()
    end = stop_at if stop_at is not None else len(r.buf)
    while r.pos < end and not r.eof():
        tag, vr, length = r.read_element()
        if tag == (0xFFFE, 0xE00D):  # item delimitation
            break
        if vr == "SQ":
            items: List[Dataset] = []
            if length == 0xFFFFFFFF:
                while True:
                    itag, _, ilen = r.read_element()
                    if itag == (0xFFFE, 0xE0DD):
                        break
                    if itag != (0xFFFE, 0xE000):
                        raise ValueError(f"bad sequence item tag {itag}")
                    if ilen == 0xFFFFFFFF:
                        items.append(_read_dataset(r))
                    else:
                        items.append(_read_dataset(r, r.pos + ilen))
            else:
                seq_end = r.pos + length
                while r.pos < seq_end:
                    itag, _, ilen = r.read_element()
                    if itag != (0xFFFE, 0xE000):
                        break
                    if ilen == 0xFFFFFFFF:
                        items.append(_read_dataset(r))
                    else:
                        items.append(_read_dataset(r, r.pos + ilen))
            ds.add(tag, "SQ", items)
            continue
        if length == 0xFFFFFFFF:
            if tag == (0x7FE0, 0x0010):
                # Encapsulated PixelData (PS3.5 A.4): a Basic Offset Table
                # item (possibly empty) then one fragment item per frame,
                # closed by a sequence delimiter.
                offset_table = b""
                frags: List[bytes] = []
                first = True
                while True:
                    itag, _, ilen = r.read_element()
                    if itag == (0xFFFE, 0xE0DD):
                        break
                    if itag != (0xFFFE, 0xE000) or ilen == 0xFFFFFFFF:
                        raise ValueError(
                            f"bad encapsulated pixel-data item {itag}"
                        )
                    data = bytes(r.raw(ilen))
                    if first:
                        offset_table = data
                        first = False
                    else:
                        frags.append(data)
                ds.add(tag, "OB", EncapsulatedPixelData(frags, offset_table))
                continue
            raise ValueError(
                f"undefined-length non-SQ element {tag} (encapsulated "
                "non-pixel data is not supported)"
            )
        raw = r.raw(length)
        if tag == (0x7FE0, 0x0010):
            ds.add(tag, vr if vr != "UN" else "OW", bytes(raw))
        else:
            ds.add(tag, vr if vr != "NONE" else "UN",
                   _parse_value(vr, raw, r.bo))
    return ds


def read_file(path: str) -> Dataset:
    """Read a DICOM Part-10 file (or bare implicit-VR stream)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) > 132 and buf[128:132] == b"DICM":
        # file meta group is always explicit VR LE
        r = _Reader(buf, explicit=True)
        r.pos = 132
        meta = Dataset()
        # (0002,0000) FileMetaInformationGroupLength, when present, bounds
        # the meta group exactly — essential for Deflated files, where the
        # body is a raw deflate stream whose first bytes may happen to
        # parse as a group-0002 tag (02 00 = a fixed-huffman block header).
        meta_end = None
        while not r.eof():
            if meta_end is not None and r.pos >= meta_end:
                break
            save = r.pos
            tag, vr, length = r.read_element()
            if tag[0] != 0x0002:
                r.pos = save
                break
            val = _parse_value(vr, r.raw(length))
            meta.add(tag, vr, val)
            if tag == (0x0002, 0x0000) and meta_end is None:
                try:
                    end = r.pos + int(val)
                except (TypeError, ValueError):
                    end = -1
                if r.pos <= end <= len(buf):
                    meta_end = end
        if meta_end is not None and r.pos < meta_end:
            r.pos = meta_end  # skip meta bytes the loop could not parse
        ts = meta.get("TransferSyntaxUID", EXPLICIT_VR_LE)
        if not isinstance(ts, str):
            # a corrupted UI value can parse as a MultiValue (embedded
            # backslash) or a number — reject, don't crash on .startswith
            raise ValueError(f"malformed TransferSyntaxUID {ts!r}")
        # Every encapsulated syntax (1.2.840.10008.1.2.4.* JPEG family, .5
        # RLE) carries an Explicit VR LE dataset, so header-only reads work
        # for all of them — like pydicom's dcmread; pixel_array raises on
        # the ones neither stack can decode.
        if ts not in (EXPLICIT_VR_LE, IMPLICIT_VR_LE, RLE_LOSSLESS,
                      DEFLATED_EXPLICIT_VR_LE, EXPLICIT_VR_BE) and \
                not ts.startswith("1.2.840.10008.1.2.4."):
            raise ValueError(f"unsupported transfer syntax {ts}")
        if ts == DEFLATED_EXPLICIT_VR_LE:
            # PS3.5 A.5: everything after the file meta group is one raw
            # deflate stream (no zlib header) of an Explicit VR LE dataset.
            import zlib

            body = _Reader(zlib.decompress(buf[r.pos:], -15), explicit=True)
        else:
            # RLE Lossless datasets are Explicit VR LE with encapsulated
            # pixels; Explicit VR Big Endian flips every binary field.
            body = _Reader(buf, explicit=(ts != IMPLICIT_VR_LE),
                           big=(ts == EXPLICIT_VR_BE))
            body.pos = r.pos
        ds = _read_dataset(body)
        for e in meta:
            ds.add(e.tag, e.vr, e.value)
        return ds
    # no preamble: try explicit, fall back to implicit
    for explicit in (True, False):
        try:
            return _read_dataset(_Reader(buf, explicit=explicit))
        except Exception:
            continue
    raise ValueError(f"could not parse DICOM file {path}")


# alias matching the pydicom call sites
dcmread = read_file


# ---------------------------------------------------------------------------
# Writer (Explicit VR Little Endian)
# ---------------------------------------------------------------------------

def _encode_value(vr: str, value: Any) -> bytes:
    if vr in _STR_VRS:
        if isinstance(value, (list, tuple, MultiValue)):
            s = "\\".join(_fmt(v, vr) for v in value)
        else:
            s = _fmt(value, vr)
        raw = s.encode("latin-1")
        if len(raw) % 2:
            raw += b"\x00" if vr == "UI" else b" "
        return raw
    tolist = lambda v: list(v) if isinstance(v, (list, tuple, MultiValue)) else [v]
    if vr == "US":
        return struct.pack(f"<{len(tolist(value))}H", *[int(v) for v in tolist(value)])
    if vr == "SS":
        return struct.pack(f"<{len(tolist(value))}h", *[int(v) for v in tolist(value)])
    if vr == "UL":
        return struct.pack(f"<{len(tolist(value))}I", *[int(v) for v in tolist(value)])
    if vr == "SL":
        return struct.pack(f"<{len(tolist(value))}i", *[int(v) for v in tolist(value)])
    if vr == "FL":
        return struct.pack(f"<{len(tolist(value))}f", *[float(v) for v in tolist(value)])
    if vr == "FD":
        return struct.pack(f"<{len(tolist(value))}d", *[float(v) for v in tolist(value)])
    raw = bytes(value)
    if len(raw) % 2:
        raw += b"\x00"
    return raw


def _fmt(v, vr) -> str:
    if vr == "DS" and isinstance(v, float):
        s = f"{v:.10g}"
        return s
    return str(v)


def _write_element(out: bytearray, tag, vr, raw: bytes) -> None:
    out += struct.pack("<HH", tag[0], tag[1])
    if vr in ("OB", "OW", "OF", "OD", "OL", "SQ", "UC", "UR", "UT", "UN"):
        out += vr.encode("ascii") + b"\x00\x00" + struct.pack("<I", len(raw))
    else:
        out += vr.encode("ascii") + struct.pack("<H", len(raw))
    out += raw


def _encode_dataset(ds: Dataset, skip_meta: bool = True) -> bytes:
    out = bytearray()
    for e in ds:
        if skip_meta and e.tag[0] == 0x0002:
            continue
        if e.vr == "SQ":
            body = bytearray()
            for item in e.value:
                ibody = _encode_dataset(item, skip_meta=False)
                body += struct.pack("<HHI", 0xFFFE, 0xE000, len(ibody))
                body += ibody
            _write_element(out, e.tag, "SQ", bytes(body))
        else:
            _write_element(out, e.tag, e.vr, _encode_value(e.vr, e.value))
    return bytes(out)


def write_file(path: str, ds: Dataset,
               transfer_syntax: str = EXPLICIT_VR_LE) -> None:
    """Write a Part-10 file, Explicit VR LE (default) or RLE Lossless.

    Explicit VR LE: a dataset read from an encapsulated or big-endian file
    is transcoded (decoded) on write and the stale TransferSyntaxUID dropped.

    RLE Lossless: PixelData (decoded first if already encapsulated) is
    re-encoded per PS3.5 Annex G — one fragment per frame, MSB-first byte
    planes — behind a populated Basic Offset Table; the dataset body stays
    Explicit VR LE as the standard requires.  The reference's pydicom stack
    both reads and writes this syntax, so PACS exports can stay compressed.
    """
    if transfer_syntax not in (EXPLICIT_VR_LE, RLE_LOSSLESS):
        raise ValueError(
            f"write_file supports Explicit VR LE and RLE Lossless, not "
            f"{transfer_syntax}")
    frags: Optional[List[bytes]] = None
    if transfer_syntax == RLE_LOSSLESS:
        if ds.get("PixelData") is None:
            raise ValueError("RLE Lossless write requires PixelData")
        ds = ds.copy()
        rows, cols = int(ds.Rows), int(ds.Columns)
        samples = int(ds.get("SamplesPerPixel", 1))
        nframes = int(ds.get("NumberOfFrames", 1) or 1)
        bits = int(ds.get("BitsAllocated", 16))
        if bits not in (8, 16, 32):
            raise ValueError(f"RLE encode: BitsAllocated {bits} not in 8/16/32")
        frames = ds.pixel_array.reshape(nframes, rows, cols, samples)
        frags = [_rle_encode_frame(frames[f], bits) for f in range(nframes)]
        ds._elems.pop((0x7FE0, 0x0010), None)   # re-emitted encapsulated
        ds._elems.pop((0x0002, 0x0010), None)   # meta carries the syntax
    else:
        needs_transcode = (
            isinstance(ds.get("PixelData"), EncapsulatedPixelData)
            or (ds.get("TransferSyntaxUID") == EXPLICIT_VR_BE
                and ds.get("PixelData") is not None)
        )
        if needs_transcode:
            ds = ds.copy()
            arr = ds.pixel_array
            native = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            ds.add((0x7FE0, 0x0010), "OW", native.tobytes())
            ds._elems.pop((0x0002, 0x0010), None)  # stale TransferSyntaxUID
    meta = Dataset()
    meta.add((0x0002, 0x0001), "OB", b"\x00\x01")
    meta.MediaStorageSOPClassUID = ds.get("SOPClassUID", MR_STORAGE)
    meta.MediaStorageSOPInstanceUID = ds.get("SOPInstanceUID", generate_uid())
    meta.TransferSyntaxUID = transfer_syntax
    meta.ImplementationClassUID = _UID_ROOT + ".1"
    meta_bytes = _encode_dataset(meta, skip_meta=False)
    body = _encode_dataset(ds, skip_meta=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(meta_bytes)
        f.write(body)
        if frags is not None:
            # undefined-length PixelData: Basic Offset Table item with the
            # byte position of each frame's fragment item, then the
            # fragments, then the sequence delimiter (PS3.5 A.4)
            f.write(struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00")
            f.write(struct.pack("<I", 0xFFFFFFFF))
            bot, pos = [], 0
            for frag in frags:
                bot.append(pos)
                pos += 8 + len(frag)
            f.write(struct.pack("<HHI", 0xFFFE, 0xE000, 4 * len(bot)))
            f.write(struct.pack(f"<{len(bot)}I", *bot))
            for frag in frags:
                f.write(struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)))
                f.write(frag)
            f.write(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))


# ---------------------------------------------------------------------------
# High-level ingest mirroring the reference entry points
# ---------------------------------------------------------------------------

def open_single_dicom(path: str) -> Tuple[Dataset, np.ndarray]:
    """Multi-frame DICOM -> (ds, [rows, cols, slices]) — transpose semantics
    of Vent_Analysis.py:178-179 (pixel_array [frames,rows,cols] -> (1,2,0))."""
    ds = read_file(path)
    arr = ds.pixel_array
    if arr.ndim == 2:
        arr = arr[None]
    return ds, np.transpose(arr, (1, 2, 0))


def open_dicom_folder(folder: str) -> Tuple[Dataset, np.ndarray]:
    """Sorted *.dcm files stacked into [rows, cols, n]; returns the LAST
    slice's dataset like the reference (Vent_Analysis.py:184-196)."""
    files = [f for f in sorted(os.listdir(folder)) if f.endswith(".dcm")]
    if not files:
        raise FileNotFoundError(f"no .dcm files in {folder}")
    ds = read_file(os.path.join(folder, files[0]))
    first = ds.pixel_array
    mask = np.zeros((first.shape[0], first.shape[1], len(files)))
    for k, fname in enumerate(files):
        ds = read_file(os.path.join(folder, fname))
        mask[:, :, k] = ds.pixel_array
    return ds, mask


def dicom_to_dict(ds: Dataset, include_private: bool = False) -> dict:
    """Recursive header walk, skipping Pixel Data
    (Vent_Analysis.py:360-372 semantics)."""
    out: dict = {}
    for e in ds:
        if not include_private and e.is_private:
            continue
        if e.name in ("Pixel Data", "PixelData"):
            continue
        if e.vr == "SQ":
            out[e.name] = [dicom_to_dict(item, include_private) for item in e.value]
        else:
            out[e.name] = str(e.value)
    return out
