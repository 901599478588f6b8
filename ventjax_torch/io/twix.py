"""Minimal Siemens TWIX (.dat) raw-data reader (VD/VE multi-raid layout).

The port's copy of ``ventjax/io/twix.py`` (NumPy only), with the same
names, layouts and bytes.  mapvbvd is not a dependency; this module
implements the subset the reference uses (Vent_Analysis.py:522-540
process_RAW): read the last measurement's image scans into a complex
k-space array and pull PrepareTimestamp / tProtocolName from the protocol
text.  Uncompressed ADC
data, no oversampling removal — the recon itself lives in
ventjax_torch.ops.fft_recon.

Layout vs mapvbvd (the reference's reader):
- The reference sets `raw_twix.image.squeeze = True` and takes
  `raw_K = image['']` (Vent_Analysis.py:535-536).  mapvbvd's unsqueezed
  order is [Col, Cha, Lin, Par, Sli, Ave, ...]; with squeeze the singleton
  dims drop, so a single-channel 2-D multislice scan yields
  [Col, Lin, Sli] — exactly this module's `kspace()` layout, so
  `process_RAW`'s per-slice `raw_K[:, :, k]` loop (line 538) behaves
  identically on either reader.
- For a MULTI-channel scan, squeezed mapvbvd yields [Col, Cha, Lin, Sli]
  and the reference's 3-D loop would slice the wrong axes — its process_RAW
  is implicitly single-coil.  Here multi-coil data is explicit:
  `kspace()` raises with a pointer to `kspace_multicoil()`
  ([Cha, Col, Lin, Sli]) and the root-sum-of-squares recon
  (ventjax_torch.ops.fft_recon.recon_2d_multislice_rss) — never a silent
  channel overwrite.

The exact MDH field layout below is written/read from the same struct
definitions, and `write_synthetic_twix` / `write_synthetic_twix_vb` produce
files in these layouts for round-trip tests.  Real scanner files that follow
the standard layouts parse too.

VB-era files (single measurement, 128-byte sMDH with the channel id INSIDE
each MDH, no separate channel headers) are supported alongside VD/VE
(mapvbvd parses both, reference Vent_Analysis.py:532).  Dispatch uses
mapvbvd's published heuristic: first uint32 < 10000 and second uint32 in
[1, 64] means a VD/VE multi-raid header, anything else is a VB header
length.
"""
from __future__ import annotations

import dataclasses
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_MDH_FMT = "<IiIII HH iiiI QHH 28s I HH fI HH 28s 48s 16s"
# DMALength/flags, MeasUID, ScanCounter, TimeStamp, PMUTimeStamp,
# SystemType, PTABPosDelay, PTABPosX/Y/Z, Reserved1, EvalInfoMask,
# SamplesInScan, UsedChannels, LoopCounters(14xu16), CutOff(2xu16 packed),
# CentreColumn, CoilSelect, ReadOutOffcentre, TimeSinceLastRF, CentreLine,
# CentrePartition, SliceData(28), IceProgramPara(24xu16), ReservedPara
_MDH_SIZE = struct.calcsize(_MDH_FMT)
assert _MDH_SIZE == 192, _MDH_SIZE

_CH_FMT = "<IiIIIIHHI"
_CH_SIZE = struct.calcsize(_CH_FMT)
assert _CH_SIZE == 32, _CH_SIZE

ACQEND = 1 << 0
# evalInfoMask bits (Siemens ICE; same values mapVBVD keys its scan
# sorting on).  Real scanner files interleave service scans with the
# image lines; the reference's mapvbvd call returns only the image set,
# so this reader must filter the same way.
RTFEEDBACK = 1 << 1
HPFEEDBACK = 1 << 2
SYNCDATA = 1 << 5          # physio/sync packet: raw block, NOT channel data
REFPHASESTABSCAN = 1 << 14
PHASESTABSCAN = 1 << 15
PHASCOR = 1 << 21
PATREFSCAN = 1 << 22
PATREFANDIMASCAN = 1 << 23
NOISEADJSCAN = 1 << 25
_NON_IMAGE_MASK = (RTFEEDBACK | HPFEEDBACK | PHASCOR | NOISEADJSCAN
                   | REFPHASESTABSCAN | PHASESTABSCAN)
_DMA_LEN_MASK = 0x01FFFFFF  # low 25 bits of the first MDH u32


def _is_image_scan(eval_mask: int) -> bool:
    if eval_mask & _NON_IMAGE_MASK:
        return False
    # parallel-imaging reference lines only count when also image lines
    if eval_mask & PATREFSCAN and not (eval_mask & PATREFANDIMASCAN):
        return False
    return True

# VB-era sMDH (128 bytes): the channel id lives inside the MDH and each
# channel repeats the full MDH — no separate 32-byte channel header.
_MDH_VB_FMT = "<IiIII II HH 28s 4s HH fI HH 8s 8s 28s HH"
# DMALength/flags, MeasUID, ScanCounter, TimeStamp, PMUTimeStamp,
# EvalInfoMask(2xu32), SamplesInScan, UsedChannels, LoopCounters(14xu16),
# CutOffData, CentreColumn, CoilSelect, ReadOutOffcentre, TimeSinceLastRF,
# CentreLine, CentrePartition, IceProgramPara(4xu16), FreePara(4xu16),
# SliceData(28), ChannelId, PTABPosNeg
_MDH_VB_SIZE = struct.calcsize(_MDH_VB_FMT)
assert _MDH_VB_SIZE == 128, _MDH_VB_SIZE


@dataclasses.dataclass
class TwixScan:
    line: int
    slice: int
    channel: int
    data: np.ndarray  # complex64 [samples]


@dataclasses.dataclass
class TwixMeasurement:
    meas_id: int
    protocol_name: str
    scan_datetime: str
    header_text: str
    scans: List[TwixScan]

    @property
    def n_channels(self) -> int:
        return len({s.channel for s in self.scans}) if self.scans else 0

    @property
    def header_params(self) -> Dict[str, Any]:
        """Acquisition parameters mined from the measurement header text —
        the reference roadmap's "get more header info (both TWIX and DICOM)
        into metadata" (reference README.md:25).  See parse_header_params."""
        return parse_header_params(self.header_text)

    def kspace(self) -> np.ndarray:
        """[columns, lines, slices] complex128 (squeezed single-channel),
        matching the reference's raw_K usage (Vent_Analysis.py:536-539).

        Multi-coil measurements raise — the reference's per-slice loop is
        only defined for single-channel data; use kspace_multicoil() +
        ventjax_torch.ops.fft_recon.recon_2d_multislice_rss instead.
        """
        if self.n_channels > 1:
            raise ValueError(
                f"measurement has {self.n_channels} receive channels; "
                "kspace() matches the reference's single-coil layout "
                "[Col, Lin, Sli] — use kspace_multicoil() and a coil "
                "combine (ventjax_torch.ops.fft_recon.recon_2d_multislice_rss)"
            )
        return self.kspace_multicoil()[0]

    def kspace_multicoil(self) -> np.ndarray:
        """[channels, columns, lines, slices] complex128."""
        if not self.scans:
            raise ValueError("measurement contains no image scans")
        chans = sorted({s.channel for s in self.scans})
        ch_index = {c: i for i, c in enumerate(chans)}
        n_col = self.scans[0].data.shape[0]
        n_lin = max(s.line for s in self.scans) + 1
        n_sli = max(s.slice for s in self.scans) + 1
        k = np.zeros((len(chans), n_col, n_lin, n_sli), np.complex128)
        for s in self.scans:
            k[ch_index[s.channel], :, s.line, s.slice] = s.data
        return k


def _parse_protocol(text: str) -> Tuple[str, str]:
    proto = ""
    stamp = ""
    m = re.search(r'tProtocolName\s*=\s*"+([^"]*)"+', text)
    if m:
        proto = m.group(1)
    m = re.search(r'PrepareTimestamp\s*[=:]\s*"?([0-9TZ:\- .]+)"?', text)
    if m:
        stamp = m.group(1).strip()
    return proto, stamp


def parse_header_params(text: str) -> Dict[str, Any]:
    """Acquisition parameters beyond protocol name / timestamp, mined from
    the measurement header the way mapvbvd's hdr.Meas / hdr.Dicom sections
    surface them (the reference only reads two fields,
    Vent_Analysis.py:533-534; its README.md:25 roadmap asks for more header
    info in metadata — this is that item for the TWIX side).

    Handles both ASCCONV-style ``name = value`` lines (``alTR[0] = 15000``)
    and XProtocol ``<ParamString."Name"> { "value" }`` entries.  TR/TE are
    converted from the header's microseconds to milliseconds so they are
    directly comparable to the DICOM RepetitionTime/EchoTime metadata keys.
    Missing fields are simply absent from the result.
    """
    out: Dict[str, Any] = {}

    def quoted(name: str, key: str) -> None:
        m = re.search(re.escape(name) + r'\s*=\s*"+([^"\n]*)"+', text)
        if m is None or not m.group(1):
            # XProtocol spelling drops the Siemens 't' type prefix
            m = re.search(
                r'<ParamString\."' + re.escape(name.removeprefix("t"))
                + r'">\s*\{\s*"([^"]*)"', text)
        if m and m.group(1):
            out[key] = m.group(1)

    def number(name: str, key: str, scale: float = 1.0) -> None:
        m = re.search(name + r'\s*=\s*([-+0-9.eE]+)', text)
        if m:
            try:
                out[key] = float(m.group(1)) * scale
            except ValueError:
                pass

    quoted(r'tSequenceFileName', "SequenceFileName")
    quoted(r'SoftwareVersions', "SoftwareVersions")
    number(r'alTR\[0\]', "RepetitionTime", 1e-3)   # us -> ms (DICOM units)
    number(r'alTE\[0\]', "EchoTime", 1e-3)         # us -> ms
    number(r'adFlipAngleDegree\[0\]', "FlipAngle")
    number(r'flNominalB0', "NominalB0")            # tesla
    number(r'lFrequency', "Frequency")             # Hz (129Xe @3T ~34.09MHz)
    return out


def _synthetic_header_text(protocol_name: str, scan_datetime: str,
                           header_params: Optional[Dict[str, Any]] = None,
                           ) -> str:
    """Header text for the synthetic writers: protocol + timestamp plus a
    realistic ASCCONV/XProtocol parameter block so round-trip tests exercise
    parse_header_params on every synthetic file."""
    p: Dict[str, Any] = {
        "SequenceFileName": "%SiemensSeq%\\fl_gre",
        "SoftwareVersions": "syngo MR E11",
        "TR_us": 15000,
        "TE_us": 675,
        "FlipAngle": 10.0,
        "NominalB0": 2.89362,
        "Frequency": 34091550,
    }
    if header_params:
        p.update(header_params)
    return (
        f'<XProtocol> tProtocolName = "{protocol_name}"\n'
        f'PrepareTimestamp = "{scan_datetime}"\n'
        f'<ParamString."SoftwareVersions"> {{ "{p["SoftwareVersions"]}" }}\n'
        "### ASCCONV BEGIN ###\n"
        f'tSequenceFileName = "{p["SequenceFileName"]}"\n'
        f'alTR[0] = {p["TR_us"]}\n'
        f'alTE[0] = {p["TE_us"]}\n'
        f'adFlipAngleDegree[0] = {p["FlipAngle"]}\n'
        f'sProtConsistencyInfo.flNominalB0 = {p["NominalB0"]}\n'
        f'sTXSPEC.asNucleusInfo[0].lFrequency = {p["Frequency"]}\n'
        "### ASCCONV END ###\n"
    )


def _read_twix_vb(buf: bytes) -> TwixMeasurement:
    """Parse a VB-era single-measurement .dat: u32 header length, protocol
    text, then 128-byte sMDH + sample blocks (one block per channel)."""
    hdr_len = struct.unpack_from("<I", buf, 0)[0]
    if not (4 <= hdr_len <= len(buf)):
        raise ValueError(f"not a twix file (VB header length {hdr_len})")
    header_text = buf[4:hdr_len].decode("latin-1", "replace")
    proto, stamp = _parse_protocol(header_text)

    pos = hdr_len
    scans: List[TwixScan] = []
    meas_id = 0
    while pos + _MDH_VB_SIZE <= len(buf):
        mdh_start = pos
        fields = struct.unpack_from(_MDH_VB_FMT, buf, pos)
        dma_len = fields[0] & _DMA_LEN_MASK
        meas_id = fields[1]
        eval_mask = fields[5]
        n_samples = fields[7]
        loop = struct.unpack("<14H", fields[9])
        line, slc = loop[0], loop[2]
        channel = fields[20]  # ChannelId (after the 28-byte SliceData)
        pos += _MDH_VB_SIZE
        if eval_mask & ACQEND:
            break
        if eval_mask & SYNCDATA:
            # == is a valid zero-payload packet (skip lands exactly here)
            if dma_len < _MDH_VB_SIZE or mdh_start + dma_len > len(buf):
                raise ValueError("malformed SYNCDATA packet (bad DMA length)")
            pos = mdh_start + dma_len
            continue
        raw = np.frombuffer(buf, np.complex64, n_samples, pos)
        pos += n_samples * 8
        if _is_image_scan(eval_mask):
            scans.append(TwixScan(line=line, slice=slc, channel=channel,
                                  data=raw.copy()))
    return TwixMeasurement(
        meas_id=meas_id,
        protocol_name=proto,
        scan_datetime=stamp,
        header_text=header_text,
        scans=scans,
    )


def read_twix(path: str) -> TwixMeasurement:
    """Parse a .dat file — VD/VE multi-raid or VB-era single measurement
    (returns the LAST measurement, the image scan by Siemens convention)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        raise ValueError("not a twix file (shorter than 8 bytes)")
    raid_id, n_meas = struct.unpack_from("<II", buf, 0)
    if not (raid_id < 10000 and 0 < n_meas <= 64):
        # mapvbvd's layout heuristic (secondInt <= 64 is multi-raid):
        # anything else is a VB header length.
        return _read_twix_vb(buf)
    entries = []
    off = 8
    for _ in range(n_meas):
        meas_id, file_id, meas_off, meas_len = struct.unpack_from(
            "<IIQQ", buf, off
        )
        pat = buf[off + 24: off + 88].split(b"\x00")[0].decode("latin-1")
        prot = buf[off + 88: off + 152].split(b"\x00")[0].decode("latin-1")
        entries.append((meas_id, meas_off, meas_len, pat, prot))
        off += 152

    meas_id, meas_off, meas_len, _, prot_name = entries[-1]
    hdr_len = struct.unpack_from("<I", buf, meas_off)[0]
    header_text = buf[meas_off + 4: meas_off + hdr_len].decode(
        "latin-1", "replace"
    )
    proto, stamp = _parse_protocol(header_text)

    pos = meas_off + hdr_len
    end = meas_off + meas_len
    scans: List[TwixScan] = []
    while pos + _MDH_SIZE <= end:
        mdh_start = pos
        fields = struct.unpack_from(_MDH_FMT, buf, pos)
        dma_len = fields[0] & _DMA_LEN_MASK
        eval_mask = fields[11]
        n_samples = fields[12]
        n_channels = fields[13]
        loop = struct.unpack("<14H", fields[14])
        line, slc = loop[0], loop[2]
        pos += _MDH_SIZE
        if eval_mask & ACQEND:
            break
        if eval_mask & SYNCDATA:
            # physio/sync packet: its payload is NOT channel blocks; the
            # MDH's DMA length (which includes the MDH itself) is the only
            # way to skip it without desyncing the parse
            # == is a valid zero-payload packet (skip lands exactly here)
            if dma_len < _MDH_SIZE or mdh_start + dma_len > end:
                raise ValueError("malformed SYNCDATA packet (bad DMA length)")
            pos = mdh_start + dma_len
            continue
        keep = _is_image_scan(eval_mask)
        for _c in range(n_channels):
            ch = struct.unpack_from(_CH_FMT, buf, pos)
            pos += _CH_SIZE
            raw = np.frombuffer(buf, np.complex64, n_samples, pos)
            pos += n_samples * 8
            if keep:  # noise-adjust / phasecor / feedback scans are parsed
                # (their payload IS channel blocks) but not image data
                scans.append(TwixScan(line=line, slice=slc, channel=ch[6],
                                      data=raw.copy()))
    return TwixMeasurement(
        meas_id=meas_id,
        protocol_name=proto or prot_name,
        scan_datetime=stamp,
        header_text=header_text,
        scans=scans,
    )


def write_synthetic_twix(
    path: str,
    kspace: np.ndarray,   # [columns, lines, slices] or [chan, col, lin, sli]
    protocol_name: str = "fl_gre_vent",
    scan_datetime: str = "2024-03-01 10:15:00",
    service_scans: bool = False,
    header_params: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a VD/VE-layout .dat file for tests (one measurement; single- or
    multi-channel depending on kspace rank).

    service_scans=True interleaves the packets real scanner files carry —
    a SYNCDATA physio block mid-measurement and noise-adjust + phasecor
    scans whose loop counters collide with image line 0 — so tests can
    prove the reader skips/filters them exactly like mapvbvd.
    """
    if kspace.ndim == 3:
        kspace = kspace[None]
    n_cha, n_col, n_lin, n_sli = kspace.shape
    protocol_name = protocol_name[:64]  # raid entry field is 64 bytes
    header_text = _synthetic_header_text(protocol_name, scan_datetime,
                                         header_params)
    hdr = header_text.encode("latin-1")
    body = bytearray()
    body += struct.pack("<I", 4 + len(hdr)) + hdr
    loop = bytearray(28)

    def mdh(dma, scan_ctr, eval_mask, n_samp, n_ch):
        return struct.pack(
            _MDH_FMT,
            dma, 1, scan_ctr, 0, 0, 0, 0, 0, 0, 0, 0, eval_mask, n_samp,
            n_ch, bytes(loop), 0, n_samp // 2, 0, 0.0, 0, n_lin // 2, 0,
            b"\x00" * 28, b"\x00" * 48, b"\x00" * 16,
        )

    def channel_blocks(values):
        blk = bytearray()
        for cha in range(n_cha):
            blk += struct.pack(_CH_FMT, 0, 1, 0, 0, 0, 0, cha, 0, 0)
            blk += np.ascontiguousarray(values, np.complex64).tobytes()
        return blk

    if service_scans:
        # noise-adjust scan: channel payload of junk at line 0 / slice 0 —
        # a reader that fails to filter overwrites real image data with it
        struct.pack_into("<14H", loop, 0, *([0] * 14))
        junk = np.full(n_col, 99.0 + 9.0j, np.complex64)
        body += mdh(0, 1, NOISEADJSCAN, n_col, n_cha) + channel_blocks(junk)
        body += mdh(0, 2, PHASCOR, n_col, n_cha) + channel_blocks(junk)
    for sli in range(n_sli):
        for lin in range(n_lin):
            if service_scans and sli == 0 and lin == 1:
                # SYNCDATA physio packet mid-measurement: payload is NOT
                # channel blocks; only its DMA length lets a reader skip it
                payload = b"\x07" * 100
                struct.pack_into("<14H", loop, 0, *([0] * 14))
                body += mdh(_MDH_SIZE + len(payload), 3, SYNCDATA, 0, 0)
                body += payload
            struct.pack_into("<14H", loop, 0, lin, 0, sli, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0)
            body += mdh(0, lin + 4, 0, n_col, n_cha)
            for cha in range(n_cha):
                body += struct.pack(_CH_FMT, 0, 1, lin + 1, 0, 0, 0, cha,
                                    0, 0)
                body += np.ascontiguousarray(
                    kspace[cha, :, lin, sli], np.complex64
                ).tobytes()
    # ACQEND
    struct.pack_into("<14H", loop, 0, *([0] * 14))
    body += mdh(0, 0, ACQEND, 0, 0)

    meas_off = 8 + 152  # raid header + one entry
    # pad measurement start to 512-byte alignment like real files
    pad = (-meas_off) % 512
    meas_off += pad
    out = bytearray()
    out += struct.pack("<II", 0, 1)
    entry = bytearray(152)
    struct.pack_into("<IIQQ", entry, 0, 1, 1, meas_off, len(body))
    entry[24:24 + 7] = b"PHANTOM"
    pname = protocol_name.encode("latin-1", "replace")[:64]
    entry[88:88 + len(pname)] = pname
    out += entry
    out += b"\x00" * pad
    out += body
    with open(path, "wb") as f:
        f.write(out)


def write_synthetic_twix_vb(
    path: str,
    kspace: np.ndarray,   # [columns, lines, slices] or [chan, col, lin, sli]
    protocol_name: str = "fl_gre_vent",
    scan_datetime: str = "2013-06-01 09:30:00",
    service_scans: bool = False,
    header_params: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a VB-era-layout .dat file for tests: u32 header length +
    protocol text, then one 128-byte sMDH + samples per (channel, line,
    slice), closed by an ACQEND MDH.

    service_scans=True interleaves the same packets as the VD writer — a
    SYNCDATA physio block mid-measurement plus noise-adjust and phasecor
    scans colliding with image line 0 — to prove the VB reader filters
    like mapvbvd does.
    """
    if kspace.ndim == 3:
        kspace = kspace[None]
    n_cha, n_col, n_lin, n_sli = kspace.shape
    header_text = _synthetic_header_text(protocol_name, scan_datetime,
                                         header_params)
    hdr = header_text.encode("latin-1")
    out = bytearray()
    out += struct.pack("<I", 4 + len(hdr)) + hdr
    loop = bytearray(28)

    def mdh(lin, sli, cha, n_samples, mask, dma=0):
        struct.pack_into("<14H", loop, 0, lin, 0, sli, 0, 0, 0, 0, 0, 0,
                         0, 0, 0, 0, 0)
        return struct.pack(
            _MDH_VB_FMT,
            dma, 7, lin + 1, 0, 0, mask, 0, n_samples, n_cha, bytes(loop),
            b"\x00" * 4, n_col // 2, 0, 0.0, 0, n_lin // 2, 0,
            b"\x00" * 8, b"\x00" * 8, b"\x00" * 28, cha, 0,
        )

    if service_scans:
        # junk payloads at image line 0 / slice 0: an unfiltering reader
        # would overwrite real image data with them
        junk = np.full(n_col, 99.0 + 9.0j, np.complex64).tobytes()
        for mask in (NOISEADJSCAN, PHASCOR):
            for cha in range(n_cha):
                out += mdh(0, 0, cha, n_col, mask) + junk
    for sli in range(n_sli):
        for lin in range(n_lin):
            if service_scans and sli == 0 and lin == 1:
                payload = b"\x07" * 60  # physio block: not sample data
                out += mdh(0, 0, 0, 0, SYNCDATA,
                           dma=_MDH_VB_SIZE + len(payload))
                out += payload
            for cha in range(n_cha):
                out += mdh(lin, sli, cha, n_col, 0)
                out += np.ascontiguousarray(
                    kspace[cha, :, lin, sli], np.complex64
                ).tobytes()
    out += mdh(0, 0, 0, 0, ACQEND)
    with open(path, "wb") as f:
        f.write(out)
