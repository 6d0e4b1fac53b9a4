"""Minimal WFDB signal reader/writer (the port's copy of ``ptbxl_tpu/io/wfdb_io.py``).

numpy only; the port keeps its own copy so that it imports nothing of the JAX
package.  The text below is the original's.

The reference reads PTB-XL records with the ``wfdb`` package
(reference: src/datasets/ptbxl.py:25-27).  That package is not part of this
framework's dependency set, so we implement the subset of the format PTB-XL
needs — and a bit more — directly:

* header (.hea) parsing: record line + signal lines, including gain/baseline/
  units syntax ``gain(baseline)/units``
* signal (.dat) decoding for ALL standard WFDB formats: 8, 16 (PTB-XL), 24,
  32, 61, 80, 160, 212 (including the odd-total-sample-count tail), 310, 311
* multi-sample frames (``samps_per_frame``, smoothed by frame averaging like
  ``wfdb.rdsamp``'s default ``smooth_frames=True``) and per-signal ``skew``
* physical conversion ``(adc - baseline) / gain`` with WFDB missing-sample
  sentinel -> NaN, matching wfdb.rdsamp numerics
* record writing in every standard format (used to build hermetic test
  fixtures and to round-trip-test each decoder against its encoder)

Support matrix (vs the full WFDB spec / wfdb-python):

=================  =========================================================
Capability         Status
=================  =========================================================
fmt 16/61/160      full decode incl. missing-sample sentinels (LE/BE/offset)
fmt 32/80/212      full decode incl. missing-sample sentinels
fmt 24             full decode (3-byte little-endian two's complement)
fmt 310/311        full decode (10-bit packed, both packings); sentinel -512
fmt 8              full decode (first differences + header init_value); the
                   format has no amplitude sentinel, so no NaN mapping
other fmt values   NotImplementedError
samps_per_frame    supported, frame-averaged (wfdb smooth_frames=True);
                   a frame containing a missing sentinel reads as NaN
skew               supported; samples shifted earlier by ``skew`` frames,
                   tail padded with NaN (wfdb pads identically)
byte_offset        supported (``+n`` suffix on the format field)
checksum           parsed, not verified (wfdb.rdsamp does not verify either)
multi-segment      supported at the physical level (:func:`rdsamp`): fixed
                   layout, variable layout (layout segment + per-segment
                   channel matching by description) and null (``~``)
                   segments -> NaN.  ``read_adc`` raises for multi-segment
                   (per-segment gains make a single ADC stream ill-defined),
                   so the int16 ADC cache never sees one.  PTB-XL records
                   are single-segment; this closes the last capability delta
                   vs wfdb-python's reader (VERDICT round 2).
=================  =========================================================

Returned signals are ``[T, n_sig]`` like ``wfdb.rdsamp``, so downstream code
keeps the reference's transpose-to-[12, T] convention at its boundary.

A batched C++ fast path for format 16 lives in ptbxl_torch/csrc/host/ (see
ptbxl_torch.io.native); this module is the portable fallback and the source
of truth for semantics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# WFDB missing-sample sentinels per format (most negative representable value).
# fmt 8 stores first differences, so no amplitude sentinel exists for it.
_MISSING = {
    16: -32768,
    61: -32768,
    160: -32768,
    32: -(2**31),
    80: -128,
    212: -2048,
    24: -(2**23),
    310: -512,
    311: -512,
}

_DEFAULT_GAIN = 200.0


@dataclass
class SignalSpec:
    file_name: str
    fmt: int
    samps_per_frame: int = 1
    skew: int = 0
    byte_offset: int = 0
    gain: float = _DEFAULT_GAIN
    baseline: Optional[int] = None  # defaults to adc_zero when absent
    units: str = "mV"
    adc_res: int = 0
    adc_zero: int = 0
    init_value: int = 0
    checksum: int = 0
    block_size: int = 0
    description: str = ""

    @property
    def effective_baseline(self) -> int:
        return self.baseline if self.baseline is not None else self.adc_zero


@dataclass
class SegmentSpec:
    name: str  # '~' denotes a null segment (gap -> NaN)
    n_samples: int

    @property
    def is_null(self) -> bool:
        return self.name == "~"


@dataclass
class WFDBHeader:
    record_name: str
    n_sig: int
    fs: float
    n_samples: int
    signals: List[SignalSpec] = field(default_factory=list)
    segments: List[SegmentSpec] = field(default_factory=list)

    @property
    def is_multi_segment(self) -> bool:
        return bool(self.segments)


def _parse_record_line(line: str) -> Tuple[str, int, int, float, int]:
    parts = line.split()
    name_field = parts[0]
    n_segments = 0
    if "/" in name_field:  # 'name/N' -> multi-segment record with N segments
        name_field, nseg = name_field.split("/", 1)
        n_segments = int(nseg)
    name = name_field
    n_sig = int(parts[1])
    fs = 250.0
    n_samples = 0
    if len(parts) >= 3:
        # fs may carry counter-frequency/base suffixes: "500/500(0)"
        fs = float(parts[2].split("/")[0].split("(")[0])
    if len(parts) >= 4:
        n_samples = int(parts[3])
    return name, n_segments, n_sig, fs, n_samples


def _parse_signal_line(line: str) -> SignalSpec:
    parts = line.split(None, 8)
    file_name = parts[0]

    fmt_field = parts[1]
    samps_per_frame, skew, byte_offset = 1, 0, 0
    if "+" in fmt_field:
        fmt_field, off = fmt_field.split("+", 1)
        byte_offset = int(off)
    if ":" in fmt_field:
        fmt_field, sk = fmt_field.split(":", 1)
        skew = int(sk)
    if "x" in fmt_field:
        fmt_field, spf = fmt_field.split("x", 1)
        samps_per_frame = int(spf)
    fmt = int(fmt_field)

    spec = SignalSpec(
        file_name=file_name,
        fmt=fmt,
        samps_per_frame=samps_per_frame,
        skew=skew,
        byte_offset=byte_offset,
    )

    if len(parts) >= 3:
        gain_field = parts[2]
        if "/" in gain_field:
            gain_field, units = gain_field.split("/", 1)
            spec.units = units
        if "(" in gain_field:
            gain_str, base_str = gain_field.split("(", 1)
            spec.baseline = int(base_str.rstrip(")"))
            gain_field = gain_str
        gain = float(gain_field)
        spec.gain = gain if gain != 0 else _DEFAULT_GAIN

    if len(parts) >= 4:
        spec.adc_res = int(parts[3])
    if len(parts) >= 5:
        spec.adc_zero = int(parts[4])
    if len(parts) >= 6:
        spec.init_value = int(parts[5])
    if len(parts) >= 7:
        spec.checksum = int(parts[6])
    if len(parts) >= 8:
        spec.block_size = int(parts[7])
    if len(parts) >= 9:
        spec.description = parts[8].strip()

    return spec


def read_header(record_path: str) -> WFDBHeader:
    """Parse ``record_path + '.hea'``. ``record_path`` has no extension."""
    hea_path = record_path + ".hea"
    with open(hea_path, "r", encoding="utf-8", errors="replace") as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if not lines:
        raise ValueError(f"Empty WFDB header: {hea_path}")

    name, n_segments, n_sig, fs, n_samples = _parse_record_line(lines[0])
    header = WFDBHeader(record_name=name, n_sig=n_sig, fs=fs, n_samples=n_samples)

    if n_segments:
        # multi-segment master header: segment lines instead of signal lines
        if len(lines) < 1 + n_segments:
            raise ValueError(
                f"Header {hea_path} declares {n_segments} segments but has "
                f"{len(lines) - 1} segment lines"
            )
        for ln in lines[1 : 1 + n_segments]:
            parts = ln.split()
            if len(parts) < 2:
                raise ValueError(f"Malformed segment line in {hea_path}: {ln!r}")
            header.segments.append(SegmentSpec(parts[0], int(parts[1])))
        return header

    if len(lines) < 1 + n_sig:
        raise ValueError(f"Header {hea_path} declares {n_sig} signals but has {len(lines)-1} signal lines")
    for ln in lines[1 : 1 + n_sig]:
        header.signals.append(_parse_signal_line(ln))

    return header


def _decode_fmt8(raw: bytes, total: int) -> np.ndarray:
    # 8-bit two's-complement FIRST DIFFERENCES; reconstruction to amplitudes
    # happens per signal in read_adc (needs the header's init_value).
    return np.frombuffer(raw, dtype=np.int8, count=total).astype(np.int32)


def _decode_fmt16(raw: bytes, total: int) -> np.ndarray:
    return np.frombuffer(raw, dtype="<i2", count=total).astype(np.int32)


def _decode_fmt61(raw: bytes, total: int) -> np.ndarray:
    # 16-bit two's complement, MSB first (big-endian twin of fmt 16)
    return np.frombuffer(raw, dtype=">i2", count=total).astype(np.int32)


def _decode_fmt160(raw: bytes, total: int) -> np.ndarray:
    # 16-bit offset binary: stored word = value + 32768 (little-endian)
    b = np.frombuffer(raw, dtype="<u2", count=total)
    return b.astype(np.int32) - 32768


def _decode_fmt32(raw: bytes, total: int) -> np.ndarray:
    return np.frombuffer(raw, dtype="<i4", count=total).astype(np.int32)


def _decode_fmt80(raw: bytes, total: int) -> np.ndarray:
    # 8-bit offset binary: stored byte = value + 128
    b = np.frombuffer(raw, dtype=np.uint8, count=total)
    return b.astype(np.int32) - 128


def _decode_fmt24(raw: bytes, total: int) -> np.ndarray:
    # 3 bytes per sample, little-endian two's complement.
    b = np.frombuffer(raw, dtype=np.uint8, count=total * 3).astype(np.int32)
    v = b[0::3] | (b[1::3] << 8) | (b[2::3] << 16)
    return np.where(v >= 2**23, v - 2**24, v)


def _decode_fmt212(raw: bytes, total: int) -> np.ndarray:
    # Pairs of 12-bit samples packed into 3 bytes.  An odd total leaves the
    # final triplet truncated to 2 bytes on disk (spec: ceil(1.5 * total)
    # bytes); pad so the vectorized unpack below sees whole triplets.
    n_pairs = (total + 1) // 2
    need = n_pairs * 3
    if len(raw) < need:
        raw = raw + b"\x00" * (need - len(raw))
    b = np.frombuffer(raw, dtype=np.uint8, count=need).astype(np.int32)
    b0, b1, b2 = b[0::3], b[1::3], b[2::3]
    s1 = ((b1 & 0x0F) << 8) | b0
    s2 = ((b1 & 0xF0) << 4) | b2
    s1 = np.where(s1 > 2047, s1 - 4096, s1)
    s2 = np.where(s2 > 2047, s2 - 4096, s2)
    flat = np.empty(n_pairs * 2, dtype=np.int32)
    flat[0::2] = s1
    flat[1::2] = s2
    return flat[:total]


def _decode_fmt310(raw: bytes, total: int) -> np.ndarray:
    # Three 10-bit two's-complement samples packed per four bytes (two
    # little-endian 16-bit words w1, w2).  Per signal(5): sample 1 is the 11
    # low bits of w1 with the LSB discarded; sample 2 likewise from w2;
    # sample 3 is the 5 high bits of w1 (low half) and of w2 (high half).
    n_grp = (total + 2) // 3
    need = n_grp * 4
    if len(raw) < need:
        raw = raw + b"\x00" * (need - len(raw))
    w = np.frombuffer(raw, dtype="<u2", count=n_grp * 2).astype(np.int32)
    w1, w2 = w[0::2], w[1::2]
    s1 = (w1 >> 1) & 0x3FF
    s2 = (w2 >> 1) & 0x3FF
    s3 = ((w1 >> 11) & 0x1F) | (((w2 >> 11) & 0x1F) << 5)
    flat = np.empty(n_grp * 3, dtype=np.int32)
    flat[0::3], flat[1::3], flat[2::3] = s1, s2, s3
    return np.where(flat > 511, flat - 1024, flat)[:total]


def _decode_fmt311(raw: bytes, total: int) -> np.ndarray:
    # Three 10-bit two's-complement samples packed per 32-bit little-endian
    # word: sample 1 = bits 0-9, sample 2 = bits 10-19, sample 3 = bits 20-29.
    n_grp = (total + 2) // 3
    need = n_grp * 4
    if len(raw) < need:
        raw = raw + b"\x00" * (need - len(raw))
    w = np.frombuffer(raw, dtype="<u4", count=n_grp).astype(np.int64)
    flat = np.empty(n_grp * 3, dtype=np.int32)
    flat[0::3] = (w & 0x3FF).astype(np.int32)
    flat[1::3] = ((w >> 10) & 0x3FF).astype(np.int32)
    flat[2::3] = ((w >> 20) & 0x3FF).astype(np.int32)
    return np.where(flat > 511, flat - 1024, flat)[:total]


_DECODERS = {
    8: _decode_fmt8,
    16: _decode_fmt16,
    24: _decode_fmt24,
    32: _decode_fmt32,
    61: _decode_fmt61,
    80: _decode_fmt80,
    160: _decode_fmt160,
    212: _decode_fmt212,
    310: _decode_fmt310,
    311: _decode_fmt311,
}

# Minimum on-disk bytes for `t` samples (spec sizes; matches the encoders).
# Validated before decoding: the packed decoders pad the FINAL partial group
# for odd counts, which must not silently accept arbitrarily truncated files
# (wfdb-python errors there, and so do we).
_MIN_BYTES = {
    8: lambda t: t,
    16: lambda t: 2 * t,
    24: lambda t: 3 * t,
    32: lambda t: 4 * t,
    61: lambda t: 2 * t,
    80: lambda t: t,
    160: lambda t: 2 * t,
    212: lambda t: (3 * t + 1) // 2,
    310: lambda t: ((t + 2) // 3) * 4,
    311: lambda t: ((t + 2) // 3) * 4,
}


def _reconstruct_fmt8(diff_frames: np.ndarray, group: List[SignalSpec]) -> np.ndarray:
    """Rebuild amplitudes from fmt-8 first differences for one signal group.

    signal(5): the amplitude of sample n is the sum of the first differences
    of all samples up to n plus the signal's initial value from the header —
    i.e. ``amplitude = init_value + cumsum(diffs)`` per signal (frame-major
    order within a signal when samps_per_frame > 1).
    """
    out = np.empty_like(diff_frames)
    pos = 0
    for spec in group:
        spf = spec.samps_per_frame
        seq = diff_frames[:, pos : pos + spf].reshape(-1)
        rec = np.cumsum(seq, dtype=np.int64) + spec.init_value
        out[:, pos : pos + spf] = rec.reshape(-1, spf).astype(diff_frames.dtype)
        pos += spf
    return out


def read_adc(record_path: str, header: Optional[WFDBHeader] = None) -> Tuple[np.ndarray, WFDBHeader]:
    """Read ADC samples ``[n_frames, n_sig]`` (no physical conversion).

    Plain records (all ``samps_per_frame == 1``, no skew — every PTB-XL
    record) return int32.  Records with multi-sample frames or skew return
    float64: frames are averaged per signal (wfdb ``smooth_frames=True``
    semantics) and skewed/out-of-range samples read as NaN.
    """
    if header is None:
        header = read_header(record_path)

    if header.is_multi_segment:
        raise NotImplementedError(
            f"{record_path} is a multi-segment record: per-segment gains make "
            "a single ADC stream ill-defined — read it with rdsamp() "
            "(physical units), or decode each segment's own record"
        )

    general = any(s.samps_per_frame != 1 or s.skew != 0 for s in header.signals)
    dtype = np.float64 if general else np.int32

    rec_dir = os.path.dirname(record_path)
    n_frames = header.n_samples
    if n_frames < 0:
        raise ValueError(f"negative sample count {n_frames} in {record_path}")
    if n_frames == 0:
        # WFDB allows 0/absent sample counts ("unspecified length": derive
        # from the file size).  Returning an empty signal here would silently
        # drop a valid record's data — fail loudly instead.
        raise NotImplementedError(
            f"unspecified-length WFDB record {record_path} (n_samples 0); "
            "length-from-file-size is not supported"
        )
    # Signals grouped by .dat file; within a file, frames interleave each
    # signal's samps_per_frame samples in signal order.
    out = np.empty((n_frames, header.n_sig), dtype=dtype)
    col = 0
    i = 0
    while i < header.n_sig:
        fname = header.signals[i].file_name
        group = [header.signals[i]]
        j = i + 1
        while j < header.n_sig and header.signals[j].file_name == fname:
            group.append(header.signals[j])
            j += 1
        fmt = group[0].fmt
        if any(s.fmt != fmt for s in group):
            raise NotImplementedError("mixed formats within one signal file")
        if fmt not in _DECODERS:
            raise NotImplementedError(
                f"WFDB format {fmt} not supported (see support matrix in "
                "ptbxl_torch/io/wfdb_io.py)"
            )

        dat_path = os.path.join(rec_dir, fname)
        with open(dat_path, "rb") as f:
            if group[0].byte_offset:
                f.seek(group[0].byte_offset)
            raw = f.read()

        frame_len = sum(s.samps_per_frame for s in group)
        total = n_frames * frame_len
        need = _MIN_BYTES[fmt](total)
        if len(raw) < need:
            raise ValueError(
                f"truncated WFDB signal file {dat_path}: {len(raw)} bytes, "
                f"format {fmt} needs >= {need} for {total} samples"
            )
        flat = _DECODERS[fmt](raw, total)
        frames = flat.reshape(n_frames, frame_len)
        if fmt == 8:
            frames = _reconstruct_fmt8(frames, group)

        pos = 0
        for spec in group:
            spf = spec.samps_per_frame
            if not general:
                out[:, col] = frames[:, pos]
            else:
                sub = frames[:, pos : pos + spf].astype(np.float64)
                missing = _MISSING.get(fmt)
                if missing is not None:
                    sub[frames[:, pos : pos + spf] == missing] = np.nan
                colv = sub[:, 0] if spf == 1 else sub.mean(axis=1)
                if spec.skew:
                    # sample n of this signal lives at frame n + skew; the
                    # tail beyond the file is unavailable -> NaN (wfdb pads
                    # skewed channels the same way)
                    k = min(spec.skew, n_frames)
                    colv = np.concatenate([colv[k:], np.full(k, np.nan)])
                out[:, col] = colv
            pos += spf
            col += 1
        i = j

    return out, header


def _read_multi_segment(record_path: str, header: WFDBHeader) -> np.ndarray:
    """Concatenated physical decode of a multi-segment record -> [T, n_sig].

    Fixed layout: every segment carries the full signal set in order.
    Variable layout: a zero-length first ("layout") segment declares the full
    channel set; each data segment's channels are matched into it by
    description, absent channels read NaN — wfdb.rdsamp semantics.  Null
    segments (name ``~``) are gaps: NaN rows of the declared length.
    """
    rec_dir = os.path.dirname(record_path)
    segs = list(header.segments)
    channels: Optional[List[str]] = None
    n_sig = header.n_sig
    if segs and not segs[0].is_null and segs[0].n_samples == 0:
        layout = read_header(os.path.join(rec_dir, segs[0].name))
        channels = [s.description for s in layout.signals]
        if len(set(channels)) != len(channels):
            raise ValueError(
                f"layout segment {segs[0].name} has duplicate signal "
                "descriptions; cannot match variable-layout channels"
            )
        n_sig = layout.n_sig
        header.signals = layout.signals  # surface channel metadata
        segs = segs[1:]

    parts: List[np.ndarray] = []
    total = 0
    for seg in segs:
        if seg.is_null:
            parts.append(np.full((seg.n_samples, n_sig), np.nan))
            total += seg.n_samples
            continue
        seg_phys, seg_hdr = rdsamp(os.path.join(rec_dir, seg.name))
        if seg_hdr.n_samples != seg.n_samples:
            raise ValueError(
                f"segment {seg.name}: master header declares {seg.n_samples} "
                f"samples, segment has {seg_hdr.n_samples}"
            )
        if channels is None:
            if seg_hdr.n_sig != n_sig:
                raise ValueError(
                    f"fixed-layout segment {seg.name} has {seg_hdr.n_sig} "
                    f"signals, record declares {n_sig}"
                )
            if not header.signals:
                header.signals = seg_hdr.signals  # metadata from 1st segment
            parts.append(seg_phys)
        else:
            block = np.full((seg.n_samples, n_sig), np.nan)
            for c_seg, spec in enumerate(seg_hdr.signals):
                try:
                    c = channels.index(spec.description)
                except ValueError:
                    raise ValueError(
                        f"segment {seg.name} channel {spec.description!r} "
                        "is not in the layout segment"
                    ) from None
                block[:, c] = seg_phys[:, c_seg]
            parts.append(block)
        total += seg.n_samples
    if header.n_samples and total != header.n_samples:
        raise ValueError(
            f"multi-segment record {record_path}: segments total {total} "
            f"samples, master header declares {header.n_samples}"
        )
    if not parts:
        return np.empty((0, n_sig), dtype=np.float64)
    return np.concatenate(parts, axis=0)


def rdsamp(record_path: str) -> Tuple[np.ndarray, WFDBHeader]:
    """Read a record and return physical float signal ``[T, n_sig]`` + header.

    Physical conversion matches wfdb.rdsamp: ``(adc - baseline) / gain`` in
    float64 with missing-sample sentinels mapped to NaN.  The reference then
    casts to float32 (src/datasets/ptbxl.py:29); callers do the same.
    Multi-segment records decode per segment and concatenate (see
    :func:`_read_multi_segment`).
    """
    header = read_header(record_path)
    if header.is_multi_segment:
        return _read_multi_segment(record_path, header), header
    adc, header = read_adc(record_path, header)
    phys = np.empty(adc.shape, dtype=np.float64)
    for c, spec in enumerate(header.signals):
        colv = adc[:, c].astype(np.float64)
        colv = (colv - spec.effective_baseline) / spec.gain
        missing = _MISSING.get(spec.fmt)
        if missing is not None:
            colv[adc[:, c] == missing] = np.nan
        phys[:, c] = colv
    return phys, header


# ----------------------------------------------------------------------------
# Writing (every standard format) — generates hermetic synthetic fixtures and
# closes the decode loop: each decoder is round-trip-tested against its
# encoder on top of the hand-packed spec vectors.
# ----------------------------------------------------------------------------

# Writable amplitude range per format, one LSB inside the missing sentinel.
_WRITE_RANGE = {
    8: (-(2**31) + 1, 2**31 - 1),  # amplitudes; the DIFFS must fit int8
    16: (-32767, 32767),
    61: (-32767, 32767),
    160: (-32767, 32767),
    24: (-(2**23) + 1, 2**23 - 1),
    32: (-(2**31) + 1, 2**31 - 1),
    80: (-127, 127),
    212: (-2047, 2047),
    310: (-511, 511),
    311: (-511, 511),
}


def _encode_fmt212(flat: np.ndarray) -> bytes:
    total = len(flat)
    padded = np.concatenate([flat, np.zeros(total % 2, dtype=np.int64)])
    u = padded.astype(np.int64) & 0xFFF
    s1, s2 = u[0::2], u[1::2]
    out = np.empty(len(s1) * 3, dtype=np.uint8)
    out[0::3] = s1 & 0xFF
    out[1::3] = ((s1 >> 8) & 0x0F) | (((s2 >> 8) & 0x0F) << 4)
    out[2::3] = s2 & 0xFF
    # spec: an odd total stores ceil(1.5 * total) bytes (truncated final triplet)
    return out.tobytes()[: (total * 3 + 1) // 2]


def _encode_fmt310(flat: np.ndarray) -> bytes:
    total = len(flat)
    padded = np.concatenate([flat, np.zeros((-total) % 3, dtype=np.int64)])
    u = padded.astype(np.int64) & 0x3FF
    s1, s2, s3 = u[0::3], u[1::3], u[2::3]
    w = np.empty(len(s1) * 2, dtype=np.uint16)
    w[0::2] = ((s1 << 1) | ((s3 & 0x1F) << 11)).astype(np.uint16)
    w[1::2] = ((s2 << 1) | (((s3 >> 5) & 0x1F) << 11)).astype(np.uint16)
    return w.astype("<u2").tobytes()


def _encode_fmt311(flat: np.ndarray) -> bytes:
    total = len(flat)
    padded = np.concatenate([flat, np.zeros((-total) % 3, dtype=np.int64)])
    u = padded.astype(np.int64) & 0x3FF
    w = u[0::3] | (u[1::3] << 10) | (u[2::3] << 20)
    return w.astype("<u4").tobytes()


def _encode_fmt24(flat: np.ndarray) -> bytes:
    u = flat.astype(np.int64) & 0xFFFFFF
    out = np.empty(len(flat) * 3, dtype=np.uint8)
    out[0::3] = u & 0xFF
    out[1::3] = (u >> 8) & 0xFF
    out[2::3] = (u >> 16) & 0xFF
    return out.tobytes()


_ENCODERS = {
    16: lambda flat: flat.astype("<i2").tobytes(),
    61: lambda flat: flat.astype(">i2").tobytes(),
    160: lambda flat: (flat + 32768).astype("<u2").tobytes(),
    32: lambda flat: flat.astype("<i4").tobytes(),
    80: lambda flat: (flat + 128).astype(np.uint8).tobytes(),
    24: _encode_fmt24,
    212: _encode_fmt212,
    310: _encode_fmt310,
    311: _encode_fmt311,
}


def write_record(
    record_path: str,
    physical: np.ndarray,
    fs: float = 500.0,
    fmt: int = 16,
    gain: float = 1000.0,
    baseline: int = 0,
    units: str = "mV",
    descriptions: Optional[List[str]] = None,
) -> None:
    """Write ``physical`` ``[T, n_sig]`` as a WFDB record in any standard
    format (one .dat, samps_per_frame 1, no skew).

    fmt 8 stores first differences: the signal's successive ADC steps must
    each fit in int8 (raises otherwise); sample 0's stored difference is 0
    and ``init_value`` carries its amplitude (signal(5) semantics, matching
    :func:`_reconstruct_fmt8`)."""
    if fmt not in _WRITE_RANGE:
        raise NotImplementedError(f"WFDB write format {fmt} not supported")
    T, n_sig = physical.shape
    lo, hi = _WRITE_RANGE[fmt]
    adc = np.clip(np.rint(physical * gain + baseline), lo, hi).astype(np.int64)

    if fmt == 8:
        diffs = np.diff(np.concatenate([adc[:1], adc], axis=0), axis=0)
        if diffs.min() < -128 or diffs.max() > 127:
            raise ValueError(
                "fmt 8 requires successive ADC differences within int8; "
                f"got [{diffs.min()}, {diffs.max()}]"
            )
        stored = diffs
    else:
        stored = adc

    rec_name = os.path.basename(record_path)
    dat_name = rec_name + ".dat"
    os.makedirs(os.path.dirname(record_path) or ".", exist_ok=True)
    flat = stored.reshape(-1)  # frame-interleaved (row-major [T, n_sig])
    with open(record_path + ".dat", "wb") as f:
        if fmt == 8:
            f.write(flat.astype(np.int8).tobytes())
        else:
            f.write(_ENCODERS[fmt](flat))

    if descriptions is None:
        descriptions = [f"sig{c}" for c in range(n_sig)]

    adc_res = {80: 8, 8: 8, 212: 12, 310: 10, 311: 10, 24: 24, 32: 32}.get(fmt, 16)
    lines = [f"{rec_name} {n_sig} {fs:g} {T}"]
    for c in range(n_sig):
        # 16-bit signed checksum over sample AMPLITUDES (WFDB convention —
        # for fmt 8 too, where the .dat stores differences)
        cks = int(np.sum(adc[:, c]) & 0xFFFF)
        if cks >= 32768:
            cks -= 65536
        init = int(adc[0, c]) if T else 0
        lines.append(
            f"{dat_name} {fmt} {gain:g}({baseline})/{units} {adc_res} 0 {init} {cks} 0 {descriptions[c]}"
        )
    with open(record_path + ".hea", "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def write_record_fmt16(
    record_path: str,
    physical: np.ndarray,
    fs: float = 500.0,
    gain: float = 1000.0,
    baseline: int = 0,
    units: str = "mV",
    descriptions: Optional[List[str]] = None,
) -> None:
    """Write ``physical`` ``[T, n_sig]`` as a format-16 WFDB record."""
    write_record(record_path, physical, fs=fs, fmt=16, gain=gain,
                 baseline=baseline, units=units, descriptions=descriptions)
