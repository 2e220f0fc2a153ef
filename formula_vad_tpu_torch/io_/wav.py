"""WAV codec: streaming reader and writer.

Host-side replacement for the reference's libsndfile usage
(``src/audio_utils/AudioFileStream.zig``, ``src/audio_utils/AudioBuffer.zig``).
Supports PCM 16/24/32-bit and IEEE float 32/64 WAV files, streaming decode
in arbitrary frame counts, seeking, and float-32 WAV writing (the reference
writes WAV-float in daemon mode, AudioBuffer.zig:61-116). The reference's
OGG/Vorbis libsndfile path is covered by the sibling ``ogg`` module (system
Xiph codec driven by ``native/fvadogg.cpp``).

A native C++ fast path (``native/fvadio.cpp``) is used automatically for
bulk sample conversion when the shared library has been built; the pure
numpy path is the fallback and the behavioral reference.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO, Optional

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _g711_mulaw_table() -> np.ndarray:
    """256-entry µ-law byte -> float32 decode table (ITU-T G.711; the
    CCITT reference ulaw2linear, vectorized). Radio archives commonly
    store telephony captures as WAVE_FORMAT_MULAW; the reference decodes
    them via libsndfile's sf_open (AudioFileStream.zig:22-83). Values are
    on the 16-bit scale (max magnitude 32124), normalized by 32768."""
    u = (~np.arange(256, dtype=np.int32)) & 0xFF
    t = ((u & 0x0F) << 3) + 0x84
    t = t << ((u & 0x70) >> 4)
    lin = np.where(u & 0x80, 0x84 - t, t - 0x84)
    return (lin / 32768.0).astype(np.float32)


def _g711_alaw_table() -> np.ndarray:
    """256-entry A-law byte -> float32 decode table (G.711 alaw2linear,
    vectorized; max magnitude 32256, normalized by 32768)."""
    a = np.arange(256, dtype=np.int32) ^ 0x55
    t = (a & 0x0F) << 4
    seg = (a & 0x70) >> 4
    t = np.where(seg == 0, t + 8, np.where(seg == 1, t + 0x108,
                 (t + 0x108) << np.maximum(seg - 1, 0)))
    lin = np.where(a & 0x80, t, -t)
    return (lin / 32768.0).astype(np.float32)


_MULAW_TABLE = _g711_mulaw_table()
_ALAW_TABLE = _g711_alaw_table()


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    n_channels: int
    n_frames: int
    bits_per_sample: int
    format_tag: int
    data_offset: int
    data_size: int


# Sony Wave64 (.w64): RIFF's chunk grammar with 16-byte GUID ids and
# 64-bit sizes — libsndfile decodes it via the same sf_open the reference
# relies on (AudioFileStream.zig:22-83). GUIDs are the fourcc + a fixed
# 12-byte suffix, and the spec uses TWO GUID families (libsndfile w64.c /
# ffmpeg w64.c constants): the file-level 'riff' marker lives in
# {66666972-912E-11CF-A5D6-28DB04C10000}, while wave/fmt/data chunk ids
# live in {xxxxxxxx-ACF3-11D3-8CD1-00C04F8EDB8A}. (An earlier revision
# reused the riff suffix for all four and thus rejected every real-world
# .w64 while accepting only its own test files — caught in review.)
_W64_RIFF_SUFFIX = bytes(
    [0x2E, 0x91, 0xCF, 0x11, 0xA5, 0xD6, 0x28, 0xDB, 0x04, 0xC1, 0x00, 0x00]
)
_W64_CHUNK_SUFFIX = bytes(
    [0xF3, 0xAC, 0xD3, 0x11, 0x8C, 0xD1, 0x00, 0xC0, 0x4F, 0x8E, 0xDB, 0x8A]
)
W64_RIFF = b"riff" + _W64_RIFF_SUFFIX
W64_WAVE = b"wave" + _W64_CHUNK_SUFFIX
W64_FMT = b"fmt " + _W64_CHUNK_SUFFIX
W64_DATA = b"data" + _W64_CHUNK_SUFFIX


def _parse_fmt_body(body: bytes) -> tuple:
    """Shared WAVEFORMATEX parse (identical bytes in RIFF and W64)."""
    if len(body) < 16:
        raise ValueError("malformed fmt chunk (truncated)")
    tag, n_ch, rate, _byte_rate, block_align, bits = struct.unpack(
        "<HHIIHH", body[:16]
    )
    if tag == WAVE_FORMAT_EXTENSIBLE:
        if len(body) < 26:
            raise ValueError("malformed EXTENSIBLE fmt chunk (truncated)")
        # SubFormat GUID: first two bytes are the real format tag
        tag = struct.unpack("<H", body[24:26])[0]
    return (tag, n_ch, rate, block_align, bits)


def _parse_header_w64(f: BinaryIO):
    """W64 chunk walk -> (fmt tuple, data_offset, data_size). Chunk sizes
    INCLUDE the 24-byte chunk header; chunks align to 8 bytes."""
    head = f.read(40)  # riff GUID + u64 size + wave GUID
    if len(head) < 40 or head[24:40] != W64_WAVE:
        raise ValueError("not a Wave64 (riff/wave GUID) file")
    file_size = f.seek(0, io.SEEK_END)
    f.seek(40)
    fmt = data_offset = data_size = None
    while True:
        hdr = f.read(24)
        if len(hdr) < 24:
            break
        guid, size = hdr[:16], struct.unpack("<Q", hdr[16:])[0]
        if size < 24:
            raise ValueError("malformed W64 chunk (size below header size)")
        if f.tell() - 24 + size > file_size + 7:
            # Corrupt u64 sizes reach 2^63+ and would otherwise become a
            # giant read (MemoryError) or a seek overflow (OSError) —
            # reject anything the file cannot physically contain.
            raise ValueError(
                f"malformed W64 chunk {guid[:4]!r}: size {size} exceeds file"
            )
        body_size = size - 24
        padded = (size + 7) & ~7
        if guid == W64_FMT:
            fmt = _parse_fmt_body(f.read(body_size))
            f.seek(padded - 24 - body_size, io.SEEK_CUR)
        elif guid == W64_DATA:
            data_offset = f.tell()
            data_size = body_size
            f.seek(padded - 24, io.SEEK_CUR)
        else:
            f.seek(padded - 24, io.SEEK_CUR)
    return fmt, data_offset, data_size


def _parse_header(f: BinaryIO) -> WavInfo:
    riff = f.read(12)
    if len(riff) >= 12 and riff[:4] == b"RIFF" and riff[8:12] == b"WAVE":
        fmt, data_offset, data_size = _parse_header_riff(f)
    elif riff[:12] == W64_RIFF[:12]:
        f.seek(0)
        fmt, data_offset, data_size = _parse_header_w64(f)
    else:
        raise ValueError("not a RIFF/WAVE or Wave64 file")
    if fmt is None or data_offset is None:
        raise ValueError("missing fmt or data chunk")
    return _validate_info(fmt, data_offset, data_size)


def _parse_header_riff(f: BinaryIO):
    """Classic RIFF chunk walk -> (fmt tuple, data_offset, data_size)."""
    fmt = data_offset = data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            fmt = _parse_fmt_body(f.read(size + (size & 1)))
        elif cid == b"data":
            data_offset = f.tell()
            data_size = size
            f.seek(size + (size & 1), io.SEEK_CUR)
        else:
            f.seek(size + (size & 1), io.SEEK_CUR)
    return fmt, data_offset, data_size


def _validate_info(fmt: tuple, data_offset: int, data_size: int) -> WavInfo:
    tag, n_ch, rate, block_align, bits = fmt
    if tag not in (WAVE_FORMAT_PCM, WAVE_FORMAT_IEEE_FLOAT,
                   WAVE_FORMAT_MULAW, WAVE_FORMAT_ALAW):
        raise ValueError(f"unsupported WAV format tag {tag:#x}")
    if tag == WAVE_FORMAT_IEEE_FLOAT and bits not in (32, 64):
        raise ValueError(f"unsupported float bit depth {bits}")
    if tag == WAVE_FORMAT_PCM and bits not in (8, 16, 24, 32):
        raise ValueError(f"unsupported PCM bit depth {bits}")
    if tag in (WAVE_FORMAT_MULAW, WAVE_FORMAT_ALAW) and bits != 8:
        raise ValueError(f"G.711 WAV must be 8 bits/sample, got {bits}")
    bytes_per_frame = n_ch * (bits // 8)
    if bytes_per_frame == 0 or rate == 0:
        raise ValueError(
            f"malformed fmt chunk: {n_ch} channels, {bits} bits, rate {rate}"
        )
    return WavInfo(
        sample_rate=rate,
        n_channels=n_ch,
        n_frames=data_size // bytes_per_frame,
        bits_per_sample=bits,
        format_tag=tag,
        data_offset=data_offset,
        data_size=data_size,
    )


def _decode_frames(raw: bytes, info: WavInfo) -> np.ndarray:
    """Decode interleaved raw bytes -> float32 [n_frames, n_channels]."""
    bits, tag, n_ch = info.bits_per_sample, info.format_tag, info.n_channels
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        dt = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
    elif tag == WAVE_FORMAT_MULAW:
        x = _MULAW_TABLE[np.frombuffer(raw, dtype=np.uint8)]
    elif tag == WAVE_FORMAT_ALAW:
        x = _ALAW_TABLE[np.frombuffer(raw, dtype=np.uint8)]
    elif bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / 8388608.0
    elif bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported bit depth {bits}")
    return x.reshape(-1, n_ch)


def _decode_planar(raw: bytes, info: WavInfo) -> np.ndarray:
    """Decode to planar [n_channels, n_frames]; native C++ fast path when
    the shared library is built (native/fvadio.cpp), numpy fallback."""
    from . import native

    out = native.decode_to_planar(
        raw, info.bits_per_sample, info.format_tag, info.n_channels
    )
    if out is not None:
        return out
    return np.ascontiguousarray(_decode_frames(raw, info).T)


class WavStream:
    """Streaming WAV reader with planar output — AudioFileStream.zig analogue
    (open/read/seek/close, interleaved->planar conversion :56-102)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            self.info = _parse_header(self._f)
        except Exception:
            self._f.close()
            raise
        self._f.seek(self.info.data_offset)
        self._frame_pos = 0

    @property
    def sample_rate(self) -> int:
        return self.info.sample_rate

    @property
    def n_channels(self) -> int:
        return self.info.n_channels

    @property
    def n_frames(self) -> int:
        return self.info.n_frames

    def duration_seconds(self) -> float:
        return self.info.n_frames / self.info.sample_rate

    def read(self, max_frames: int) -> np.ndarray:
        """Read up to max_frames; returns planar float32 [n_channels, frames]."""
        n = min(max_frames, self.info.n_frames - self._frame_pos)
        if n <= 0:
            return np.zeros((self.info.n_channels, 0), np.float32)
        bpf = self.info.n_channels * (self.info.bits_per_sample // 8)
        raw = self._f.read(n * bpf)
        n_read = len(raw) // bpf
        self._frame_pos += n_read
        return _decode_planar(raw[: n_read * bpf], self.info)

    @property
    def is_pcm16(self) -> bool:
        return (
            self.info.format_tag == WAVE_FORMAT_PCM
            and self.info.bits_per_sample == 16
        )

    def read_raw16(self, max_frames: int) -> np.ndarray:
        """Read up to max_frames as planar int16 (PCM16 files only).

        Skips the host-side int16->float32 conversion so callers can ship
        half the bytes to the device and dequantize there: f32(i) / 32768 on
        device is bit-identical to the host decode (a 16-bit integer and a
        power-of-two divide are both exact in f32)."""
        if not self.is_pcm16:
            raise ValueError("read_raw16 requires a PCM16 WAV")
        n = min(max_frames, self.info.n_frames - self._frame_pos)
        if n <= 0:
            return np.zeros((self.info.n_channels, 0), np.int16)
        bpf = self.info.n_channels * 2
        raw = self._f.read(n * bpf)
        n_read = len(raw) // bpf
        self._frame_pos += n_read
        x = np.frombuffer(raw[: n_read * bpf], dtype="<i2")
        return np.ascontiguousarray(x.reshape(-1, self.info.n_channels).T)

    def seek_to_sample(self, frame: int) -> None:
        bpf = self.info.n_channels * (self.info.bits_per_sample // 8)
        self._f.seek(self.info.data_offset + frame * bpf)
        self._frame_pos = frame

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a whole file -> (planar float32 [n_channels, n_frames], rate)."""
    with WavStream(path) as s:
        data = s.read(s.n_frames)
        return data, s.sample_rate


def write_wav(
    path: str,
    data: np.ndarray,
    sample_rate: int,
    fmt: str = "float32",
) -> None:
    """Write planar [n_channels, n_frames] audio as WAV.

    fmt: "float32" (reference daemon format) or "pcm16".
    """
    from . import native

    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None, :]
    n_ch, n_frames = data.shape
    if fmt == "float32":
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        inter = native.encode_f32_interleaved(data)
        if inter is None:
            inter = np.ascontiguousarray(data.T).reshape(-1)
        payload = np.asarray(inter, "<f4").tobytes()
    elif fmt == "pcm16":
        tag, bits = WAVE_FORMAT_PCM, 16
        inter16 = native.encode_pcm16_interleaved(data)
        if inter16 is None:
            inter16 = (
                np.round(np.clip(np.ascontiguousarray(data.T), -1.0, 1.0) * 32767.0)
            ).astype(np.int16).reshape(-1)
        payload = np.asarray(inter16, "<i2").tobytes()
    else:
        raise ValueError(f"unsupported write format {fmt}")
    byte_rate = sample_rate * n_ch * bits // 8
    block_align = n_ch * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, tag, n_ch, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
