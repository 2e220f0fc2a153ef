"""Sun/NeXT AU (.au / .snd) codec: streaming reader + test-grade writer.

The reference accepts any container libsndfile decodes — AU included
(``src/audio_utils/AudioFileStream.zig:22-83`` via ``sf_open``). AU is the
classic telephony container (G.711 µ-law was its default encoding), so a
radio-archive ingest pipeline plausibly meets it; round 5 closes it with
the same posture as ``aiff.py``/``caf.py``: a from-scratch pure-Python
codec, interface-identical to ``wav.WavStream``.

Format: big-endian header — magic ".snd", u32 data_offset (>= 24; the gap
holds an annotation), u32 data_size (0xFFFFFFFF = unknown/to-EOF), u32
encoding, u32 sample_rate, u32 channels — then interleaved frames.
Supported encodings: 1 = G.711 µ-law, 2/3/4/5 = 8/16/24/32-bit linear PCM
(big-endian), 6/7 = float32/float64 (big-endian), 27 = G.711 A-law.
Anything else (ADPCM variants …) fails with an actionable error naming
the encoding id.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import wav as _wav  # G.711 decode tables (bit-exact CCITT)

_ENC_NAMES = {
    1: "mulaw", 2: "pcm8", 3: "pcm16", 4: "pcm24", 5: "pcm32",
    6: "float32", 7: "float64", 27: "alaw",
}
_BPS = {1: 1, 2: 1, 3: 2, 4: 3, 5: 4, 6: 4, 7: 8, 27: 1}
_UNKNOWN_SIZE = 0xFFFFFFFF


def is_au_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == b".snd"
    except OSError:
        return False


class AuStream:
    """Streaming AU reader with planar float32 output — AudioFileStream.zig
    analogue (open/read/seek/close, interleaved->planar conversion)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            self._parse(path)
        except Exception:
            self._f.close()
            raise
        self._frame_pos = 0

    def _parse(self, path: str) -> None:
        head = self._f.read(24)
        if len(head) < 24 or head[:4] != b".snd":
            raise ValueError(f"not an AU (.snd) file: {path}")
        offset, size, enc, rate, channels = struct.unpack(">IIIII", head[4:])
        if enc not in _ENC_NAMES:
            raise ValueError(
                f"unsupported AU encoding {enc} in {path}: supported are "
                f"{sorted(_ENC_NAMES)} (linear PCM, float, G.711)"
            )
        if offset < 24 or channels == 0 or rate == 0:
            raise ValueError(
                f"malformed AU header: offset {offset}, {channels} ch, "
                f"rate {rate}"
            )
        file_size = os.fstat(self._f.fileno()).st_size
        if offset > file_size:
            raise ValueError(f"malformed AU header: offset {offset} exceeds file")
        avail = file_size - offset
        data = avail if size == _UNKNOWN_SIZE else min(size, avail)
        self._enc = enc
        self._bps = _BPS[enc]
        self._rate = int(rate)
        self._channels = int(channels)
        self._data_at = offset
        self._total = data // (self._bps * self._channels)

    @property
    def sample_rate(self) -> int:
        return self._rate

    @property
    def n_channels(self) -> int:
        return self._channels

    @property
    def n_frames(self) -> int:
        return self._total

    def duration_seconds(self) -> float:
        return self._total / self._rate

    def read(self, max_frames: int) -> np.ndarray:
        """Read up to max_frames; returns planar float32 [n_channels, frames]."""
        if self._f.closed:
            raise ValueError("stream is closed")
        n = min(max_frames, self._total - self._frame_pos)
        if n <= 0:
            return np.zeros((self._channels, 0), np.float32)
        fb = self._bps * self._channels
        self._f.seek(self._data_at + self._frame_pos * fb)
        raw = self._f.read(n * fb)
        n = len(raw) // fb  # tolerate short files
        raw = raw[: n * fb]
        enc = self._enc
        if enc == 1:
            data = _wav._MULAW_TABLE[np.frombuffer(raw, np.uint8)]
        elif enc == 27:
            data = _wav._ALAW_TABLE[np.frombuffer(raw, np.uint8)]
        elif enc == 2:  # 8-bit linear in AU is SIGNED (unlike WAV's u8)
            data = np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
        elif enc == 4:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            pad = np.zeros((b.shape[0], 1), np.uint8)
            ints = np.concatenate([pad, b[:, ::-1]], axis=1).view("<i4")
            data = (ints.reshape(-1) >> 8).astype(np.float32) / np.float32(1 << 23)
        elif enc in (3, 5):
            dt = ">i2" if enc == 3 else ">i4"
            bits = 16 if enc == 3 else 32
            ints = np.frombuffer(raw, dt)
            data = ints.astype(np.float32) / np.float32(1 << (bits - 1))
        else:  # 6 / 7: big-endian float
            data = np.frombuffer(raw, ">f4" if enc == 6 else ">f8").astype(
                np.float32
            )
        out = data.reshape(n, self._channels).T
        self._frame_pos += n
        return np.ascontiguousarray(out)

    def seek_to_sample(self, frame: int) -> None:
        if self._f.closed:
            raise ValueError("stream is closed")
        if frame < 0:
            raise ValueError(f"negative seek target {frame}")
        self._frame_pos = min(frame, self._total)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_au(path: str) -> tuple[np.ndarray, int]:
    """Read a whole file -> (planar float32 [n_channels, n_frames], rate)."""
    with AuStream(path) as s:
        return s.read(s.n_frames), s.sample_rate


def write_au(path: str, data: np.ndarray, sample_rate: int,
             fmt: str = "pcm16") -> None:
    """Test-grade AU writer. fmt: "pcm16" | "float32" (BE)."""
    data = np.asarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError("data must be [n_channels, n_frames]")
    inter = data.T.reshape(-1)
    if fmt == "pcm16":
        payload = np.clip(
            np.round(inter * 32768.0), -32768, 32767
        ).astype(">i2").tobytes()
        enc = 3
    elif fmt == "float32":
        payload = inter.astype(">f4").tobytes()
        enc = 6
    else:
        raise ValueError(f"unsupported AU write format {fmt!r}")
    with open(path, "wb") as f:
        f.write(b".snd" + struct.pack(
            ">IIIII", 24, len(payload), enc, int(sample_rate), data.shape[0]
        ))
        f.write(payload)
