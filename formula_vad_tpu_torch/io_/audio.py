"""AudioBuffer / AudioSource — in-memory and streaming audio containers.

Mirrors ``src/audio_utils/AudioBuffer.zig`` (deinterleaved PCM with a
``global_start_frame_number`` stamp) and ``src/audio_utils/AudioSource.zig``
(a stream|buffer union with uniform accessors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from . import aiff, au, caf, flac, ogg, wav


def sniff_container(path: str) -> str:
    """Container kind by file magic — the libsndfile-style format sniff the
    reference relies on (AudioFileStream.zig:22-83 via sf_open).

    Returns "wav" | "ogg" | "flac" | "aiff", or raises ValueError naming
    the magic and the supported set for anything else (the reference would
    accept whatever libsndfile decodes; here unsupported containers fail
    loudly and actionably instead of with a WAV-parser error)."""
    try:
        with open(path, "rb") as f:
            head = f.read(512)
    except OSError as e:
        raise ValueError(f"cannot read {path}: {e}") from e
    magic = head[:4]
    if magic == b"RIFF":
        return "wav"
    if head[:16] == wav.W64_RIFF:  # Sony Wave64: RIFF grammar, GUID ids
        return "wav"
    if magic == b"OggS":
        # Ogg is a container: streams whose first packet carries the
        # 0x7f"FLAC" mapping signature (at its exact RFC 3533 offset) go
        # to the FLAC codec, everything else to Vorbis.
        return "flac" if flac.ogg_first_packet_is_flac(head) else "ogg"
    if magic == b"fLaC":
        return "flac"
    if magic == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return "aiff"
    if magic == b"caff":
        return "caf"
    if magic == b".snd":
        return "au"
    raise ValueError(
        f"unsupported audio container (magic {magic!r}) in {path}: "
        "supported containers are WAV (RIFF), Wave64, Ogg Vorbis, FLAC, "
        "AIFF, CAF, and AU"
    )


@dataclasses.dataclass
class AudioBuffer:
    channel_pcm: np.ndarray  # [n_channels, n_frames] float32, planar
    sample_rate: int
    global_start_frame_number: Optional[int] = None

    @property
    def n_channels(self) -> int:
        return self.channel_pcm.shape[0]

    @property
    def length(self) -> int:
        return self.channel_pcm.shape[1]

    @property
    def duration_seconds(self) -> float:
        return self.length / self.sample_rate

    @classmethod
    def load_from_file(cls, path: str) -> "AudioBuffer":
        """Load WAV, Ogg Vorbis, FLAC or AIFF (sniffed by container magic,
        like libsndfile's format detection in the reference's
        loadFromFile)."""
        kind = sniff_container(path)
        if kind == "ogg":
            data, rate = ogg.read_ogg(path)
        elif kind == "flac":
            data, rate = flac.read_flac(path)
        elif kind == "aiff":
            data, rate = aiff.read_aiff(path)
        elif kind == "caf":
            data, rate = caf.read_caf(path)
        elif kind == "au":
            data, rate = au.read_au(path)
        else:
            data, rate = wav.read_wav(path)
        return cls(channel_pcm=data, sample_rate=rate)

    def save_to_file(self, path: str, fmt: str = "float32", quality: float = 1.0) -> None:
        """fmt: "float32"/"pcm16" WAV, or "ogg" for Ogg Vorbis VBR
        (AudioBuffer.zig:61-116 — Format.vorbis with VBR quality)."""
        if fmt == "ogg":
            ogg.write_ogg(path, self.channel_pcm, self.sample_rate, quality)
        else:
            wav.write_wav(path, self.channel_pcm, self.sample_rate, fmt)


class AudioSource:
    """stream | buffer union (AudioSource.zig:6-39)."""

    def __init__(self, source: Union[wav.WavStream, "ogg.OggStream", AudioBuffer]):
        self._source = source

    @classmethod
    def open_stream(cls, path: str) -> "AudioSource":
        kind = sniff_container(path)
        if kind == "ogg":
            return cls(ogg.OggStream(path))
        if kind == "flac":
            return cls(flac.FlacStream(path))
        if kind == "aiff":
            return cls(aiff.AiffStream(path))
        if kind == "caf":
            return cls(caf.CafStream(path))
        if kind == "au":
            return cls(au.AuStream(path))
        return cls(wav.WavStream(path))

    @classmethod
    def preload(cls, path: str) -> "AudioSource":
        return cls(AudioBuffer.load_from_file(path))

    @property
    def is_stream(self) -> bool:
        return not isinstance(self._source, AudioBuffer)

    @property
    def sample_rate(self) -> int:
        return self._source.sample_rate

    @property
    def n_channels(self) -> int:
        return self._source.n_channels

    def duration_seconds(self) -> float:
        if isinstance(self._source, AudioBuffer):
            return self._source.duration_seconds
        return self._source.duration_seconds()

    def read_all(self) -> np.ndarray:
        if isinstance(self._source, AudioBuffer):
            return self._source.channel_pcm
        return self._source.read(self._source.n_frames)

    def read(self, max_frames: int) -> np.ndarray:
        if isinstance(self._source, AudioBuffer):
            raise TypeError("preloaded source has no incremental read; use read_all")
        return self._source.read(max_frames)

    @property
    def n_frames(self) -> int:
        if isinstance(self._source, AudioBuffer):
            return self._source.length
        return self._source.n_frames

    def seek_to_sample(self, frame: int) -> None:
        if isinstance(self._source, AudioBuffer):
            raise TypeError("preloaded source has no seek")
        self._source.seek_to_sample(frame)

    @property
    def supports_raw16(self) -> bool:
        """True when the stream can serve raw planar int16 PCM (PCM16 WAV) —
        lets batch runners ship half the bytes to the device and dequantize
        there (wav.WavStream.read_raw16)."""
        return isinstance(self._source, wav.WavStream) and self._source.is_pcm16

    def read_raw16(self, max_frames: int) -> np.ndarray:
        if not self.supports_raw16:
            raise TypeError("source is not a PCM16 WAV stream")
        return self._source.read_raw16(max_frames)

    def close(self) -> None:
        if not isinstance(self._source, AudioBuffer):
            self._source.close()
