"""Ogg Vorbis codec: streaming reader and VBR writer.

Covers the reference's OGG path: libsndfile decode of Ogg Vorbis inputs
(``src/audio_utils/AudioFileStream.zig``) and VBR-quality clip encoding
(``src/audio_utils/AudioBuffer.zig:61-116``; the simulator saves detected
speech as ``{start_frame}-{original|denoised}.ogg`` at quality 1.0,
``src/simulator/SimulationInstance.zig:37-68``).

The codec itself is the system Xiph stack (libvorbisfile/libvorbisenc/
libvorbis/libogg), driven by our native C++ runtime (``native/fvadogg.cpp``)
and bound here via ctypes — the same system-library posture the reference
takes with libsndfile. ``available()`` is False when the shared library
can't be built or the system codec is absent; clip WRITERS fall back to
WAV (apps/simulator._clip_writer), while readers raise RuntimeError —
which the daemon reports as a non-fatal decode error.

``quality`` follows the reference's knob: libsndfile's 0..1 VBR quality is
passed straight through to ``vorbis_encode_init_vbr`` (range -0.1..1.0).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfvadogg.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build(force: bool = False) -> bool:
    try:
        subprocess.run(
            ["make", "-s"] + (["-B"] if force else []) + ["libfvadogg.so"],
            cwd=_NATIVE_DIR,
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.isdir(_NATIVE_DIR):
            return None
        # Always run make: a no-op when the .so is fresh, a rebuild when
        # fvadogg.cpp changed. A load failure (e.g. a stale binary from
        # another platform) forces one clean rebuild before giving up.
        _build()
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            if not _build(force=True):
                return None
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                return None
        if lib.fvad_ogg_abi_version() != 1 or lib.fvad_ogg_available() != 1:
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.fvad_ogg_open.argtypes = [ctypes.c_char_p]
        lib.fvad_ogg_open.restype = ctypes.c_void_p
        lib.fvad_ogg_rate.argtypes = [ctypes.c_void_p]
        lib.fvad_ogg_rate.restype = ctypes.c_long
        lib.fvad_ogg_channels.argtypes = [ctypes.c_void_p]
        lib.fvad_ogg_total_frames.argtypes = [ctypes.c_void_p]
        lib.fvad_ogg_total_frames.restype = ctypes.c_longlong
        lib.fvad_ogg_read_planar.argtypes = [ctypes.c_void_p, f32p, ctypes.c_longlong]
        lib.fvad_ogg_read_planar.restype = ctypes.c_longlong
        lib.fvad_ogg_seek.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.fvad_ogg_close.argtypes = [ctypes.c_void_p]
        lib.fvad_ogg_encode_file.argtypes = [
            ctypes.c_char_p,
            f32p,
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.c_long,
            ctypes.c_float,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native driver built AND the system Vorbis libs load."""
    return _load() is not None


def is_ogg_file(path: str) -> bool:
    """Cheap container sniff: Ogg files start with the 'OggS' capture pattern."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"OggS"
    except OSError:
        return False


class OggStream:
    """Streaming Ogg Vorbis reader with planar output — the OGG side of
    AudioFileStream.zig (open/read/seek/close). Interface-identical to
    ``wav.WavStream``."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "Ogg Vorbis codec unavailable (system libvorbis not found)"
            )
        self._lib = lib
        self._h = lib.fvad_ogg_open(os.fsencode(path))
        if not self._h:
            raise ValueError(f"cannot open Ogg Vorbis file: {path}")
        self._rate = int(lib.fvad_ogg_rate(self._h))
        self._channels = int(lib.fvad_ogg_channels(self._h))
        self._total = int(lib.fvad_ogg_total_frames(self._h))
        if self._total < 0:  # ov_pcm_total error (e.g. unseekable source)
            self.close()
            raise ValueError(f"cannot determine Ogg stream length: {path}")
        self._frame_pos = 0

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
        if self._h is None:
            raise ValueError("stream is closed")
        if max_frames <= 0:
            return np.zeros((self._channels, 0), np.float32)
        out = np.empty((self._channels, max_frames), np.float32)
        got = int(self._lib.fvad_ogg_read_planar(self._h, out, max_frames))
        if got < 0:
            raise IOError(f"Ogg Vorbis decode error {got}")
        self._frame_pos += got
        return np.ascontiguousarray(out[:, :got])

    def seek_to_sample(self, frame: int) -> None:
        if self._h is None:
            raise ValueError("stream is closed")
        if self._lib.fvad_ogg_seek(self._h, frame) != 0:
            raise IOError(f"Ogg Vorbis seek to frame {frame} failed")
        self._frame_pos = frame

    def close(self) -> None:
        if self._h is not None:
            self._lib.fvad_ogg_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_ogg(path: str) -> tuple[np.ndarray, int]:
    """Read a whole file -> (planar float32 [n_channels, n_frames], rate)."""
    with OggStream(path) as s:
        data = s.read(s.n_frames)
        return data, s.sample_rate


def write_ogg(
    path: str,
    data: np.ndarray,
    sample_rate: int,
    quality: float = 1.0,
) -> None:
    """Write planar [n_channels, n_frames] audio as Ogg Vorbis VBR.

    quality: VBR base quality in [-0.1, 1.0]; 1.0 matches the reference
    simulator's clip encoding (SimulationInstance.zig:62 passes 1 through
    libsndfile's SFC_SET_VBR_ENCODING_QUALITY).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("Ogg Vorbis codec unavailable (system libvorbis not found)")
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None, :]
    n_ch, n_frames = data.shape
    rc = lib.fvad_ogg_encode_file(
        os.fsencode(path),
        np.ascontiguousarray(data),
        n_ch,
        n_frames,
        sample_rate,
        float(quality),
    )
    if rc != 0:
        raise IOError(f"Ogg Vorbis encode failed with code {rc}")
