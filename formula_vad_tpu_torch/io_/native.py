"""ctypes bindings for the native I/O runtime (native/fvadio.cpp).

Builds the shared library on first use if the toolchain is available;
falls back to pure numpy transparently (wav.py consults ``available()``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfvadio.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build(force: bool = False) -> bool:
    try:
        subprocess.run(
            ["make", "-s"] + (["-B"] if force else []) + ["libfvadio.so"],
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
        # Always run make (no-op when fresh, rebuild when fvadio.cpp
        # changed); force one clean rebuild if a stale binary fails to load.
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
        if lib.fvad_abi_version() != 1:
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.fvad_decode_pcm16.argtypes = [i16p, f32p, ctypes.c_int64, ctypes.c_int32]
        lib.fvad_decode_pcm24.argtypes = [u8p, f32p, ctypes.c_int64, ctypes.c_int32]
        lib.fvad_decode_pcm32.argtypes = [i32p, f32p, ctypes.c_int64, ctypes.c_int32]
        lib.fvad_deinterleave_f32.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int32]
        lib.fvad_encode_f32.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int32]
        lib.fvad_encode_pcm16.argtypes = [f32p, i16p, ctypes.c_int64, ctypes.c_int32]
        lib.fvad_rms_per_channel.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_to_planar(raw: bytes, bits: int, fmt_tag: int, n_channels: int) -> np.ndarray | None:
    """Decode interleaved raw WAV payload -> planar float32 [C, frames].
    Returns None if the native library is unavailable or format unsupported."""
    lib = _load()
    if lib is None:
        return None
    bpf = n_channels * (bits // 8)
    n_frames = len(raw) // bpf
    out = np.empty((n_channels, n_frames), np.float32)
    if fmt_tag == 3 and bits == 32:  # IEEE float
        src = np.frombuffer(raw, np.float32)
        lib.fvad_deinterleave_f32(np.ascontiguousarray(src), out, n_frames, n_channels)
    elif fmt_tag == 1 and bits == 16:
        src = np.frombuffer(raw, np.int16)
        lib.fvad_decode_pcm16(np.ascontiguousarray(src), out, n_frames, n_channels)
    elif fmt_tag == 1 and bits == 24:
        src = np.frombuffer(raw, np.uint8)
        lib.fvad_decode_pcm24(np.ascontiguousarray(src), out, n_frames, n_channels)
    elif fmt_tag == 1 and bits == 32:
        src = np.frombuffer(raw, np.int32)
        lib.fvad_decode_pcm32(np.ascontiguousarray(src), out, n_frames, n_channels)
    else:
        return None
    return out


def encode_f32_interleaved(planar: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    n_channels, n_frames = planar.shape
    out = np.empty((n_frames * n_channels,), np.float32)
    lib.fvad_encode_f32(np.ascontiguousarray(planar, np.float32), out, n_frames, n_channels)
    return out


def encode_pcm16_interleaved(planar: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    n_channels, n_frames = planar.shape
    out = np.empty((n_frames * n_channels,), np.int16)
    lib.fvad_encode_pcm16(np.ascontiguousarray(planar, np.float32), out, n_frames, n_channels)
    return out


def rms_per_channel(planar: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    n_channels, n_frames = planar.shape
    out = np.empty((n_channels,), np.float32)
    lib.fvad_rms_per_channel(np.ascontiguousarray(planar, np.float32), out, n_frames, n_channels)
    return out
