"""VAD statics and segment assembly (port of ``formula_vad_tpu/pipeline/vad.py``
:39-80, :181 and :336)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from ..config import VADConfig, VADMachineConfig
from ..ops import dft, windows
from . import fsm


class VADStatics(NamedTuple):
    sample_rate: int
    n_channels: int
    fft_size: int
    chunk_size: int  # denoiser chunk at the pipeline rate (24000 at 48 kHz)
    max_windows: int  # most complete FFT windows a chunk can finish
    min_bin: int  # speech band lower bin (inclusive)
    max_bin: int  # speech band upper bin (inclusive)
    norm_factor: float  # magnitude normalization (1/512 for the periodic Hann at 1024)
    downsample_rate: int
    fsm_shape: fsm.FSMShape
    fsm_params: fsm.FSMParams


def statics_from_config(
    vad_config: VADConfig, sample_rate: int = 48000, n_channels: int = 2
) -> VADStatics:
    if sample_rate != 48000:
        raise ValueError("only 48000 Hz input is supported")
    fft_size = vad_config.fft_size
    chunk = 24000
    cfg = vad_config.vad_machine_config
    w = windows.hann_periodic(fft_size)
    nf = float(windows.window_norm_factor(w) / np.float32(fft_size))
    shape, params = fsm.statics_from_config(cfg, sample_rate, fft_size)
    return VADStatics(
        sample_rate=sample_rate,
        n_channels=n_channels,
        fft_size=fft_size,
        chunk_size=chunk,
        max_windows=chunk // fft_size + 1,
        min_bin=dft.freq_to_bin(cfg.speech_min_freq, fft_size, sample_rate),
        max_bin=dft.freq_to_bin(cfg.speech_max_freq, fft_size, sample_rate),
        norm_factor=nf,
        downsample_rate=sample_rate // 16000,
        fsm_shape=shape,
        fsm_params=params,
    )


@functools.lru_cache(maxsize=None)
def hann(fft_size: int) -> np.ndarray:
    return windows.hann_periodic(fft_size)


def segments_from_outputs(st: VADStatics, windows_out: fsm.WindowOutput) -> list[dict]:
    """One stream's per-window FSM outputs (numpy or CPU tensors, [W]) ->
    speech segments with the reference's +/-2 s recording margins."""
    margin = VADMachineConfig().recording_margin_samples(st.sample_rate)
    valid = np.asarray(windows_out.seg_valid).reshape(-1)
    starts = np.asarray(windows_out.seg_start_win).reshape(-1)
    ends = np.asarray(windows_out.seg_end_win).reshape(-1)
    ratios = np.asarray(windows_out.seg_ratio).reshape(-1)
    mets = np.asarray(windows_out.seg_met_sec).reshape(-1)
    segs = []
    for i in np.nonzero(valid)[0]:
        s = int(starts[i]) * st.fft_size
        e = int(ends[i]) * st.fft_size
        segs.append(
            {
                "sample_from": max(0, s - margin),
                "sample_to": e + margin,
                "avg_channel_vol_ratio": float(ratios[i]),
                "vad_met_sec": float(mets[i]),
            }
        )
    return segs
