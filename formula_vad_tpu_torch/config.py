"""Configuration dataclasses for the TPU-native Formula-VAD framework.

Field names, defaults and derived quantities mirror the reference implementation
(the upstream Zig sources):

* ``VADMachineConfig``  — reference ``src/AudioPipeline/VADMachine.zig:30-51``
* ``VADConfig``         — reference ``src/AudioPipeline/VADPipeline.zig:20-26``
* ``PipelineConfig``    — reference ``src/AudioPipeline.zig:20-26``
* ``StatConfig``        — reference ``src/Evaluator/statistics.zig:77-83``
* ``SimConfig``         — reference ``src/simulator.zig:41-49``

Derived window lengths are computed with explicit float32 arithmetic followed by
truncation, because the reference computes them with ``f32`` multiplies and
``@intFromFloat`` (truncating) casts (``VADMachine.zig:82-85``); e.g.
``0.2`` is not exactly representable in f32 so ``48000 * 0.2 == 9600`` only
by virtue of f32 rounding, and ``46.875 * 180 == 8437.5`` truncates to 8437.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

import numpy as np


def f32(x) -> np.float32:
    return np.float32(x)


def f32_trunc_int(x) -> int:
    """Truncate a float32 value toward zero (Zig ``@intFromFloat``)."""
    return int(np.trunc(np.float32(x)))


# NSNet2 denoiser constants (reference src/NSNet2.zig:12-16).
NSNET2_N_FFT = 320
NSNET2_N_HOP = 160
NSNET2_N_BINS = NSNET2_N_FFT // 2 + 1  # 161
NSNET2_CHUNK_16K = 50 * NSNET2_N_HOP  # 8000 samples @16 kHz == 0.5 s
NSNET2_N_FRAMES = NSNET2_CHUNK_16K // NSNET2_N_HOP  # 50
NSNET2_CONTEXT_FRAMES = 4  # artifact_mitigation_window (NSNet2.zig:16)
NSNET2_MODEL_RATE = 16000


@dataclasses.dataclass(frozen=True)
class VADMachineConfig:
    """Speech state-machine configuration (VADMachine.zig:30-51)."""

    speech_min_freq: float = 500.0
    speech_max_freq: float = 2000.0
    long_term_speech_avg_sec: float = 180.0
    initial_long_term_avg: Optional[float] = 0.005
    short_term_speech_avg_sec: float = 0.2
    speech_threshold_factor: float = 10.0
    channel_vol_ratio_avg_sec: float = 0.5
    channel_vol_ratio_threshold: float = 0.5
    min_consecutive_sec_to_open: float = 0.2
    max_speech_gap_sec: float = 2.0
    min_vad_duration_sec: float = 0.7

    # ----- derived quantities (all mirror VADMachine.zig init/run) -----

    def eval_per_sec(self, sample_rate: int, fft_size: int) -> np.float32:
        return f32(f32(sample_rate) / f32(fft_size))

    def long_term_window(self, sample_rate: int, fft_size: int) -> int:
        n = f32_trunc_int(self.eval_per_sec(sample_rate, fft_size) * f32(self.long_term_speech_avg_sec))
        return max(1, n)

    def short_term_window(self, sample_rate: int, fft_size: int) -> int:
        n = f32_trunc_int(self.eval_per_sec(sample_rate, fft_size) * f32(self.short_term_speech_avg_sec))
        return max(1, n)

    def channel_ratio_window(self, sample_rate: int, fft_size: int) -> int:
        # Note: the reference does NOT clamp this one to >= 1 (VADMachine.zig:101-106
        # passes it straight through); with default configs it is 23.
        return f32_trunc_int(self.eval_per_sec(sample_rate, fft_size) * f32(self.channel_vol_ratio_avg_sec))

    def min_consecutive_samples_to_open(self, sample_rate: int) -> int:
        return f32_trunc_int(f32(sample_rate) * f32(self.min_consecutive_sec_to_open))

    def max_gap_samples(self, sample_rate: int) -> int:
        return f32_trunc_int(f32(sample_rate) * f32(self.max_speech_gap_sec))

    def recording_margin_samples(self, sample_rate: int) -> int:
        # getOffsetRecordingStart/End add 2 s of margin (VADMachine.zig:312-325).
        return f32_trunc_int(f32(sample_rate) * f32(2.0))


@dataclasses.dataclass(frozen=True)
class VADConfig:
    """VAD pipeline configuration (VADPipeline.zig:20-26)."""

    fft_size: int = 1024
    vad_machine_config: VADMachineConfig = dataclasses.field(default_factory=VADMachineConfig)
    alt_vad_machine_configs: Optional[Sequence[VADMachineConfig]] = None
    denoiser_model_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level audio pipeline configuration (AudioPipeline.zig:20-26)."""

    sample_rate: int = 48000
    n_channels: int = 2
    buffer_length: Optional[int] = None  # default: sample_rate * 10 (AudioPipeline.zig:46)
    vad_config: VADConfig = dataclasses.field(default_factory=VADConfig)
    skip_processing: bool = False

    @property
    def resolved_buffer_length(self) -> int:
        return self.buffer_length if self.buffer_length is not None else self.sample_rate * 10

    @property
    def denoiser_chunk_size(self) -> int:
        """Input samples per NSNet2 chunk at the pipeline rate (NSNet2.zig:157-159)."""
        if self.sample_rate % NSNET2_MODEL_RATE != 0:
            raise ValueError("sample rate must be divisible by 16000 (resample.zig:4-7)")
        return NSNET2_CHUNK_16K * (self.sample_rate // NSNET2_MODEL_RATE)


@dataclasses.dataclass(frozen=True)
class StatConfig:
    """Evaluation scoring configuration (statistics.zig:77-83)."""

    ignore_shorter_than_sec: float = 0.0
    extrude_start: float = 0.0
    extrude_end: float = 0.0
    fill_gaps: float = 0.0


# Scoring configuration used by the reference simulator (simulator.zig:127-133).
SIMULATOR_STAT_CONFIG = StatConfig(
    ignore_shorter_than_sec=VADMachineConfig().min_vad_duration_sec,
    extrude_start=5.0,
    extrude_end=10.0,
    fill_gaps=5.0,
)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation/batch-run configuration (simulator.zig:41-49)."""

    vad_config: VADConfig = dataclasses.field(default_factory=VADConfig)
    output_dir: Optional[str] = None
    preload_audio: bool = False
    audio_read_frame_count: int = 48000
    # TPU-native extensions (not present in the reference):
    batch_streams: bool = True  # batch all plan instances into one device batch
    # Clip format: "ogg" = Ogg Vorbis VBR q1.0 like the reference simulator
    # (SimulationInstance.zig:62, via the system codec — io_/ogg.py); falls
    # back to float32 WAV when the codec is unavailable. Also: "wav".
    recording_format: str = "ogg"
    # None = auto: use the constant-memory slab runner when the padded batch
    # would exceed ~2 GB on device (hour-long race corpora); True/False force.
    use_slabs: Optional[bool] = None
    slab_chunks: int = 128  # 64 s slabs (must be a multiple of 32)


# ---------------------------------------------------------------------------
# JSON (de)serialization — the reference parses plan JSON directly into config
# structs with defaultable fields (simulator.zig:67-76).
# ---------------------------------------------------------------------------


def _dataclass_from_dict(cls, data: dict):
    if not isinstance(data, dict):
        raise TypeError(f"expected object for {cls.__name__}, got {type(data)}")
    kwargs: dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            continue  # ignore_unknown_fields=true in the reference (simulator.zig:150)
        f = fields[key]
        if f.name == "vad_machine_config" and value is not None:
            value = _dataclass_from_dict(VADMachineConfig, value)
        elif f.name == "alt_vad_machine_configs" and value is not None:
            value = tuple(_dataclass_from_dict(VADMachineConfig, v) for v in value)
        elif f.name == "vad_config" and value is not None:
            value = _dataclass_from_dict(VADConfig, value)
        kwargs[f.name] = value
    return cls(**kwargs)


def vad_config_from_dict(data: dict) -> VADConfig:
    return _dataclass_from_dict(VADConfig, data)


def sim_config_from_dict(data: dict) -> SimConfig:
    return _dataclass_from_dict(SimConfig, data)


def sim_config_from_json(text: str) -> SimConfig:
    return sim_config_from_dict(json.loads(text))
