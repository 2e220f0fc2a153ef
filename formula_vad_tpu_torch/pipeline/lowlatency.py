"""Low-latency online denoising: 10 ms hops with a carried GRU state (port
of ``formula_vad_tpu/pipeline/lowlatency.py``, BASELINE.json config 4).

The chunk path reproduces the reference's stateless 0.5 s ONNX runs; this
mode runs the GRUs as one continuous recurrence with an explicit state, so
the algorithmic latency is one 10 ms hop plus the 10 ms overlap-add
lookahead instead of 500 ms, at the same cost a sample.

State: the GRU's ``(h1, h2)``, the 160-sample input tail, the 160-sample
OLA output tail and the upsampler's last sample, under the JAX package's
keys (``gru``, ``in_tail``, ``out_tail``, ``last_sample``). ``step`` takes
one hop of every stream; ``run`` takes a whole [..., T] and computes the
same function in one pass: all hops framed at once behind ``in_tail``, one
``NSNet2.forward_streaming`` over the hops (one launch of the tier's
recurrence, kernel 1, 5 or 6, from the given state), one inverse, the
overlap-add against ``out_tail`` and one upsample from ``last_sample``.
Under the int8 tier the recurrence's three in-step products run once a
hop (``models/nsnet2_q8.py``), as in its chunk path. The outputs of ``run``
and of a chain of ``step`` calls agree to float32 rounding (their products
see other batch shapes); both return the same final state. The mode runs
NSNet2 only, as the JAX one does: a weights-free gain model such as the
spectral gate has no state to carry, and ``step`` and ``run`` refuse it
with a ``ValueError``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as device_mod
from ..config import NSNET2_N_FFT, NSNET2_N_HOP
from ..models import nsnet2
from ..ops import dft, resample, stft
from . import denoiser as den_mod

# The synthesis window with kissfft's 1/n_fft folded in, as the JAX step
# multiplies it (float32).
_SYNTHESIS = den_mod.WINDOW * np.float32(1.0 / NSNET2_N_FFT)


@functools.lru_cache(maxsize=None)
def _synthesis(device: torch.device) -> torch.Tensor:
    """The synthesis window on ``device``, uploaded once: a step's pageable
    copy would wait for the card mid-step."""
    return torch.from_numpy(_SYNTHESIS).to(device)


def init_state(batch_shape: tuple = (), device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    """Zero state for streams of leading shape ``batch_shape`` (e.g. (B, C)),
    on the card unless the caller asks for the CPU."""
    dev = device if isinstance(device, torch.device) else device_mod.resolve(device)
    lead = tuple(batch_shape)
    return {
        "gru": nsnet2.zero_state(lead, dev, dtype),
        "in_tail": torch.zeros(lead + (NSNET2_N_HOP,), dtype=dtype, device=dev),
        "out_tail": torch.zeros(lead + (NSNET2_N_HOP,), dtype=dtype, device=dev),
        "last_sample": torch.zeros(lead, dtype=dtype, device=dev),
    }


def _denoise(net, state: dict, ds: torch.Tensor, downsample_rate: int) -> tuple[dict, torch.Tensor]:
    """The 16 kHz samples ``ds`` [..., n * 160] of n hops -> (new state,
    denoised [..., n * 160 * downsample_rate])."""
    lead = ds.shape[:-1]
    n = ds.shape[-1] // NSNET2_N_HOP
    full = torch.cat([state["in_tail"].to(ds.dtype), ds], dim=-1)  # [..., (n + 1) * 160]
    re, im = stft.stft_frames(stft.frame_signal(full, NSNET2_N_FFT, NSNET2_N_HOP), den_mod.WINDOW, NSNET2_N_FFT)
    feats = den_mod.compute_features(re, im)  # [..., n, 161]
    gru_state, gains = net.forward_streaming(state["gru"], feats)
    g = torch.clamp(gains, den_mod.GAIN_MIN, den_mod.GAIN_MAX)
    frames = dft.irdft_kiss(re * g, im * g, NSNET2_N_FFT)
    frames = frames * _synthesis(frames.device)  # [..., n, 320]
    # Hop i completes the previous frame's second half with its first half.
    tails = torch.cat([state["out_tail"][..., None, :].to(frames.dtype), frames[..., :-1, NSNET2_N_HOP:]], dim=-2)
    completed = (tails + frames[..., :NSNET2_N_HOP]).reshape(lead + (n * NSNET2_N_HOP,))
    up, new_last = resample.upsample(completed, state["last_sample"], downsample_rate)
    sdt = state["out_tail"].dtype
    new_state = {
        "gru": gru_state,
        "in_tail": ds[..., -NSNET2_N_HOP:].to(state["in_tail"].dtype, copy=True),
        "out_tail": frames[..., -1, NSNET2_N_HOP:].to(sdt, copy=True),
        "last_sample": new_last.to(sdt, copy=True),
    }
    return new_state, up


def _require_nsnet2(net) -> None:
    if not isinstance(net, nsnet2.NSNet2):
        raise ValueError(f"the low-latency mode carries NSNet2's GRU state; {type(net).__name__} has none")


def step(net, state: dict, hop48: torch.Tensor, downsample_rate: int = 3) -> tuple[dict, torch.Tensor]:
    """One 10 ms hop ``hop48`` [..., 480] of every stream -> (new state,
    denoised [..., 480]), one hop behind the input (the OLA tail), as the
    chunk path."""
    if hop48.shape[-1] != NSNET2_N_HOP * downsample_rate:
        raise ValueError(f"a hop of {hop48.shape[-1]} samples, expected {NSNET2_N_HOP * downsample_rate}")
    _require_nsnet2(net)
    return _denoise(net, state, resample.downsample(hop48, downsample_rate), downsample_rate)


def run(net, audio: torch.Tensor, state: dict | None = None, downsample_rate: int = 3) -> tuple[dict, torch.Tensor]:
    """Whole hops of ``audio`` [..., T] (the tail short of a hop is
    dropped), from ``state`` (default: a zero state on the audio's device)
    -> (final state, denoised [..., hops * 480])."""
    _require_nsnet2(net)
    hop = NSNET2_N_HOP * downsample_rate
    n = audio.shape[-1] // hop
    if state is None:
        state = init_state(audio.shape[:-1], audio.device, audio.dtype)
    if n == 0:
        return state, audio[..., :0]
    return _denoise(net, state, resample.downsample(audio[..., : n * hop], downsample_rate), downsample_rate)
