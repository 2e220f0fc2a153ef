"""The NSNet2 denoiser a 0.5 s chunk at a time (port of
``formula_vad_tpu/pipeline/denoiser.py``).

Per chunk of 24,000 samples a channel at 48 kHz: decimate to 16 kHz, put
the previous chunk's last hop in front, take 50 sqrt-Hann windowed
320-point frames at hop 160, log10 power features, prepend the 4 carried
feature frames and run the network from h = 0 over all 54 frames
(``net(model_in, out_frames=50)``, which routes to the tier's kernels),
clip the last 50 gains to [-80, 1], inverse-transform with overlap-add
(the first hop adds onto the carried OLA tail) and lerp-upsample the 8,000
finished samples back to 24,000, carrying the last sample.

Any leading batch shape is allowed: B streams x C channels make one model
call of B * C rows. The carry holds float32 copies under every storage
tier; each is cast at its join.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import NSNET2_CHUNK_16K, NSNET2_CONTEXT_FRAMES, NSNET2_N_BINS, NSNET2_N_FFT, NSNET2_N_FRAMES, NSNET2_N_HOP
from ..ops import resample, stft, windows

FEATURE_P_MIN = np.float32(1e-12)  # power floor before log10
GAIN_MIN = -80.0  # gain clip range
GAIN_MAX = 1.0

WINDOW = windows.sqrt_hann_symmetric(NSNET2_N_FFT)


def init_carry(n_channels: int, device="cpu", lead: tuple = ()) -> dict[str, torch.Tensor]:
    """Zero denoiser carry for streams of leading shape ``lead`` (the
    reference's zero-filled buffers at start)."""
    z = lambda *s: torch.zeros(tuple(lead) + (n_channels,) + s, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "in_tail": z(NSNET2_N_HOP),
        "out_tail": z(NSNET2_N_HOP),
        "feat_ctx": z(NSNET2_CONTEXT_FRAMES, NSNET2_N_BINS),
        "last_sample": z(),
    }


def compute_features(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """log10 power spectrum, clamped at 1e-12, in the spectra's dtype (bf16
    under bf16 activation storage, as in the JAX package; the carried
    context frames are cast to it at the join)."""
    power = re * re + im * im
    return torch.log10(torch.clamp(power, min=float(FEATURE_P_MIN)))


def denoise_chunk(net, carry: dict, chunk48: torch.Tensor, downsample_rate: int = 3) -> tuple[dict, torch.Tensor]:
    """Denoise one chunk [..., C, 8000 * downsample_rate] -> (new carry,
    denoised [..., C, 8000 * downsample_rate] float32)."""
    if chunk48.shape[-1] != NSNET2_CHUNK_16K * downsample_rate:
        raise ValueError(f"chunk of {chunk48.shape[-1]} samples, expected {NSNET2_CHUNK_16K * downsample_rate}")
    ds = resample.downsample(chunk48, downsample_rate)
    audio_in = torch.cat([carry["in_tail"].to(ds.dtype), ds], dim=-1)
    re, im = stft.stft(audio_in, WINDOW, NSNET2_N_FFT, NSNET2_N_HOP)  # [..., C, 50, 161]
    feats = compute_features(re, im)
    model_in = torch.cat([carry["feat_ctx"].to(feats.dtype), feats], dim=-2)  # [..., C, 54, 161]
    g = torch.clamp(net(model_in, out_frames=NSNET2_N_FRAMES), GAIN_MIN, GAIN_MAX)
    ola = stft.istft_overlap_add(re * g, im * g, WINDOW, NSNET2_N_FFT, NSNET2_N_HOP, NSNET2_CHUNK_16K + NSNET2_N_HOP)
    head = ola[..., :NSNET2_N_HOP] + carry["out_tail"].to(ola.dtype)
    ola = torch.cat([head, ola[..., NSNET2_N_HOP:]], dim=-1)
    # The JAX package's upsample multiplies the bf16 OLA by float32 0/1
    # matrices, so under bf16 storage its lerp runs in float32: as here.
    up, new_last = resample.upsample(ola[..., :NSNET2_CHUNK_16K].float(), carry["last_sample"], downsample_rate)
    cdt = carry["out_tail"].dtype
    new_carry = {
        "in_tail": ds[..., -NSNET2_N_HOP:].to(carry["in_tail"].dtype, copy=True),
        "out_tail": ola[..., NSNET2_CHUNK_16K:].to(cdt, copy=True),
        "feat_ctx": feats[..., -NSNET2_CONTEXT_FRAMES:, :].to(cdt, copy=True),
        "last_sample": new_last.to(cdt, copy=True),
    }
    return new_carry, up
