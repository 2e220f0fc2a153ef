"""Denoiser constants and features (port of ``formula_vad_tpu/pipeline/
denoiser.py``:44-48, :65)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import NSNET2_N_FFT
from ..ops import windows

FEATURE_P_MIN = np.float32(1e-12)  # power floor before log10
GAIN_MIN = -80.0  # gain clip range
GAIN_MAX = 1.0

WINDOW = windows.sqrt_hann_symmetric(NSNET2_N_FFT)


def compute_features(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """log10 power spectrum, clamped at 1e-12, in the spectra's dtype (bf16
    under bf16 activation storage, as in the JAX package; the carried
    context frames are cast to it at the join, ``offline._model_input``)."""
    power = re * re + im * im
    return torch.log10(torch.clamp(power, min=float(FEATURE_P_MIN)))
