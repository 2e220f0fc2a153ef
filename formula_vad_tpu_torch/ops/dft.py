"""Real DFT and inverse as matmuls, and the speech-band bin mapping (port
of ``formula_vad_tpu/ops/dft.py``).

Same float64-then-float32 construction of the bases as there, so they are
bit-identical to the JAX package's. The forward basis uses the
-2*pi*k*n/N phase; the inverse follows kissfft's unnormalized convention
(callers fold in 1/N). The products run at the global matmul precision
(``precision.matmul`` with no stage), their operands cast by
``precision.io_cast`` where the JAX package casts them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import precision


@functools.lru_cache(maxsize=None)
def rdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos_mat, sin_mat), each [n_fft, n_bins]: X_re = x @ cos, X_im = x @ sin."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    phase = -2.0 * np.pi * n * k / n_fft
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


@functools.lru_cache(maxsize=None)
def irdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Unnormalized inverse basis (cos_mat, sin_mat), each [n_bins, n_fft]:
    x[n] = sum_k w[k] (Re X[k] cos(2 pi k n/N) - Im X[k] sin(2 pi k n/N)),
    w[k] = 1 for k in {0, N/2}, else 2."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * k * n / n_fft
    weights = np.full((n_bins, 1), 2.0)
    weights[0, 0] = 1.0
    weights[-1, 0] = 1.0
    return (weights * np.cos(phase)).astype(np.float32), (weights * np.sin(phase)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bases(inverse: bool, n_fft: int, device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos_mat, sin_mat) of ``n_fft`` on ``device`` in ``dtype``, made once each."""
    mats = (irdft_matrices if inverse else rdft_matrices)(n_fft)
    return tuple(torch.from_numpy(m).to(device=device, dtype=dtype) for m in mats)


def _cast_bases(inverse: bool, n_fft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return _bases(inverse, n_fft, torch.device(device), precision.io_dtype() or torch.float32)


def rdft(frames: torch.Tensor, n_fft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward real DFT of ``frames[..., n_fft]`` -> (re, im), each [..., n_bins]."""
    cos_m, sin_m = _cast_bases(False, n_fft, frames.device)
    frames = precision.io_cast(frames)
    return precision.matmul(frames, cos_m), precision.matmul(frames, sin_m)


def irdft_kiss(re: torch.Tensor, im: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Unnormalized inverse real DFT (kiss_fftri convention): [..., n_bins] -> [..., n_fft]."""
    cos_m, sin_m = _cast_bases(True, n_fft, re.device)
    return precision.matmul(precision.io_cast(re), cos_m) - precision.matmul(precision.io_cast(im), sin_m)


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """|X| = sqrt(re^2 + im^2)."""
    return torch.sqrt(re * re + im * im)


def freq_to_bin(freq: float, n_fft: int, sample_rate: int) -> int:
    """Nearest-bin mapping: round(freq / bin_width), in float32."""
    bin_width = np.float32(sample_rate) / np.float32(n_fft)
    if freq > sample_rate / 2:
        raise ValueError("frequency above Nyquist")
    if freq < 0:
        raise ValueError("negative frequency")
    return int(np.round(np.float32(freq) / bin_width))
