"""Volume utilities (port of ``formula_vad_tpu/ops/volume.py``)."""

from __future__ import annotations

import torch


def rms_volume(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """sqrt(mean(x^2)) as float32.

    The mean is accumulated in float64 and rounded once to float32, so the
    CPU and CUDA builds of torch (which sum in different orders) agree on it
    bit for bit; the JAX package sums in float32, so the two packages agree
    to about one float32 ulp (tests/test_torch_ops.py)."""
    x64 = x.to(torch.float64)
    return torch.sqrt(torch.mean(x64 * x64, dim=dim).to(torch.float32))


def norm_to_dbfs(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(x)


def volume_analysis(chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stereo volume analysis of ``chunk`` [..., n_channels, n_samples] ->
    (volume_ratio, vol_min, vol_max), each [...]: the channels' RMS, the
    smallest clamped to <= 1 and the largest to >= 0 (the reference starts
    them at 1 and 0), and their ratio, or 0 where the largest is 0."""
    vols = rms_volume(chunk, dim=-1)
    vol_min = torch.clamp(torch.amin(vols, dim=-1), max=1.0)
    vol_max = torch.clamp(torch.amax(vols, dim=-1), min=0.0)
    ratio = torch.where(vol_max == 0.0, torch.zeros_like(vol_max), vol_min / vol_max)
    return ratio, vol_min, vol_max
