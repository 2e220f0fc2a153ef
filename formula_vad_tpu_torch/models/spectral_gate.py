"""Classical spectral-gate denoiser, a weights-free gain model (port of
``formula_vad_tpu/models/spectral_gate.py``).

The same contract as NSNet2: log10-power features [..., T, 161] of the
161-bin 20 ms STFT in, a per-frame spectral gain mask out, so the chunking,
overlap-add and VAD around it are shared unchanged:

* the noise PSD is estimated per 0.5 s chunk as a low quantile of the frame
  powers of each bin, along the frame axis (stateless per chunk, like the
  reference's per-chunk ONNX runs, so the chunk-parallel offline path
  applies as it is);
* the gain is an over-subtracted Wiener mask with a floor:
      g = clip(1 - alpha * noise / power, floor, 1).

Every operation is plain tensor arithmetic in the JAX gate's dtypes: the
power and the quantile in the features' dtype (bf16 under bf16 activation
storage), the quantile interpolated as ``jnp.quantile``'s linear method
does on XLA:CPU, the mask in float32 (the JAX gate multiplies by a float32
``alpha``). The gate has no TPU kernel, so it has no CUDA one either.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class SpectralGate(nn.Module):
    """Gain model with fields ``quantile`` (the noise-floor estimate),
    ``alpha`` (the over-subtraction factor) and ``floor`` (the least gain).

    It has no parameters; an empty buffer marks the device ``.to()`` moves
    it to, where ``device.model_device`` finds it."""

    def __init__(self, quantile: float = 0.10, alpha: float = 1.5, floor: float = 0.1):
        super().__init__()
        self.quantile = float(quantile)
        self.alpha = float(alpha)
        self.floor = float(floor)
        self.register_buffer("anchor", torch.zeros(0), persistent=False)

    def noise(self, power: torch.Tensor) -> torch.Tensor:
        """The ``quantile`` of ``power`` [..., T, 161] along T, keeping the
        axis, in ``power``'s dtype: ``jnp.quantile``'s linear method, whose
        position and weights are float32, interpolated in float32 as XLA:CPU
        contracts it, fma(low, w_low, high * w_high). The fma is computed in
        float64, where the product is exact, and rounded once: a plain
        multiply-add rounds twice and moves the bf16 tier's noise a bf16
        step in ~0.4% of bins."""
        n = power.shape[-2]
        pos = np.float32(self.quantile) * np.float32(n - 1)
        low = int(np.clip(np.floor(pos), 0, n - 1))
        high = int(np.clip(np.ceil(pos), 0, n - 1))
        high_w = np.float32(pos - np.floor(pos))
        low_w = np.float32(1.0) - high_w
        ordered = torch.sort(power, dim=-2).values
        hi = ordered[..., high : high + 1, :].float() * float(high_w)
        lo = ordered[..., low : low + 1, :].double() * float(low_w)
        return (lo + hi.double()).float().to(power.dtype)

    def forward(self, features: torch.Tensor, out_frames: int | None = None) -> torch.Tensor:
        """log10-power features [..., T, 161] -> float32 gains [..., T_out,
        161]: the last ``out_frames`` frames (the quantile still over all T)
        or all T."""
        power = torch.pow(10.0, features)
        noise = self.noise(power)
        gain = 1.0 - self.alpha * noise.float() / torch.clamp(power, min=1e-12)
        gain = torch.clamp(gain, self.floor, 1.0)
        t = gain.shape[-2]
        if out_frames is not None and out_frames < t:
            gain = gain[..., t - out_frames :, :]
        return gain
