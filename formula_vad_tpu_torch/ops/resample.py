"""Integer-ratio resampling (port of ``formula_vad_tpu/ops/resample.py``).

``downsample`` is naive decimation, out[i] = in[i * rate], with no
anti-alias filter, as the reference. In ``upsample``, for rate R each
input sample lands at output index i*R + (R-1) and the R-1 slots before
it interpolate from the previous sample:
``lerp(a, b, t) = a + (b - a) * t`` in float32 with t = (j+1)/R. The JAX
package moves the data with exact 0/1 matmuls; here it is a stack and a
reshape, and the values are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch


def calc_downsample_rate(in_rate: int, base_rate: int) -> int:
    if in_rate % base_rate != 0:
        raise ValueError("sample rate must be divisible by base_rate")
    return in_rate // base_rate


def downsample(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Decimate the trailing axis by ``rate`` (a strided view)."""
    return x if rate == 1 else x[..., ::rate]


def upsample(x: torch.Tensor, prev_last: torch.Tensor, rate: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., n], prev_last [...] -> (out [..., n * rate], new_last [...])."""
    if rate == 1:
        return x, x[..., -1]
    prev = torch.cat([prev_last[..., None].to(x.dtype), x[..., :-1]], dim=-1)
    d = x - prev
    planes = [prev + d * np.float32((j + 1) / rate) for j in range(rate - 1)] + [x]
    out = torch.stack(planes, dim=-1).reshape(x.shape[:-1] + (x.shape[-1] * rate,))
    return out, x[..., -1]
