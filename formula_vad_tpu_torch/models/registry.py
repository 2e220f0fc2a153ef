"""Resolve a denoiser spec to a gain model (port of ``formula_vad_tpu/models/
registry.py``:70).

A gain model is an ``nn.Module`` whose ``forward(features, out_frames=None)``
maps log10-power features [..., T, 161] to spectral gains for the last
``out_frames`` frames: ``nsnet2.NSNet2`` or ``spectral_gate.SpectralGate``.
The runners call it as ``net(features, out_frames=...)`` and find its device
with ``device.model_device``.

Specs:
  None / "demo"          -> the packaged demo weights
                            (``formula_vad_tpu/data/nsnet2_demo.npz``)
  "random"               -> Glorot-random NSNet2 from a seeded ``torch.Generator``
  "spectral_gate"        -> the classical Wiener gate (weights-free)
  "spectral_gate:q,a,f"  -> the gate with explicit quantile, alpha, floor
  "*.npz" / "*.onnx"     -> NSNet2 weights from disk (``nsnet2.load``)

A malformed gate spec, or any other spec ``nsnet2.load`` cannot read,
raises ``ValueError``. The model lands on the card unless
the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os

import torch
from torch import nn

from .. import device as device_mod
from . import nsnet2
from .spectral_gate import SpectralGate

log = logging.getLogger("fvad.pipeline")

DEMO_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "formula_vad_tpu", "data", "nsnet2_demo.npz",
)
GATE = "spectral_gate"


def parse_gate(spec: str) -> SpectralGate:
    """``"spectral_gate"`` or ``"spectral_gate:q,a,f"`` -> the gate."""
    if spec == GATE:
        return SpectralGate()
    fields = spec[len(GATE) + 1 :].split(",")
    try:
        if len(fields) != 3:
            raise ValueError(f"{len(fields)} fields")
        q, a, f = (float(x) for x in fields)
    except ValueError as e:
        raise ValueError(f"malformed denoiser spec {spec!r}: expected {GATE}:quantile,alpha,floor ({e})") from None
    return SpectralGate(quantile=q, alpha=a, floor=f)


def load_denoiser(spec: str | None, *, seed: int = 0, device: str | torch.device = "cuda") -> nn.Module:
    dev = device if isinstance(device, torch.device) else device_mod.resolve(device)
    if spec is None or spec == "demo":
        if not os.path.exists(DEMO_WEIGHTS):
            raise FileNotFoundError(f"packaged demo weights missing: {DEMO_WEIGHTS}")
        log.info("denoiser: packaged demo weights (%s)", DEMO_WEIGHTS)
        net = nsnet2.load_npz(DEMO_WEIGHTS)
    elif spec == "random":
        net = nsnet2.init_params(torch.Generator().manual_seed(seed))
    elif spec == GATE or spec.startswith(GATE + ":"):
        net = parse_gate(spec)
    else:
        net = nsnet2.load(spec)
    return net.to(dev)
