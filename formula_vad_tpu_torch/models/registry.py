"""Resolve a denoiser spec to a model (port of ``formula_vad_tpu/models/
registry.py``:70).

Specs: ``None`` / ``"demo"`` -> the packaged demo weights
(``formula_vad_tpu/data/nsnet2_demo.npz``); ``"random"`` -> Glorot-random
NSNet2 from a seeded ``torch.Generator``; ``"*.npz"`` -> weights from disk.
The model lands on the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os

import torch

from .. import device as device_mod
from . import nsnet2

log = logging.getLogger("fvad.pipeline")

DEMO_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "formula_vad_tpu", "data", "nsnet2_demo.npz",
)


def load_denoiser(spec: str | None, *, seed: int = 0, device: str | torch.device = "cuda") -> nsnet2.NSNet2:
    dev = device if isinstance(device, torch.device) else device_mod.resolve(device)
    if spec is None or spec == "demo":
        if not os.path.exists(DEMO_WEIGHTS):
            raise FileNotFoundError(f"packaged demo weights missing: {DEMO_WEIGHTS}")
        log.info("denoiser: packaged demo weights (%s)", DEMO_WEIGHTS)
        net = nsnet2.load_npz(DEMO_WEIGHTS)
    elif spec == "random":
        net = nsnet2.init_params(torch.Generator().manual_seed(seed))
    elif spec.endswith(".npz"):
        net = nsnet2.load_npz(spec)
    elif spec.endswith(".onnx"):
        raise NotImplementedError("ONNX weight import is not ported yet (ROADMAP: port queue, ONNX import)")
    elif spec.startswith("spectral_gate"):
        raise NotImplementedError("the spectral_gate denoiser is not ported yet (ROADMAP: port queue, spectral_gate)")
    else:
        raise ValueError(f"unsupported denoiser spec: {spec}")
    return net.to(dev)
