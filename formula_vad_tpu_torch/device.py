"""Device selection for the port's entry points.

``resolve("cuda")`` refuses to run without a visible GPU rather than
carrying on on the CPU, and turns TF32 off for matmuls and cuDNN so float32
products run in full float32 — the counterpart of the JAX package's default
``highest`` matmul precision (``formula_vad_tpu/ops/precision.py``).
"""

from __future__ import annotations

import itertools

import torch
from torch import nn

DEVICES = ("cuda", "cpu")


def resolve(name: str) -> torch.device:
    if name not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def model_device(net: nn.Module) -> torch.device:
    """The device a gain model's tensors live on: its first parameter's, or
    for a model without parameters (the gate) its first buffer's."""
    for t in itertools.chain(net.parameters(), net.buffers()):
        return t.device
    raise ValueError(f"{type(net).__name__} holds no tensor to place it on a device")
