"""Matmul precision and model quantization switches (port of
``formula_vad_tpu/ops/precision.py``).

Matmul precision (``FVAD_PRECISION`` or ``set_matmul_precision``), per
named stage of the scoring path (``STAGES``, with per-stage overrides):

* ``"highest"`` (default): full float32 products, TF32 off. The parity
  configuration.
* ``"default"``: single-pass bf16, as the JAX package's TPU runs it: both
  operands rounded to bfloat16, the exact products summed in float32
  (``matmul``). Under it the NSNet2 recurrence runs through the bf16 form
  of ``models/nsnet2_gates_cuda.gru_gates_p``. A throughput tier, not a
  parity mode: rare one-window boundary shifts are possible.

``"high"`` (bf16_3x) and the activation-storage tier (``FVAD_IO_DTYPE``)
are not ported: asking for them raises rather than running float32 under
another name. Levels are names here, not JAX enums.

``set_quant("int8")`` (env ``FVAD_QUANT=int8``) runs every NSNet2 product as
an int8 x int8 -> int32 contraction with a float dequant epilogue
(``models/nsnet2_q8.py``, kernel ``ops/matmul_q8.py``). A throughput tier,
not a parity mode: gains carry ~2 decimal digits, so decisions can shift.
"""

from __future__ import annotations

import os

import torch

_LEVELS = ("highest", "high", "default")
_PORTED_LEVELS = ("highest", "default")
_IO_DTYPES = ("f32", "bf16")
_QUANT_MODES = ("off", "int8")
STAGES = ("stft", "istft", "band", "fc_in", "gru_i", "gru_h", "ff")


def _env(name: str, default: str, allowed: tuple[str, ...]) -> str:
    value = os.environ.get(name, default).lower()
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
    return value


def _ported(level: str, what: str) -> str:
    if level not in _LEVELS:
        raise ValueError(f"precision must be one of {_LEVELS}, got {level!r}")
    if level not in _PORTED_LEVELS:
        raise NotImplementedError(
            f"{what}={level!r}: only {_PORTED_LEVELS} are ported; the bf16_3x level is not ported yet "
            "(ROADMAP: port queue, precision and io-dtype tiers)"
        )
    return level


_current = _ported(_env("FVAD_PRECISION", "highest", _LEVELS), "FVAD_PRECISION")
if _env("FVAD_IO_DTYPE", "f32", _IO_DTYPES) != "f32":
    raise NotImplementedError(
        f"FVAD_IO_DTYPE={os.environ['FVAD_IO_DTYPE']!r}: only 'f32' is ported; the bf16 activation-storage "
        "tier is not ported yet (ROADMAP: port queue, precision and io-dtype tiers)"
    )
_quant = _env("FVAD_QUANT", "off", _QUANT_MODES)
_stage_overrides: dict[str, str] = {}


def set_matmul_precision(level: str) -> None:
    """Select the global matmul precision ('highest' | 'default')."""
    global _current
    _current = _ported(level, "precision")


def matmul_precision(stage: str | None = None) -> str:
    """The level a product of ``stage`` runs at: its override, else the global level."""
    if stage is not None and stage in _stage_overrides:
        return _stage_overrides[stage]
    return _current


def set_stage_precision(stage: str, level: str | None) -> None:
    """Override one stage's matmul precision (None clears the override)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if level is None:
        _stage_overrides.pop(stage, None)
        return
    _stage_overrides[stage] = _ported(level, "precision")


def set_stage_overrides(overrides: dict[str, str] | None) -> None:
    """Replace the whole stage-override map (None/{} clears)."""
    for stage in list(_stage_overrides):
        set_stage_precision(stage, None)
    for stage, level in (overrides or {}).items():
        set_stage_precision(stage, level)


def stage_overrides() -> dict[str, str]:
    return dict(_stage_overrides)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest, ties to even) and held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, stage: str | None = None) -> torch.Tensor:
    """``a @ b`` at the stage's precision. At 'default' both operands are
    rounded to bf16 and multiplied in float32 (TF32 off): a product of two
    bf16 values is exact in float32, so the result is float32 sums of the
    exact products, the TPU's single-pass bf16 with float32 accumulation.
    (``torch.matmul`` of two bf16 tensors would round the output to bf16
    too, which the tier does not.)"""
    if matmul_precision(stage) == "default":
        return bf16_round(a) @ bf16_round(b)
    return a @ b


def set_quant(mode: str) -> None:
    """Select the denoiser-model quantization tier ('off' | 'int8')."""
    global _quant
    if mode not in _QUANT_MODES:
        raise ValueError(f"quant mode must be one of {_QUANT_MODES}, got {mode!r}")
    _quant = mode


def quant_int8() -> bool:
    """Whether the int8 denoiser-model tier is selected."""
    return _quant == "int8"
