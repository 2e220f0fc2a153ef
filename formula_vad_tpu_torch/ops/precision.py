"""Matmul precision, activation storage and model quantization switches
(port of ``formula_vad_tpu/ops/precision.py``).

Matmul precision (``FVAD_PRECISION`` or ``set_matmul_precision``), per
named stage of the scoring path (``STAGES``, with per-stage overrides):

* ``"highest"`` (default): full float32 products, TF32 off. The parity
  configuration.
* ``"high"``: bf16_3x, as the JAX package's TPU runs ``Precision.HIGH``:
  each operand split into a bf16 high half and the bf16 rounding of the
  rest, and the three products hi x hi, hi x lo and lo x hi summed in
  float32 (``matmul``): ~16 bits a product.
* ``"default"``: single-pass bf16, as the JAX package's TPU runs it: both
  operands rounded to bfloat16, the exact products summed in float32
  (``matmul``). A throughput tier, not a parity mode: rare one-window
  boundary shifts are possible.

Levels are names here, not JAX enums. The NSNet2 recurrence's products
fall in two classes (``gru_levels``): ``gru_h`` (h1 Wh1, h2 Wh2) and
``gru_i`` (h1 Wi2, layer 2's input projection inside the recurrence).
``models/nsnet2.py`` routes it by the two levels: both in {'default',
'high'} to the tensor-core body (``nsnet2_gates_cuda.gru_gates_p`` at
'default'/'default', ``gru_gates_3x`` otherwise: one bf16 pass a
'default' product, three a 'high' one); both 'highest' to kernel 1's
float32 body (``nsnet2_cuda.gru_stack``), one to ``gru_stack_mixed``
(kernel B: kernel 1's tiles, the other class on the tensor cores).

Orthogonally, ``set_io_dtype("bf16")`` (env ``FVAD_IO_DTYPE``) stores the
denoiser path's big activations (spectra, features, GRU projections and
outputs, gains, the OLA product, the 16 kHz stream) in bfloat16, cast by
``io_cast`` at the JAX package's cast points. A product of two bf16
operands is then a float32 sum of exact products, rounded once to bf16, at
every level. The reductions that feed FSM decisions (band magnitude sums,
RMS volumes, window ratios) and every carry across chunks and slabs stay
float32. Under it the NSNet2 recurrence runs through the bf16 form of
kernel 6 (``gru_gates_f`` with a bf16 out). A throughput tier, not a
parity mode.

``set_quant("int8")`` (env ``FVAD_QUANT=int8``) runs every NSNet2 product as
an int8 x int8 -> int32 contraction with a float dequant epilogue
(``models/nsnet2_q8.py``, kernel ``ops/matmul_q8.py``). A throughput tier,
not a parity mode: gains carry ~2 decimal digits, so decisions can shift.
Under bf16 storage it stores the layer-1 input projection, the GRU outputs
and the gains in bf16, as the JAX package's ``apply_streaming_q8`` does.
"""

from __future__ import annotations

import os

import torch

_LEVELS = ("highest", "high", "default")
_IO_DTYPES = {"f32": None, "bf16": torch.bfloat16}
_QUANT_MODES = ("off", "int8")
STAGES = ("stft", "istft", "band", "fc_in", "gru_i", "gru_h", "ff")


def _env(name: str, default: str, allowed) -> str:
    value = os.environ.get(name, default).lower()
    if value not in allowed:
        raise ValueError(f"{name} must be one of {tuple(allowed)}, got {value!r}")
    return value


def _level(level: str) -> str:
    if level not in _LEVELS:
        raise ValueError(f"precision must be one of {_LEVELS}, got {level!r}")
    return level


_current = _env("FVAD_PRECISION", "highest", _LEVELS)
_io = _env("FVAD_IO_DTYPE", "f32", _IO_DTYPES)
_quant = _env("FVAD_QUANT", "off", _QUANT_MODES)
_stage_overrides: dict[str, str] = {}


def set_matmul_precision(level: str) -> None:
    """Select the global matmul precision ('highest' | 'high' | 'default')."""
    global _current
    _current = _level(level)


def matmul_precision(stage: str | None = None) -> str:
    """The level a product of ``stage`` runs at: its override, else the global level."""
    if stage is not None and stage in _stage_overrides:
        return _stage_overrides[stage]
    return _current


def gru_levels() -> tuple[str, str]:
    """The levels of the NSNet2 recurrence's two product classes:
    (``gru_i``: h1 Wi2, ``gru_h``: h1 Wh1 and h2 Wh2)."""
    return matmul_precision("gru_i"), matmul_precision("gru_h")


def set_stage_precision(stage: str, level: str | None) -> None:
    """Override one stage's matmul precision (None clears the override)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if level is None:
        _stage_overrides.pop(stage, None)
        return
    _stage_overrides[stage] = _level(level)


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


def set_io_dtype(name: str) -> None:
    """Select the activation-storage dtype ('f32' | 'bf16')."""
    global _io
    if name not in _IO_DTYPES:
        raise ValueError(f"io dtype must be one of {tuple(_IO_DTYPES)}, got {name!r}")
    _io = name


def io_dtype() -> torch.dtype | None:
    """The activation-storage dtype, or None for full float32."""
    return _IO_DTYPES[_io]


def io_cast(x: torch.Tensor) -> torch.Tensor:
    """Cast an activation to the storage dtype (identity when f32)."""
    dt = _IO_DTYPES[_io]
    return x if dt is None or x.dtype == dt else x.to(dt)


def _bf16_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16_3x: hi = bf16(x), lo = bf16(x - hi) for each operand; the small
    products hi x lo and lo x hi summed first, then hi x hi added. Each is a
    float32 GEMM of bf16-valued operands, so exact products in float32 sums;
    only lo x lo (~2^-16 of a product) is dropped."""
    a_hi, b_hi = bf16_round(a), bf16_round(b)
    a_lo, b_lo = bf16_round(a - a_hi), bf16_round(b - b_hi)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def matmul(a: torch.Tensor, b: torch.Tensor, stage: str | None = None, level: str | None = None) -> torch.Tensor:
    """``a @ b`` at the stage's precision (or at ``level``), TF32 off. At 'default' both
    operands are rounded to bf16 and multiplied in float32: a product of two
    bf16 values is exact in float32, so the result is float32 sums of the
    exact products, the TPU's single-pass bf16 with float32 accumulation.
    (``torch.matmul`` of two bf16 tensors would round the output to bf16
    too, which the tier does not.) At 'high' it is ``_bf16_3x``.

    Two bf16 operands (bf16 activation storage) are multiplied exactly at
    every level and the float32 sums rounded once to bf16, as
    ``jnp.matmul`` of two bf16 arrays returns bf16. A bf16 operand against a
    float32 one is promoted to float32 first, as in JAX. Under autograd the
    gradients of a 'default' or 'high' product are products at its level,
    as JAX differentiates it."""
    if a.dtype == b.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(torch.bfloat16)
    a, b = a.float(), b.float()
    level = matmul_precision(stage) if level is None else _level(level)
    if level == "highest":
        return a @ b
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _RoundedProduct.apply(a, b, level)
    return _rounded(a, b, level)


def _rounded(a: torch.Tensor, b: torch.Tensor, level: str) -> torch.Tensor:
    """The float32 product at 'default' or 'high'."""
    return bf16_round(a) @ bf16_round(b) if level == "default" else _bf16_3x(a, b)


class _RoundedProduct(torch.autograd.Function):
    """A 'default' or 'high' product ``a [..., K] @ b [K, N]`` whose
    gradients are products at the same level, as JAX transposes a matmul
    at its precision (autograd through the roundings would instead round
    each gradient to bf16)."""

    @staticmethod
    def forward(ctx, a, b, level):
        ctx.save_for_backward(a, b)
        ctx.level = level
        return _rounded(a, b, level)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _rounded(g, b.mT, ctx.level)
        if ctx.needs_input_grad[1]:
            gb = _rounded(a.reshape(-1, a.shape[-1]).mT, g.reshape(-1, g.shape[-1]), ctx.level)
        return ga, gb, None


def set_quant(mode: str) -> None:
    """Select the denoiser-model quantization tier ('off' | 'int8')."""
    global _quant
    if mode not in _QUANT_MODES:
        raise ValueError(f"quant mode must be one of {_QUANT_MODES}, got {mode!r}")
    _quant = mode


def quant_int8() -> bool:
    """Whether the int8 denoiser-model tier is selected."""
    return _quant == "int8"
