"""The denoiser model's quantization switch (port of the ``FVAD_QUANT`` part
of ``formula_vad_tpu/ops/precision.py``).

``set_quant("int8")`` (env ``FVAD_QUANT=int8``) runs every NSNet2 product as
an int8 x int8 -> int32 contraction with a float dequant epilogue
(``models/nsnet2_q8.py``, kernel ``ops/matmul_q8.py``). A throughput tier,
not a parity mode: gains carry ~2 decimal digits, so decisions can shift.

The matmul-precision (``FVAD_PRECISION``) and activation-storage
(``FVAD_IO_DTYPE``) tiers are not ported: any value but the full-float32
default raises here rather than running float32 under another name.
"""

from __future__ import annotations

import os

_PRECISIONS = ("highest", "high", "default")
_IO_DTYPES = ("f32", "bf16")
_QUANT_MODES = ("off", "int8")


def _env(name: str, default: str, allowed: tuple[str, ...]) -> str:
    value = os.environ.get(name, default).lower()
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
    return value


for _name, _default, _allowed in (
    ("FVAD_PRECISION", "highest", _PRECISIONS),
    ("FVAD_IO_DTYPE", "f32", _IO_DTYPES),
):
    if _env(_name, _default, _allowed) != _default:
        raise NotImplementedError(
            f"{_name}={os.environ[_name]!r}: only {_default!r} is ported; the matmul-precision and io-dtype "
            "tiers are not ported yet (ROADMAP: port queue, precision and io-dtype tiers)"
        )

_quant = _env("FVAD_QUANT", "off", _QUANT_MODES)


def set_quant(mode: str) -> None:
    """Select the denoiser-model quantization tier ('off' | 'int8')."""
    global _quant
    if mode not in _QUANT_MODES:
        raise ValueError(f"quant mode must be one of {_QUANT_MODES}, got {mode!r}")
    _quant = mode


def quant_int8() -> bool:
    """Whether the int8 denoiser-model tier is selected."""
    return _quant == "int8"
