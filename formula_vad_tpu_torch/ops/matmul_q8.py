"""Int8 matmul with the dequant fused into the epilogue: CUDA kernel wrapper
and plain version.

``matmul_q8`` replaces ``formula_vad_tpu/ops/matmul_q8.py::matmul_q8``
(Pallas, bodies ``_kernel`` and ``_kernel_rs``):

    acc[i, j] = sum_k a8[i, k] * b8[k, j]      exact in int32
    out[i, j] = epilogue(acc[i, j])            float32, stored f32 or bf16

The epilogue rounds each float32 operation on its own, in one of two orders:
``"col_row"`` is ``(acc * scale[j]) * row_scale[i]`` (the TPU kernel's
``acc * s * r``), ``"row_col"`` is ``(acc * row_scale[i]) * scale[j]``
(``nsnet2_q8``'s ``_dot8(...) * sx * s``); then ``+ bias[j]`` if the weight
carries one. Any R, K and N: there is no multiple-of-256 row rule here.

The weight is a ``Q8Weight``, packed once as the kernel reads it. CUDA
tensors go to the kernel in ``csrc/matmul_q8.cu``; CPU tensors go to
``matmul_q8_reference``, which defines what the kernel computes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build

K_STEP = 32  # the kernel's K step in bytes; packed weights pad K to it
ORDERS = ("col_row", "row_col")
OUT_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Q8Weight:
    """A quantized [K, N] weight: ``qt`` [N, K_pad] int8, K-contiguous and
    zero past K (K_pad a multiple of 32); ``scale`` [N] float32 per output
    column; ``bias`` [N] float32 or None."""

    qt: torch.Tensor
    k: int
    scale: torch.Tensor
    bias: torch.Tensor | None = None

    @classmethod
    def pack(cls, q8: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None) -> "Q8Weight":
        """From ``q8`` [K, N] int8 (the JAX package's ``b8`` layout) and
        per-column ``scale`` ([N] or [1, N])."""
        if q8.dtype != torch.int8 or q8.dim() != 2:
            raise ValueError(f"matmul_q8: weight must be [K, N] int8, got {tuple(q8.shape)} {q8.dtype}")
        k, n = q8.shape
        qt = q8.new_zeros((n, -(-k // K_STEP) * K_STEP))
        qt[:, :k] = q8.t()
        vec = lambda x: x.reshape(n).to(torch.float32).contiguous()  # noqa: E731
        return cls(qt, k, vec(scale), None if bias is None else vec(bias))

    @property
    def n(self) -> int:
        return self.qt.shape[0]


def _operands(a8: torch.Tensor, w: Q8Weight, row_scale, order: str, out_dtype):
    """Validate and flatten: -> (a [R, K], row [R] or None, leading shape)."""
    if order not in ORDERS:
        raise ValueError(f"matmul_q8: order must be one of {ORDERS}, got {order!r}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"matmul_q8: out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if a8.dtype != torch.int8 or a8.dim() < 1 or a8.shape[-1] != w.k:
        raise ValueError(f"matmul_q8: a8 must be [..., {w.k}] int8, got {tuple(a8.shape)} {a8.dtype}")
    lead = tuple(a8.shape[:-1])
    a = a8.reshape(-1, w.k)
    row = None
    if row_scale is not None:
        if row_scale.dtype != torch.float32 or row_scale.numel() != a.shape[0]:
            raise ValueError(
                f"matmul_q8: row_scale must hold {a.shape[0]} float32 values, got {tuple(row_scale.shape)} {row_scale.dtype}"
            )
        row = row_scale.reshape(-1)
    return a, row, lead


def matmul_q8_reference(
    a8: torch.Tensor, w: Q8Weight, row_scale: torch.Tensor | None = None, *,
    order: str = "col_row", out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version: the contraction in float64 (exact, since
    |acc| <= K * 127^2 < 2^53), converted to int32, then the epilogue as
    separate float32 ops in the same order."""
    a, row, lead = _operands(a8, w, row_scale, order, out_dtype)
    acc = (a.double() @ w.qt[:, : w.k].double().t()).to(torch.int32)
    out = acc.to(torch.float32)
    if order == "col_row":
        out = out * w.scale
        if row is not None:
            out = out * row[:, None]
    else:
        if row is not None:
            out = out * row[:, None]
        out = out * w.scale
    if w.bias is not None:
        out = out + w.bias
    return out.to(out_dtype).reshape(lead + (w.n,))


@functools.cache  # the int8 tier calls the wrapper 3 times a GRU step: keep the lookup off that path
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_q8")
    lib.fvad_matmul_q8.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fvad_matmul_q8.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"matmul_q8: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
        )


def matmul_q8(
    a8: torch.Tensor, w: Q8Weight, row_scale: torch.Tensor | None = None, *,
    order: str = "col_row", out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """a8 [..., K] int8 @ w -> [..., N] ``out_dtype``, scaled (and biased).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in ``matmul_q8.launches``) or raises."""
    if a8.device.type == "cpu":
        return matmul_q8_reference(a8, w, row_scale, order=order, out_dtype=out_dtype)
    if a8.device.type != "cuda":
        raise ValueError(f"matmul_q8: unsupported device {a8.device}")
    if not a8.is_contiguous():
        raise ValueError(f"matmul_q8: a8 must be contiguous, got strides {a8.stride()}")
    a, row, lead = _operands(a8, w, row_scale, order, out_dtype)
    dev = a8.device
    r, n = a.shape[0], w.n
    _check("weight", w.qt, torch.int8, (n, -(-w.k // K_STEP) * K_STEP), dev)
    _check("scale", w.scale, torch.float32, (n,), dev)
    if w.bias is not None:
        _check("bias", w.bias, torch.float32, (n,), dev)
    if row is not None:
        _check("row_scale", row, torch.float32, (r,), dev)
    out = torch.empty((r, n), dtype=out_dtype, device=dev)
    if r and n:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fvad_matmul_q8(
                a.data_ptr(), w.qt.data_ptr(), w.scale.data_ptr(),
                None if row is None else row.data_ptr(),
                None if w.bias is None else w.bias.data_ptr(),
                out.data_ptr(), r, n, w.k, w.qt.shape[1], ORDERS.index(order),
                int(out_dtype == torch.bfloat16), stream,
            )
        _build.check(lib, err, "matmul_q8 launch")
        matmul_q8.launches += 1
    return out.reshape(lead + (n,))


matmul_q8.launches = 0
