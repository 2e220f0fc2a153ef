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

The kernel has two bodies, and ``select_path`` picks one before the launch
from the shape and A's alignment alone: ``"wgmma"`` (K_pad <= 608: every
product of the int8 tier), a persistent kernel over the 128 x BN tiles of
``tile_plan``, and ``"mma_sync"``, the first port's body, for larger K.
Each call records its ``Path`` in ``matmul_q8.last_path``.
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
PATHS = ("mma_sync", "wgmma")  # the C entry point's path numbers, in order

# The wgmma body's tiles and shared memory, as csrc/matmul_q8.cu sizes them.
TILE_M = 128  # two computing warpgroups of 64 rows
TILE_NS = (128, 144)  # wgmma widths the kernel is built for
K_PAD_MAX = 608  # the whole K of both operands sits in shared memory
SMEM_LIMIT = 232_448  # dynamic shared memory one CTA may take on the H100


def smem_bytes(bn: int, k_pad: int, a_tma: bool) -> int:
    """Shared memory of the wgmma body: 1 KB to align the base, A [128,
    K_pad] int8 (K_pad rounded up to 128 where TMA loads A), B [bn, K_pad
    rounded up to 128], the staged output tile [128, 4 bn + 32 bytes] less
    the pad of each warpgroup's last row, scale and bias [2, 2, bn] float32
    and 6 mbarriers."""
    k_tma = _cdiv(k_pad, 128) * 128
    stage = 2 * (64 * (4 * bn + 32) - 32)
    return 1024 + TILE_M * (k_tma if a_tma else k_pad) + bn * k_tma + stage + 16 * bn + 8 * 6


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The wgmma body's schedule: ``row_blocks x col_blocks`` tiles of
    128 x ``bn``, numbered row block first, on ``grid`` persistent CTAs;
    CTA c takes the contiguous range ``cta_tiles(c)``."""

    rows: int
    n: int
    bn: int
    row_blocks: int
    col_blocks: int
    grid: int

    @property
    def tiles(self) -> int:
        return self.row_blocks * self.col_blocks

    @property
    def waves(self) -> int:
        """Tiles the busiest CTA computes."""
        return _cdiv(self.tiles, self.grid)

    def tile(self, t: int) -> tuple[range, range]:
        """The output rows and columns of tile ``t``, decoded as the kernel
        decodes them."""
        mb, nb = divmod(t, self.col_blocks)
        return (range(mb * TILE_M, min((mb + 1) * TILE_M, self.rows)),
                range(nb * self.bn, min((nb + 1) * self.bn, self.n)))

    def cta_tiles(self, c: int) -> range:
        return range(c * self.tiles // self.grid, (c + 1) * self.tiles // self.grid)


@functools.lru_cache(maxsize=1024)
def tile_plan(rows: int, n: int, k_pad: int, sm_count: int, a_tma: bool = False) -> TilePlan | None:
    """The tile width and grid of the wgmma body for an [rows, K] x [K, n]
    product on ``sm_count`` SMs (one CTA each), A loaded by TMA or not, or
    None where the whole K does not fit in shared memory. Of the widths
    that fit it takes the one whose busiest CTA computes the fewest output
    columns x tiles, the narrower on a tie: 1,680 x 1,200 takes 144 (14 x 9 = 126 tiles, one
    wave on 132 SMs, where 128 would leave 8 of 140 tiles to a second)."""
    if rows < 1 or n < 1 or sm_count < 1:
        raise ValueError(f"tile_plan: need positive sizes, got {rows}, {n}, {sm_count}")
    best = None
    for bn in TILE_NS:
        if k_pad > K_PAD_MAX or smem_bytes(bn, k_pad, a_tma) > SMEM_LIMIT:
            continue
        row_blocks, col_blocks = _cdiv(rows, TILE_M), _cdiv(n, bn)
        plan = TilePlan(rows, n, bn, row_blocks, col_blocks, min(row_blocks * col_blocks, sm_count))
        if best is None or plan.waves * bn < best.waves * best.bn:
            best = plan
    return best


@dataclasses.dataclass(frozen=True)
class Path:
    """How one call runs: the body (``PATHS``), its tile plan (wgmma only),
    the width in bytes of A's loads (wgmma: 16 by TMA, 8 by cp.async, 1
    through registers for any K and base; mma_sync: 16, 8, 4 or 1) and
    whether the output goes out in 16-byte stores."""

    name: str
    plan: TilePlan | None
    a_vec: int
    out_vec: bool


@functools.lru_cache(maxsize=1024)
def select_path(rows: int, k: int, n: int, out_dtype: torch.dtype, a_offset: int, sm_count: int) -> Path:
    """The path of a call, from the shape, the output type and A's address
    modulo 16 (``a_offset``) alone: the wgmma body wherever the whole K
    fits in its shared memory, else the mma_sync body."""
    k_pad = _cdiv(k, K_STEP) * K_STEP
    # A goes by TMA where its rows are 16-byte aligned and its 128-byte
    # blocks fit in shared memory (not at K_pad = 608: cp.async there)
    tma_plan = tile_plan(rows, n, k_pad, sm_count, True) if k % 16 == 0 and a_offset % 16 == 0 else None
    plan = tma_plan or tile_plan(rows, n, k_pad, sm_count)
    if plan is None:
        a_vec = next(v for v in (16, 8, 4, 1) if k % v == 0 and a_offset % v == 0)
        return Path("mma_sync", None, a_vec, False)
    a_vec = 16 if tma_plan else 8 if k % 8 == 0 and a_offset % 8 == 0 else 1
    return Path("wgmma", plan, a_vec, n * out_dtype.itemsize % 16 == 0)


@dataclasses.dataclass(frozen=True)
class Q8Weight:
    """A quantized [K, N] weight: ``qt`` [N, K_pad] int8, K-contiguous
    (K_pad a multiple of 32; ``pack`` zeroes what lies past K, which no
    product reads); ``scale`` [N] float32 per output
    column; ``bias`` [N] float32 or None. ``cache`` keeps, per device,
    that the tensors were checked, and the TMA maps of ``qt`` that the
    wgmma body reads it through, one per tile width, built at first use."""

    qt: torch.Tensor
    k: int
    scale: torch.Tensor
    bias: torch.Tensor | None = None
    cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

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
    return bind(_build.load("matmul_q8"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument types on a build of the kernel."""
    lib.fvad_matmul_q8.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2
    lib.fvad_matmul_q8.restype = ctypes.c_int
    lib.fvad_matmul_q8_weight_map.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fvad_matmul_q8_weight_map.restype = ctypes.c_int
    return lib


def _weight_map(lib: ctypes.CDLL, w: Q8Weight, bn: int) -> ctypes.Array:
    """The TMA map of ``w.qt`` for tiles of ``bn`` columns, built once and
    kept with the weight (a map holds ``qt``'s address, which the weight
    keeps alive)."""
    found = w.cache.get(("map", bn))
    if found is None:
        found = ctypes.create_string_buffer(128)
        with torch.cuda.device(w.qt.device):
            err = lib.fvad_matmul_q8_weight_map(w.qt.data_ptr(), w.n, w.qt.shape[1], bn, found)
        _build.check(lib, err, "matmul_q8 weight map")
        w.cache[("map", bn)] = found
    return found


@functools.lru_cache(maxsize=1024)
def _launch_args(r: int, k: int, n: int, out_dtype: torch.dtype, a_offset: int, index: int):
    """``select_path`` for device ``index``, and the C entry point's plan
    arguments (path, bn, grid, a_vec, out_vec), worked out once per shape:
    the int8 tier calls the wrapper 3 times a GRU step."""
    chosen = select_path(r, k, n, out_dtype, a_offset, torch.cuda.get_device_properties(index).multi_processor_count)
    plan = chosen.plan
    return chosen, (PATHS.index(chosen.name), 0 if plan is None else plan.bn, 0 if plan is None else plan.grid,
                    chosen.a_vec, int(chosen.out_vec))


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
    on the path ``select_path`` picks (counted in ``matmul_q8.launches``,
    the ``Path`` kept in ``matmul_q8.last_path``) or raises, also where
    autograd records and a float operand requires grad
    (``_build.refuse_grad``)."""
    if a8.device.type == "cpu":
        return matmul_q8_reference(a8, w, row_scale, order=order, out_dtype=out_dtype)
    if a8.device.type != "cuda":
        raise ValueError(f"matmul_q8: unsupported device {a8.device}")
    if not a8.is_contiguous():
        raise ValueError(f"matmul_q8: a8 must be contiguous, got strides {a8.stride()}")
    _build.refuse_grad("matmul_q8", row_scale, w.scale, w.bias)
    a, row, lead = _operands(a8, w, row_scale, order, out_dtype)
    dev = a8.device
    r, n = a.shape[0], w.n
    if ("checked", dev) not in w.cache:  # a frozen weight's tensors, once per device
        _check("weight", w.qt, torch.int8, (n, -(-w.k // K_STEP) * K_STEP), dev)
        _check("scale", w.scale, torch.float32, (n,), dev)
        if w.bias is not None:
            _check("bias", w.bias, torch.float32, (n,), dev)
        w.cache[("checked", dev)] = True
    if row is not None:
        _check("row_scale", row, torch.float32, (r,), dev)
    out = torch.empty((r, n), dtype=out_dtype, device=dev)
    if r and n:
        lib = _lib()
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        a_ptr = a.data_ptr()
        chosen, plan_args = _launch_args(r, w.k, n, out_dtype, a_ptr % 16, index)
        args = (
            a_ptr, w.qt.data_ptr(), w.scale.data_ptr(), None if row is None else row.data_ptr(),
            None if w.bias is None else w.bias.data_ptr(), out.data_ptr(), r, n, w.k, w.qt.shape[1],
            ORDERS.index(order), int(out_dtype == torch.bfloat16), *plan_args,
            None if chosen.plan is None else _weight_map(lib, w, chosen.plan.bn),
        )
        if index == torch.cuda.current_device():
            err = lib.fvad_matmul_q8(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = lib.fvad_matmul_q8(*args, torch._C._cuda_getCurrentRawStream(index))
        if err:
            _build.check(lib, err, f"matmul_q8 launch ({chosen.name})")
        matmul_q8.launches += 1
        matmul_q8.last_path = chosen
    return out.reshape(lead + (n,))


matmul_q8.launches = 0
matmul_q8.last_path = None
