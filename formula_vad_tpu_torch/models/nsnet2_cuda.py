"""The NSNet2 GRU-stack recurrence: CUDA kernel wrapper and plain version.

``gru_stack`` replaces ``formula_vad_tpu/models/nsnet2_pallas.py::
gru_stack_pallas``: both GRU layers (hidden 400, ONNX z|r|n gate order,
linear_before_reset = 1) stepped T times from h = 0 over the precomputed
layer-1 input projection ``gi1 [N, T, 1200]``; it returns the layer-2
hidden sequence ``[N, T, 400]``. Given ``state=(h1, h2)`` ([N, 400]
float32 each, the low-latency mode's carried GRU state) the steps continue
it instead, and the call also returns the final ``(h1, h2)``; without one
the launch is the stateless one, bit for bit. Per step and row:

    gh1 = h1 @ Wh1 + bh1;  h1 = gru(gi1[t], gh1, h1)
    gi2 = h1 @ Wi2 + bi2;  gh2 = h2 @ Wh2 + bh2;  h2 = gru(gi2, gh2, h2)

CUDA tensors go to the kernel in ``csrc/gru_stack.cu``, one cooperative
launch per call over tiles of rows x hidden units whose sizes and grid the
host computes (``launch_plan``, a pure function the CPU tests check); CPU
tensors go to ``gru_stack_reference``, a per-step loop of
``precision.matmul`` and gate math that defines what the kernel computes.

The products fall in two classes (``precision.gru_levels``): ``gru_h``
(h1 Wh1, h2 Wh2) and ``gru_i`` (h1 Wi2). ``gru_stack`` runs both at
'highest'. ``gru_stack_mixed`` runs the mixes in which one class is
'highest' and the other 'high' or 'default' (a stage override of
``gru_i`` or ``gru_h``, as the stage audit sets them) on kernel B,
``csrc/gru_mixed.cu``: kernel 1's tiles with the other class on the
tensor cores, instantiated per pair of levels, its weights packed at their
class's level (``pack_at``: B fragments for ``mma.sync``) and its plan
from its own occupancy (``device_plan(..., levels)``). The plain loop
also serves linear_before_reset = 0 weights, which no kernel takes, at any
levels and, under bf16 activation storage, in bf16 (every operand and op
output rounded to bf16, as the JAX package runs its scan on bf16 arrays).

The same kernel runs the float32 forms of the per-gate kernels of
``nsnet2_gates_cuda`` (``gru_stack_gates``): their function is this one,
with gi given as three per-gate arrays, the biases folded otherwise and,
for kernel 6, h2 stored in bf16.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from ..ops import precision
from .nsnet2 import HIDDEN, NSNet2, weights_key

G3 = 3 * HIDDEN


def _gates(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """z|r|n gate math, linear_before_reset = 1, over h's units: gi, gh
    [..., 3u], h [..., u] (u = 400, or a training grid's unit shard). (The
    trainer differentiates it too: autograd turns a split back into one
    cat, but each of three slices into a zero fill and a copy.)"""
    u = h.shape[-1]
    z_i, r_i, n_i = gi.split(u, dim=-1)
    z_h, r_h, n_h = gh.split(u, dim=-1)
    z = torch.sigmoid(z_i + z_h)
    r = torch.sigmoid(r_i + r_h)
    n = torch.tanh(n_i + r * n_h)
    return (1.0 - z) * n + z * h


def gru_cell(wh, bh, lbr: int, h: torch.Tensor, gi: torch.Tensor, level: str) -> torch.Tensor:
    """One GRU step with the input projection ``gi`` precomputed (the JAX
    package's ``gru_cell_pre``, both forms of the n gate), its products at
    ``level`` (``precision.matmul``). The plain loop below steps it, and so
    does the trainer's differentiable forward through that loop."""
    if lbr:
        return _gates(gi, precision.matmul(h, wh, level=level) + bh, h)
    z_i, r_i, n_i = gi.split(HIDDEN, dim=-1)
    wh_z, wh_r, wh_n = wh.split(HIDDEN, dim=-1)
    bh_z, bh_r, bh_n = bh.split(HIDDEN, dim=-1)
    z = torch.sigmoid(z_i + precision.matmul(h, wh_z, level=level) + bh_z)
    r = torch.sigmoid(r_i + precision.matmul(h, wh_r, level=level) + bh_r)
    n = torch.tanh(n_i + precision.matmul(r * h, wh_n, level=level) + bh_n)
    return (1.0 - z) * n + z * h


def gru_stack_reference(net: NSNet2, gi1: torch.Tensor, state: tuple | None = None, levels: tuple | None = None):
    """Plain PyTorch version: gi1 [N, T, 1200] -> h2 sequence [N, T, 400];
    with ``state=(h1, h2)`` -> (sequence, final (h1, h2)). ``levels``
    (gru_i, gru_h), default ``precision.gru_levels()``: h1 Wi2 runs at the
    first, h1 Wh1 and h2 Wh2 at the second. It runs in gi1's dtype: with a
    bf16 gi1 (bf16 storage) the weights, the state and every op's output
    are bf16. Autograd records it (the trainer's forward)."""
    level_i, level_h = levels or precision.gru_levels()
    g1, g2 = net.gru1, net.gru2
    wh1, bh1, wi2, bi2, wh2, bh2 = (w.to(gi1.dtype) for w in (g1.wh, g1.bh, g2.wi, g2.bi, g2.wh, g2.bh))
    n, t, _ = gi1.shape
    h1, h2 = state if state is not None else (gi1.new_zeros((n, HIDDEN)), gi1.new_zeros((n, HIDDEN)))
    ys = []
    for step in range(t):
        h1 = gru_cell(wh1, bh1, g1.linear_before_reset, h1, gi1[:, step], level_h)
        h2 = gru_cell(wh2, bh2, g2.linear_before_reset, h2, precision.matmul(h1, wi2, level=level_i) + bi2, level_h)
        ys.append(h2)
    out = torch.stack(ys, dim=1) if ys else gi1.new_zeros((n, 0, HIDDEN))
    return out if state is None else (out, (h1, h2))


# The kernel's tile geometry (csrc/gru_tile.cuh: UNIT_TILE, TR * RM).
UNIT_TILE = 40
ROW_TILE_MAX = 144
# Kernel B's shared memory a CTA (csrc/gru_mixed.cu, whose
# fvad_gru_mixed_smem_bytes the GPU tests hold it to): kernel 1's two stages
# of h rows (float32 at a pitch of 84, or bf16 hi | lo at 336 bytes) and a
# K chunk of 80 weight rows, then the z and r sums kept past the float32
# product (a pitch of 84).
MIXED_SMEM_BYTES = 2 * (ROW_TILE_MAX * 84 + 80 * 3 * UNIT_TILE) * 4 + ROW_TILE_MAX * 84 * 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/gru_stack.cu`` splits [n_rows, 400] into tiles of
    ``row_tile`` rows x ``unit_tile`` hidden units (with their three gates),
    and how many CTAs (``grid``) walk them with a grid stride."""

    n_rows: int
    row_tile: int
    unit_tile: int
    row_groups: int
    unit_groups: int
    tiles: int
    grid: int

    def tile_span(self, tile: int) -> tuple[range, range]:
        """The rows and the hidden units of one tile, decoded as the kernel
        decodes them."""
        rg, ug = divmod(tile, self.unit_groups)
        rows = range(rg * self.row_tile, min((rg + 1) * self.row_tile, self.n_rows))
        return rows, range(ug * self.unit_tile, (ug + 1) * self.unit_tile)

    def block_tiles(self, block: int) -> range:
        """The tiles CTA ``block`` computes, in its order."""
        return range(block, self.tiles, self.grid)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(n_rows: int, sm_count: int, blocks_per_sm: int) -> LaunchPlan:
    """The tiling of ``n_rows`` rows on a card of ``sm_count`` SMs that hold
    ``blocks_per_sm`` CTAs each. One wave holds ``slots // unit_groups`` row
    groups of every unit group; the rows are spread evenly over as few whole
    waves as tiles of at most ROW_TILE_MAX rows allow, so that every wave,
    the last included, fills the card (1,680 rows on 132 SMs: 13 groups of
    130 rows x 10 unit groups = 130 tiles, one wave)."""
    if n_rows < 1 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"launch_plan: need positive sizes, got {n_rows}, {sm_count}, {blocks_per_sm}")
    slots = sm_count * blocks_per_sm
    unit_groups = HIDDEN // UNIT_TILE
    per_wave = max(1, slots // unit_groups)
    waves = _cdiv(_cdiv(n_rows, ROW_TILE_MAX), per_wave)
    row_tile = _cdiv(n_rows, waves * per_wave)
    row_groups = _cdiv(n_rows, row_tile)
    tiles = row_groups * unit_groups
    return LaunchPlan(n_rows, row_tile, UNIT_TILE, row_groups, unit_groups, tiles, min(tiles, slots))


def pack(w: torch.Tensor) -> torch.Tensor:
    """A recurrent weight [400, 1200] (z|r|n columns) re-laid by unit group
    for the kernel: [unit group, k, gate * UNIT_TILE + unit], so that the
    120 columns of a unit group are one contiguous [400, 120] block."""
    groups = HIDDEN // UNIT_TILE
    w = w.reshape(HIDDEN, 3, groups, UNIT_TILE).permute(2, 0, 1, 3)
    return w.reshape(groups, HIDDEN, 3 * UNIT_TILE).contiguous()


# A product class's level as the kernel's template parameter.
LEVEL_CODES = {"highest": 0, "high": 1, "default": 2}


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """A bf16 ``pack``ed weight [10, 400, 120] in ``mma.sync.m16n8k16``
    B-fragment order: int32 [10, 25 K steps, 15 n8 tiles, 32 lanes, 2].
    Lane 4 g + q of (K step s, n8 tile n) holds, low half first,
    (w[16 s + 2 q, 8 n + g], w[16 s + 2 q + 1, 8 n + g]) in its first word
    and the same 8 rows further down in its second."""
    x = w.contiguous().view(torch.int16).reshape(w.shape[0], HIDDEN // 16, 2, 4, 2, 3 * UNIT_TILE // 8, 8)
    x = x.permute(0, 1, 5, 6, 3, 2, 4).contiguous()  # (group, s, n, g, q, half, pair)
    return x.view(torch.int32).reshape(w.shape[0], HIDDEN // 16, 3 * UNIT_TILE // 8, 32, 2)


def pack_at(w: torch.Tensor, level: str) -> torch.Tensor:
    """``pack(w)`` in the form a class at ``level`` reads: float32 at
    'highest' (kernels 1 and B's FMA layout); at 'default' and 'high'
    kernel B's ``mma.sync`` B fragments of each unit group (``_fragments``),
    int32 [10, 25, 15, 32, words]: at 'default' 2 words of bf16(w), at
    'high' 4, those of hi = bf16(w), then those of lo = bf16(w - hi)."""
    if level == "highest":
        return pack(w)
    if level not in LEVEL_CODES:
        raise ValueError(f"pack_at: level must be one of {tuple(LEVEL_CODES)}, got {level!r}")
    hi = pack(w.float()).to(torch.bfloat16)
    if level == "default":
        return _fragments(hi)
    lo = (pack(w.float()) - hi.float()).to(torch.bfloat16)
    return torch.cat([_fragments(hi), _fragments(lo)], dim=-1)


def packed_weights(net: NSNet2, levels: tuple = ("highest", "highest")) -> tuple[torch.Tensor, ...]:
    """wh1, wi2 and wh2 packed for the kernel at ``levels`` (gru_i, gru_h):
    wi2 at the first, wh1 and wh2 at the second (``pack_at``); cached on
    the module per pair and redone when its weights move, are replaced or
    are written in place (``nsnet2.weights_key``)."""
    key = weights_key(net)
    cache = net.__dict__.get("_gru_stack_cache")
    if cache is None or cache[0] != key:
        cache = net._gru_stack_cache = (key, {})
    if levels not in cache[1]:
        level_i, level_h = levels
        with torch.no_grad():
            cache[1][levels] = (pack_at(net.gru1.wh, level_h), pack_at(net.gru2.wi, level_i),
                                pack_at(net.gru2.wh, level_h))
    return cache[1][levels]


@functools.cache  # the lookup and the argtypes stay off the per-call path
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_stack")
    lib.fvad_gru_stack.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fvad_gru_stack.restype = ctypes.c_int
    lib.fvad_gru_stack_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fvad_gru_stack_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def _mixed_lib() -> ctypes.CDLL:
    lib = _build.load("gru_mixed")
    lib.fvad_gru_mixed.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fvad_gru_mixed.restype = ctypes.c_int
    lib.fvad_gru_mixed_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.fvad_gru_mixed_blocks_per_sm.restype = ctypes.c_int
    lib.fvad_gru_mixed_attributes.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.fvad_gru_mixed_attributes.restype = ctypes.c_int
    lib.fvad_gru_mixed_smem_bytes.argtypes = []
    lib.fvad_gru_mixed_smem_bytes.restype = ctypes.c_int
    return lib


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.cache
def _card(index: int, levels: tuple = ("highest", "highest")) -> tuple[int, int]:
    """(SM count, CTAs one SM holds) of CUDA device ``index`` for kernel 1
    or, at mixed ``levels``, kernel B's instantiation for them."""
    blocks = ctypes.c_int(0)
    if levels == ("highest", "highest"):
        lib, what = _lib(), "gru_stack"
        with torch.cuda.device(index):
            err = lib.fvad_gru_stack_blocks_per_sm(ctypes.byref(blocks))
    else:
        lib, what = _mixed_lib(), f"gru_mixed {levels}"
        with torch.cuda.device(index):
            err = lib.fvad_gru_mixed_blocks_per_sm(*(LEVEL_CODES[level] for level in levels), ctypes.byref(blocks))
    _build.check(lib, err, f"{what} occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"{what}: the kernel does not fit on one SM of this device")
    return torch.cuda.get_device_properties(index).multi_processor_count, blocks.value


def device_plan(n_rows: int, dev: torch.device, levels: tuple = ("highest", "highest")) -> LaunchPlan:
    """``launch_plan`` for the card ``dev``: its SM count and the occupancy
    of kernel 1 or, at mixed ``levels``, of kernel B's instantiation,
    queried once per device."""
    return launch_plan(n_rows, *_card(_index(dev), tuple(levels)))


def mixed_attributes(levels: tuple, dev: torch.device) -> dict:
    """Kernel B's instantiation at ``levels`` as built: {"registers": a
    thread, "local_bytes": local memory (spills) a thread}."""
    lib = _mixed_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(_index(dev)):
        err = lib.fvad_gru_mixed_attributes(*(LEVEL_CODES[level] for level in levels), ctypes.byref(regs),
                                            ctypes.byref(local))
    _build.check(lib, err, f"gru_mixed {levels} attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def _check_operand(what: str, name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if x.device != device or x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous float32 tensor of shape {shape} on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
        )
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned (the kernel reads float4s)")


def _check_net(what: str, net: NSNet2, biases: tuple, device: torch.device) -> None:
    """The recurrent weights and the bias triple the kernel reads."""
    if not (net.gru1.linear_before_reset and net.gru2.linear_before_reset):
        raise NotImplementedError(f"{what}: the CUDA GRU-stack kernel supports linear_before_reset=1 GRUs only")
    for name, w in zip(("wh1", "wi2", "wh2"), (net.gru1.wh, net.gru2.wi, net.gru2.wh)):
        _check_operand(what, name, w, (HIDDEN, G3), device)
    for name, b in zip(("bh1", "bi2", "bh2"), biases):
        _check_operand(what, name, b, (G3,), device)


def _check_state(what: str, state: tuple | None, n: int, device: torch.device) -> None:
    if state is None:
        return
    if len(state) != 2:
        raise ValueError(f"{what}: state must be (h1, h2)")
    for name, h in zip(("h1", "h2"), state):
        _check_operand(what, name, h, (n, HIDDEN), device)


def _launch(gi: tuple[int, int, int], gi_stride: int, shape: tuple[int, int], dev: torch.device,
            net: NSNet2, biases: tuple, out_dtype: torch.dtype, state: tuple | None = None,
            levels: tuple = ("highest", "highest")):
    """One launch of kernel 1 or, at mixed ``levels`` (gru_i, gru_h), of
    kernel B (gi1's columns only, float32 out) on checked operands: ``gi``
    the addresses of the z, r and n columns of row 0, step 0, each (row,
    step) ``gi_stride`` floats after the last -> (h2 [N, T, 400] in
    ``out_dtype`` (float32, or bf16 with h2 kept float32 inside), the final
    (h1, h2) in float32 where a ``state`` was carried in, else None).
    Counts nothing: each caller counts its own launches."""
    n, t = shape
    out = torch.empty((n, t, HIDDEN), dtype=out_dtype, device=dev)
    if n == 0 or t == 0:
        return out, state
    mixed = levels != ("highest", "highest")
    lib = _mixed_lib() if mixed else _lib()
    plan = device_plan(n, dev, levels)
    wh1, wi2, wh2 = packed_weights(net, levels)
    bh1, bi2, bh2 = biases
    bf16_out = out_dtype == torch.bfloat16
    # h1 of steps t-1 and t, then (bf16 out only) h2 of steps t-1 and t.
    scratch = torch.empty((4 if bf16_out else 2, n, HIDDEN), dtype=torch.float32, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    carried = (None, None) if state is None else (state[0].data_ptr(), state[1].data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mixed:
            # bf16 hi (| lo) of h1 and h2, steps t-1 and t, as the bf16 class reads them.
            split = torch.empty((2, 2, n, HIDDEN * (2 if "high" in levels else 1)), dtype=torch.bfloat16, device=dev)
            err = lib.fvad_gru_mixed(
                gi[0], wh1.data_ptr(), bh1.data_ptr(), wi2.data_ptr(), bi2.data_ptr(), wh2.data_ptr(),
                bh2.data_ptr(), out.data_ptr(), scratch.data_ptr(), split.data_ptr(), barrier.data_ptr(), *carried,
                *(LEVEL_CODES[level] for level in levels), n, t, plan.row_tile, plan.row_groups, plan.unit_groups,
                plan.grid, stream,
            )
        else:
            err = lib.fvad_gru_stack(
                *gi, wh1.data_ptr(), bh1.data_ptr(), wi2.data_ptr(), bi2.data_ptr(), wh2.data_ptr(), bh2.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), scratch[2].data_ptr() if bf16_out else None, barrier.data_ptr(),
                *carried, gi_stride, int(bf16_out), n, t, plan.row_tile, plan.row_groups, plan.unit_groups, plan.grid,
                stream,
            )
    _build.check(lib, err, "gru_mixed launch" if mixed else "gru_stack launch")
    if state is None:
        return out, None
    # The final h1 is in its ping-pong slot of the scratch; the final h2 in
    # out's last step (float32) or in its own slot (bf16 out).
    last = (t - 1) & 1
    return out, (scratch[last], scratch[2 + last] if bf16_out else out[:, -1].contiguous())


def gru_stack(net: NSNet2, gi1: torch.Tensor, state: tuple | None = None):
    """gi1 [N, T, 1200] -> h2 sequence [N, T, 400]; with ``state=(h1, h2)``
    ([N, 400] float32 each, contiguous) the steps continue it and the call
    returns (sequence, final (h1, h2)).

    A CPU tensor runs the plain version (at 'highest'); a CUDA tensor
    launches the kernel (and counts the launch in ``gru_stack.launches``)
    or raises, also where autograd records and an input or weight requires
    grad (``_build.refuse_grad``)."""
    return _run_stack(gru_stack, net, gi1, state, ("highest", "highest"))


def gru_stack_mixed(net: NSNet2, gi1: torch.Tensor, levels: tuple, state: tuple | None = None):
    """``gru_stack`` with its product classes at ``levels`` = (gru_i,
    gru_h), one of them 'highest' and the other 'high' or 'default' (the
    mixes of a stage override): h1 Wi2 at the first, h1 Wh1 and h2 Wh2 at
    the second. A CPU tensor runs ``gru_stack_reference`` at those levels;
    a CUDA tensor launches kernel B's instantiation for them
    (``csrc/gru_mixed.cu``, counted in ``gru_stack_mixed.launches``) or
    raises."""
    levels = tuple(levels)
    if len(levels) != 2 or "highest" not in levels or levels == ("highest", "highest") or any(
            level not in LEVEL_CODES for level in levels):
        raise ValueError(f"gru_stack_mixed: levels must pair 'highest' with 'high' or 'default', got {levels}")
    return _run_stack(gru_stack_mixed, net, gi1, state, levels)


def _run_stack(wrapper, net: NSNet2, gi1: torch.Tensor, state: tuple | None, levels: tuple):
    what = wrapper.__name__
    if gi1.device.type == "cpu":
        return gru_stack_reference(net, gi1, state=state, levels=levels)
    if gi1.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {gi1.device}")
    biases = (net.gru1.bh, net.gru2.bi, net.gru2.bh)
    _build.refuse_grad(what, gi1, *(state or ()), net.gru1.wh, net.gru2.wi, net.gru2.wh, *biases)
    _check_net(what, net, biases, gi1.device)
    if gi1.dim() != 3:
        raise ValueError(f"{what}: gi1 must be [N, T, {G3}], got {tuple(gi1.shape)}")
    n, t, _ = gi1.shape
    _check_operand(what, "gi1", gi1, (n, t, G3), gi1.device)
    _check_state(what, state, n, gi1.device)
    g = gi1.data_ptr()
    out, final = _launch((g, g + 4 * HIDDEN, g + 8 * HIDDEN), G3, (n, t), gi1.device, net, biases, torch.float32, state,
                         levels)
    if n and t:
        wrapper.launches += 1
    return out if state is None else (out, final)


gru_stack.launches = 0
gru_stack_mixed.launches = 0


def gru_stack_gates(net: NSNet2, gi: tuple, biases: tuple, out_dtype: torch.dtype, state: tuple | None = None):
    """The float32 forms of the per-gate kernels 4-6 (``nsnet2_gates_cuda``)
    on this kernel: CUDA tensors ``gi = (gi_z, gi_r, gi_n)``, each [N, T,
    400] float32, and the bias triple ``biases = (bh1, bi2, bh2)``
    (``nsnet2_gates_cuda.stacked_biases``) -> h2 [N, T, 400] in
    ``out_dtype`` (float32 or bf16); with ``state`` as ``gru_stack``'s ->
    (h2, final (h1, h2)). Raises on anything else. The launch is not
    counted here: the per-gate wrappers count their own."""
    what = "gru_stack_gates"
    dev = gi[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {dev}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    _build.refuse_grad(what, *gi, *(state or ()), net.gru1.wh, net.gru2.wi, net.gru2.wh, *biases)
    _check_net(what, net, biases, dev)
    if len(gi) != 3 or gi[0].dim() != 3:
        raise ValueError(f"{what}: gi must be three [N, T, {HIDDEN}] tensors")
    n, t, _ = gi[0].shape
    for name, x in zip(("gi_z", "gi_r", "gi_n"), gi):
        _check_operand(what, name, x, (n, t, HIDDEN), dev)
    _check_state(what, state, n, dev)
    out, final = _launch(tuple(x.data_ptr() for x in gi), HIDDEN, (n, t), dev, net, biases, out_dtype, state)
    return out if state is None else (out, final)
