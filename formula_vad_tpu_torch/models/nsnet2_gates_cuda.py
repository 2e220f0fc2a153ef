"""The per-gate NSNet2 GRU-stack recurrence in float32 and bf16: three CUDA
kernel wrappers and their plain versions.

Ports of the three TPU kernels of ``benchmarks/gru_kernel_exp.py``. They
compute one function, both GRU layers (hidden 400, ONNX z|r|n,
linear_before_reset = 1) stepped T times from h = 0 over the per-gate
layer-1 input projections ``gi_z, gi_r, gi_n [N, T, 400]`` (``gi_gates``:
bi1 + bh1 folded into z and r, bi1 only into n), and return the layer-2
hidden sequence ``h2 [N, T, 400]``. Given ``state=(h1, h2)`` ([N, 400]
float32 each, the low-latency mode's carried GRU state) the steps continue
it instead, and each returns ``(h2, final (h1, h2))`` with the final state
in float32; a call without a state is the stateless one, bit for bit.
With ``dtype`` bf16 the weights are
bf16, each h is rounded to bf16 before it enters a product, and the
products accumulate in float32; h1, h2 and the gate math stay float32. The
kernels differ in where else they round:

======================  =====================  =============  ==========================
wrapper                 replaces               gi operands    h2 out
======================  =====================  =============  ==========================
``gru_gates``           ``gru_stack_kernel``   cast to dtype  float32
``gru_gates_p``         ``gru_stack_kernel_p`` float32        float32
``gru_gates_f``         ``gru_stack_kernel_f`` cast to dtype  ``out_dtype`` (dtype)
======================  =====================  =============  ==========================

``gru_gates_p`` in bf16 is the bf16 precision tier's recurrence
(``NSNet2.forward`` at matmul precision 'default'): it rounds where the JAX
package's split3 scan does at single-pass bf16. ``gru_gates_f`` in bf16
with a bf16 out is the bf16 activation-storage tier's
(``precision.set_io_dtype("bf16")``). Its weights are packed as
the TPU kernel's, without the lane padding: ``wp1 = wh1`` [400, 1200] and
``wp2`` [800, 1600] whose h1 rows are ``wi2`` z | r | n_i | 0 and whose h2
rows are ``wh2`` z | r | 0 | n_h, so layer 2 is one product of
``[h1 | h2]``.

In float32 the three compute kernel 1's function (``nsnet2_cuda``), so
on the card they run on its kernel, ``csrc/gru_stack.cu``, through
``nsnet2_cuda.gru_stack_gates``: its packed weights, and its bias vectors
built once from the per-gate folding (``stacked_biases``). In bf16 CUDA
tensors go to one hand-written body, ``csrc/gru_gates_p.cu``: one
persistent cooperative launch per ``PLaunch`` of ``p_launch_plan``, each
CTA keeping one group of 16 hidden units' weights in shared memory for the
whole call. Its three instantiations differ in the gi type (float32 for
kernel 5, bf16 for kernels 4 and 6), the out type (float32, or
``out_dtype`` for kernel 6) and where float32 h2[t-1] lives (read back
from the float32 out in kernels 4 and 5; kernel 6 keeps it in shared
memory, as a bf16 out read back would round it every step). CPU tensors go
to the ``*_reference`` plain versions, per-step loops of ``torch.matmul``
on bf16-rounded operands held in float32 (TF32 off), which reproduce every
rounding point of their kernel. Weights are packed once per network and
dtype (``gate_weights``, cached on the module); the bf16 body reads
``wp1`` and ``wp2``'s non-zero blocks, which are exactly ``w9``, per unit
group in ``mma.sync`` fragment order (``pack_unit_groups``).

``gru_gates_3x`` (kernel A) is kernel 5's function at a level a product
class, (gru_i, gru_h) each 'default' (one bf16 pass) or 'high' (bf16_3x,
three): the 'high' tier's recurrence and its mixes with 'default'. Its
body, in the same source, owns 8 hidden units a CTA so that the bf16 hi
and lo halves of their weights fit in shared memory
(``pack_unit_groups_3x``, ``p_launch_plan(..., P3_UNITS)``), and runs the
50 CTAs of a row group in clusters of ``P3_CLUSTER`` that fetch each
tile's h from L2 once (``plan_exchange_bytes_3x``); its plain version is
``gru_gates_p_reference`` on the float32 weights at those levels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from ..ops import precision
from . import nsnet2_cuda
from .nsnet2 import HIDDEN, NSNet2, weights_key

H = HIDDEN
DTYPES = (torch.float32, torch.bfloat16)


# The bf16 body's tiling (csrc/gru_gates_p.cu): a CTA owns P_UNITS hidden
# units (one K step of h) and whole 16-row MMA tiles, at most P_MAX_TILES of
# them beside its P_W_BYTES of weights. P_TILE_BYTES: shared memory a tile,
# by kernel: its gi (float32 in kernel 5, bf16 in 4 and 6), its float32 h1
# and kernel 6's float32 h2.
P_UNITS = 16
P_UNIT_GROUPS = H // P_UNITS
P_ROWS = 16
P_MAX_TILES = 28
P_W_BYTES = 3 * H * 3 * P_UNITS * 2  # 3,600 bf16 a unit: 115,200 bytes a group
P_TILE_BYTES = {4: 1536 + 1024, 5: 3072 + 1024, 6: 1536 + 2 * 1024}
# Kernel A (``gru_gates_3x``, the same source): a CTA owns P3_UNITS units,
# whose hi and lo weights take P_W_BYTES too, beside a ring of P3_SLOTS
# stages of 18 KB and their three 8-byte mbarriers (P3_SMEM_BYTES at any
# row count). The 50 CTAs of a row group run in clusters of P3_CLUSTER;
# each of its P3_WARPS MMA warps takes a pair of tiles at a time where its
# CTA holds more than P3_WARPS tiles, else one.
P3_UNITS = 8
P3_CLUSTER = 5
P3_WARPS = 9
P3_SLOTS = 6
P3_SMEM_BYTES = P_W_BYTES + P3_SLOTS * (18432 + 3 * 8)
# Kernel A's bf16 passes a product class at each level: 1 = bf16, 3 = bf16_3x.
PASSES = {"default": 1, "high": 3}


@dataclasses.dataclass(frozen=True)
class GateWeights:
    """One network's recurrent weights packed for the three kernels in one
    dtype. ``w9`` [9, H, H]: wh1 z r n, wi2 z r n, wh2 z r n; ``wp1`` [H, 3H];
    ``wp2`` [2H, 4H]; ``b8`` [8, H] float32: bh1_n, bi2_z + bh2_z,
    bi2_r + bh2_r, bi2_n, bh2_n, 0, 0, 0. In bf16, ``units`` holds ``wp1``
    and the non-zero blocks of ``wp2`` (``w9``'s nine slabs) by unit group
    for the bf16 body of kernels 4-6 (``pack_unit_groups``)."""

    dtype: torch.dtype
    w9: torch.Tensor
    wp1: torch.Tensor
    wp2: torch.Tensor
    b8: torch.Tensor
    units: torch.Tensor | None = None


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """A bf16 [K, N] weight (K a multiple of 16, N of 8) in the order the
    kernel reads ``mma.sync.m16n8k16`` B fragments: int32 [N/8, K/16, 32, 2].
    Lane l = 4 g + t of (column tile n, K step s) holds, low half first,
    (w[16s + 2t, 8n + g], w[16s + 2t + 1, 8n + g]) in its first word and the
    same 8 rows further down in its second."""
    k, n = w.shape
    if w.dtype != torch.bfloat16 or k % 16 or n % 8:
        raise ValueError(f"pack_fragments: need a bf16 [16 a, 8 b] weight, got {tuple(w.shape)} {w.dtype}")
    x = w.contiguous().view(torch.int16).reshape(k // 16, 2, 4, 2, n // 8, 8)  # (s, half, t, pair, n, g)
    x = x.permute(4, 0, 5, 2, 1, 3).contiguous()  # (n, s, g, t, half, pair)
    return x.view(torch.int32).reshape(n // 8, k // 16, 32, 2)


def _group_columns(wp1: torch.Tensor, wp2: torch.Tensor, units: int) -> torch.Tensor:
    """[H // units, 3H, 3 units]: for each group of ``units`` hidden units,
    the K rows of wp1, wp2's h1 rows and its h2 rows, and its z, r and n
    columns (n_i in the h1 rows, n_h in the h2 rows: wp2's zero blocks left
    out)."""
    unit = torch.arange(H // units, device=wp1.device)[:, None] * units + torch.arange(units, device=wp1.device)

    def cols(bases):  # -> [groups, 3 units]: the group's units of each gate's columns
        return torch.cat([b + unit for b in bases], dim=1)

    return torch.cat([
        wp1[:, cols((0, H, 2 * H))],
        wp2[:H, cols((0, H, 2 * H))],
        wp2[H:, cols((0, H, 3 * H))],
    ]).permute(1, 0, 2)


def pack_unit_groups(wp1: torch.Tensor, wp2: torch.Tensor) -> torch.Tensor:
    """The bf16 weights of kernels 4-6 for ``csrc/gru_gates_p.cu``: int32
    [25, 75, 32, 12], one 115,200-byte block per group of 16 hidden units,
    which a CTA loads into shared memory once per call. K block kb (16 rows of K)
    runs over wp1's rows (kb < 25), wp2's h1 rows (25-49) and its h2 rows
    (50-74); its six n8 tiles are the group's z, r and n columns, 8 units
    each (the n columns of the h1 rows are n_i, of the h2 rows n_h: wp2's
    zero blocks are left out). Each lane's 12 words hold its
    ``pack_fragments`` words of the six tiles in order, so a lane reads a
    K step as three 16-byte loads."""
    if wp1.dtype != torch.bfloat16 or tuple(wp1.shape) != (H, 3 * H) or tuple(wp2.shape) != (2 * H, 4 * H):
        raise ValueError(f"pack_unit_groups: need bf16 wp1 [{H}, {3 * H}] and wp2 [{2 * H}, {4 * H}]")
    w = _group_columns(wp1, wp2, P_UNITS)  # [25, 3H, 48]
    frags = torch.stack([pack_fragments(group) for group in w])  # [25, 6, 75, 32, 2]
    return frags.permute(0, 2, 3, 1, 4).reshape(P_UNIT_GROUPS, 3 * H // 16, 32, 12).contiguous()


def pack_unit_groups_3x(wp1: torch.Tensor, wp2: torch.Tensor) -> torch.Tensor:
    """Kernel A's weights: int32 [50, 75, 32, 12], one 115,200-byte block
    per group of 8 hidden units. From float32 wp1 and wp2, each weight is
    split into hi = bf16(w) and lo = bf16(w - hi) on the host; K blocks as
    in ``pack_unit_groups``, and each lane's 12 words hold its
    ``pack_fragments`` words of the group's z, r and n tiles of hi, then
    of lo."""
    if wp1.dtype != torch.float32 or tuple(wp1.shape) != (H, 3 * H) or tuple(wp2.shape) != (2 * H, 4 * H):
        raise ValueError(f"pack_unit_groups_3x: need float32 wp1 [{H}, {3 * H}] and wp2 [{2 * H}, {4 * H}]")
    w = _group_columns(wp1, wp2, P3_UNITS)  # [50, 3H, 24]
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    frags = torch.stack([torch.cat([pack_fragments(a), pack_fragments(b)]) for a, b in zip(hi, lo)])  # [50, 6, 75, 32, 2]
    return frags.permute(0, 2, 3, 1, 4).reshape(H // P3_UNITS, 3 * H // 16, 32, 12).contiguous()


def fold_biases(net: NSNet2) -> torch.Tensor:
    """The per-gate kernels' biases b8 [8, H] float32: bh1_n,
    bi2_z + bh2_z, bi2_r + bh2_r, bi2_n, bh2_n, 0, 0, 0."""
    g1, g2 = net.gru1, net.gru2
    return torch.stack(
        [g1.bh[2 * H :], g2.bi[:H] + g2.bh[:H], g2.bi[H : 2 * H] + g2.bh[H : 2 * H], g2.bi[2 * H :], g2.bh[2 * H :]]
        + [g2.bh.new_zeros(H)] * 3
    ).contiguous()


def pack(net: NSNet2, dtype: torch.dtype) -> GateWeights:
    """Pack ``net``'s recurrent weights for the kernels, in ``dtype``."""
    if dtype not in DTYPES:
        raise ValueError(f"gru_gates: dtype must be one of {DTYPES}, got {dtype}")
    g1, g2 = net.gru1, net.gru2

    def slabs(w):  # [H, 3H] -> z, r, n [H, H]
        return [w[:, :H], w[:, H : 2 * H], w[:, 2 * H :]]

    w9 = torch.stack(slabs(g1.wh) + slabs(g2.wi) + slabs(g2.wh)).to(dtype).contiguous()
    zero = g2.wi.new_zeros((H, H))
    (iz, ir, in_), (hz, hr, hn) = slabs(g2.wi), slabs(g2.wh)
    wp2 = torch.cat([torch.cat([iz, ir, in_, zero], dim=1), torch.cat([hz, hr, zero, hn], dim=1)])
    gw = GateWeights(dtype, w9, g1.wh.to(dtype).contiguous(), wp2.to(dtype).contiguous(), fold_biases(net))
    if dtype == torch.bfloat16:
        gw = dataclasses.replace(gw, units=pack_unit_groups(gw.wp1, gw.wp2))
    return gw


def _cached(net: NSNet2, slot, build):
    """``build()``, cached on the module under ``slot`` and redone when its
    weights move (``net.to``), are replaced, or are written in place
    (``nsnet2.weights_key``)."""
    key = weights_key(net)
    cache = net.__dict__.setdefault("_gates_cache", {})
    hit = cache.get(slot)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = cache[slot] = (key, build())
    return hit[1]


def gate_weights(net: NSNet2, dtype: torch.dtype) -> GateWeights:
    """``pack(net, dtype)``, cached on the module (``_cached``)."""
    return _cached(net, dtype, lambda: pack(net, dtype))


def stacked_biases(net: NSNet2) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 forms' biases on the card: kernel 1's bias vectors (bh1,
    bi2, bh2), each [3H], built from the per-gate folding b8
    (``fold_biases``): bh1 = [0, 0, bh1_n], bi2 = [bi2_z + bh2_z,
    bi2_r + bh2_r, bi2_n], bh2 = [0, 0, bh2_n]. Kernel 1 sums
    gi_z + (h1 Wh1z + bh1_z) and h1 Wi2z + h2 Wh2z + (bi2_z + bh2_z); with
    these vectors, and gi from ``gi_gates``, its gate sums are the per-gate
    forms' term for term, as adding 0.0 is exact. Cached on the module
    (``_cached``)."""

    def build():
        b8 = fold_biases(net)
        zero = b8.new_zeros(H)
        return torch.cat([zero, zero, b8[0]]), torch.cat([b8[1], b8[2], b8[3]]), torch.cat([zero, zero, b8[4]])

    return _cached(net, "stacked_biases", build)


def gi_gates(net: NSNet2, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-gate layer-1 input projections of the fc_in output ``x`` [..., T,
    400] with the step-invariant biases folded (``_gi_gates`` of the TPU
    tool): z and r see x wi + bi + h wh + bh, so bi + bh fold here; the n
    gate's bh1_n sits inside r1 (..), so only bi1_n does. The product runs
    at stage 'gru_i''s precision, on weights in the activation-storage
    dtype (a bf16 product of a bf16 ``x``); the three come out contiguous,
    in float32 (the folded biases are)."""
    g1 = net.gru1
    gi1 = precision.matmul(x, precision.io_cast(g1.wi), "gru_i")
    gi_z = gi1[..., :H] + (g1.bi[:H] + g1.bh[:H])
    gi_r = gi1[..., H : 2 * H] + (g1.bi[H : 2 * H] + g1.bh[H : 2 * H])
    gi_n = gi1[..., 2 * H :] + g1.bi[2 * H :]
    return gi_z.contiguous(), gi_r.contiguous(), gi_n.contiguous()


# --------------------------------------------------------------- plain versions


def _rounder(dtype: torch.dtype):
    return (lambda x: x) if dtype == torch.float32 else precision.bf16_round


def _initial(gi: torch.Tensor, state: tuple | None) -> tuple[torch.Tensor, torch.Tensor]:
    if state is not None:
        return state
    zero = gi.new_zeros((gi.shape[0], H), dtype=torch.float32)
    return zero, zero


def _finish(ys: list, gi: torch.Tensor, state: tuple | None, h1, h2):
    """The stacked sequence, and the final state where one was carried in."""
    out = torch.stack(ys, dim=1) if ys else gi.new_zeros((gi.shape[0], 0, H), dtype=torch.float32)
    return out if state is None else (out, (h1, h2))


def _run_w9(gw: GateWeights, gi_z, gi_r, gi_n, state: tuple | None = None):
    """Kernels 4 and 6: per-gate slabs, gi and each h rounded to the dtype."""
    q = _rounder(gw.dtype)
    w, b = gw.w9.float(), gw.b8
    gz, gr, gn = q(gi_z), q(gi_r), q(gi_n)
    h1, h2 = _initial(gz, state)
    ys = []
    for t in range(gz.shape[1]):
        h1d = q(h1)
        z1 = torch.sigmoid(gz[:, t] + h1d @ w[0])
        r1 = torch.sigmoid(gr[:, t] + h1d @ w[1])
        n1 = torch.tanh(gn[:, t] + r1 * (h1d @ w[2] + b[0]))
        h1 = (1.0 - z1) * n1 + z1 * h1
        h1d, h2d = q(h1), q(h2)
        z2 = torch.sigmoid(h1d @ w[3] + h2d @ w[6] + b[1])
        r2 = torch.sigmoid(h1d @ w[4] + h2d @ w[7] + b[2])
        n2 = torch.tanh((h1d @ w[5] + b[3]) + r2 * (h2d @ w[8] + b[4]))
        h2 = (1.0 - z2) * n2 + z2 * h2
        ys.append(h2)
    return _finish(ys, gz, state, h1, h2)


def gru_gates_reference(gw: GateWeights, gi_z, gi_r, gi_n, state: tuple | None = None):
    """Plain version of kernel 4: -> h2 [N, T, H] float32 (and the final
    state, with ``state``)."""
    return _run_w9(gw, gi_z, gi_r, gi_n, state)


def gru_gates_p_reference(gw: GateWeights, gi_z, gi_r, gi_n, state: tuple | None = None,
                          levels: tuple | None = None):
    """Plain version of kernels 5 and A: gi stays float32; one product per
    layer, ``h1 @ wp1`` and ``[h1 | h2] @ wp2`` -> h2 [N, T, H] float32 (and
    the final state, with ``state``). Each product runs at its class's
    level (``precision.matmul``), ``levels`` = (gru_i: wp2's h1 rows,
    gru_h: wp1 and wp2's h2 rows); by default both at the weights' dtype,
    'highest' in float32 and 'default' (bf16 operands) in bf16. Kernel A's
    levels, 'high' among them, need float32 weights, whose bf16 halves the
    products split."""
    if levels is None:
        levels = ("highest",) * 2 if gw.dtype == torch.float32 else ("default",) * 2
    level_i, level_h = levels
    wp1, wp2, b = gw.wp1.float(), gw.wp2.float(), gw.b8
    h1, h2 = _initial(gi_z, state)
    ys = []
    for t in range(gi_z.shape[1]):
        g1 = precision.matmul(h1, wp1, level=level_h)
        z1 = torch.sigmoid(gi_z[:, t] + g1[:, :H])
        r1 = torch.sigmoid(gi_r[:, t] + g1[:, H : 2 * H])
        n1 = torch.tanh(gi_n[:, t] + r1 * (g1[:, 2 * H :] + b[0]))
        h1 = (1.0 - z1) * n1 + z1 * h1
        if level_i == level_h:
            g2 = precision.matmul(torch.cat([h1, h2], dim=1), wp2, level=level_h)
        else:
            g2 = precision.matmul(h1, wp2[:H], level=level_i) + precision.matmul(h2, wp2[H:], level=level_h)
        z2 = torch.sigmoid(g2[:, :H] + b[1])
        r2 = torch.sigmoid(g2[:, H : 2 * H] + b[2])
        n2 = torch.tanh((g2[:, 2 * H : 3 * H] + b[3]) + r2 * (g2[:, 3 * H :] + b[4]))
        h2 = (1.0 - z2) * n2 + z2 * h2
        ys.append(h2)
    return _finish(ys, gi_z, state, h1, h2)


def gru_gates_f_reference(gw: GateWeights, gi_z, gi_r, gi_n, out_dtype: torch.dtype | None = None,
                          state: tuple | None = None):
    """Plain version of kernel 6: kernel 4's arithmetic, h2 stored in
    ``out_dtype`` (default: the weight dtype) -> [N, T, H] ``out_dtype``
    (and the final float32 state, with ``state``). Its ``tile`` changes no
    bit, so the plain version has none."""
    out = _run_w9(gw, gi_z, gi_r, gi_n, state)
    if state is None:
        return out.to(out_dtype or gw.dtype)
    return out[0].to(out_dtype or gw.dtype), out[1]


# --------------------------------------------------------------- wrappers


@dataclasses.dataclass(frozen=True)
class PLaunch:
    """One cooperative launch of the bf16 body (``csrc/gru_gates_p.cu``)
    over rows ``row0`` .. ``row0 + n_rows``: ``tiles`` 16-row tiles in
    ``row_groups`` groups of ``tiles_per_group`` (the last may hold fewer),
    times the 25 unit groups. CTA b owns unit group b % 25 and row group b // 25."""

    row0: int
    n_rows: int
    tiles: int
    row_groups: int
    tiles_per_group: int
    units: int = P_UNITS

    @property
    def grid(self) -> int:
        return H // self.units * self.row_groups

    def smem_bytes(self, kind) -> int:
        """Dynamic shared memory of a CTA of kernel ``kind`` (4, 5, 6, or "A")."""
        return P3_SMEM_BYTES if kind == "A" else P_W_BYTES + self.tiles_per_group * P_TILE_BYTES[kind]

    def cta_span(self, block: int) -> tuple[range, range]:
        """The rows (of the whole call) and the hidden units of CTA ``block``."""
        rg, ug = divmod(block, H // self.units)
        first = rg * self.tiles_per_group * P_ROWS
        rows = range(self.row0 + first, self.row0 + min(first + self.tiles_per_group * P_ROWS, self.n_rows))
        return rows, range(ug * self.units, (ug + 1) * self.units)


def p_launch_plan(n_rows: int, sm_count: int, units: int = P_UNITS) -> tuple[PLaunch, ...]:
    """The bf16 body's launches for ``n_rows`` rows on a card of ``sm_count``
    SMs, the same for kernels 4, 5 and 6 (one CTA a SM: its weights take
    half the SM's shared memory, and P_MAX_TILES tiles of kernel 5, the
    largest, fit beside them). A launch is one wave: ``sm_count // 25``
    row groups beside the 25 unit groups, each of at most P_MAX_TILES
    16-row tiles. The tiles are spread evenly over as few launches as that
    allows, and over the row groups of each (1,680 rows on 132 SMs: one
    launch, 5 row groups of 21 tiles, 125 CTAs). Rows are independent, so a
    row's bits do not depend on the plan. ``units`` = P3_UNITS plans
    kernel A: 50 unit groups, no limit on a CTA's tiles (its shared memory
    does not grow with them), so one launch; a group above P3_WARPS tiles
    holds an even number, so that its pairs of tiles start on even tiles
    (1,680 rows on 132 SMs: 2 row groups of 54 and 51 tiles, 100 CTAs)."""
    if units not in (P_UNITS, P3_UNITS):
        raise ValueError(f"p_launch_plan: units must be {P_UNITS} or {P3_UNITS}, got {units}")
    groups = P_UNIT_GROUPS if units == P_UNITS else H // P3_UNITS
    if n_rows < 1 or sm_count < groups:
        raise ValueError(f"p_launch_plan: need n_rows >= 1 and sm_count >= {groups}, got {n_rows}, {sm_count}")
    slots = sm_count // groups
    tiles = -(-n_rows // P_ROWS)
    if units == P3_UNITS:
        per = -(-tiles // min(slots, tiles))
        per += per % 2 if per > P3_WARPS else 0
        return (PLaunch(0, n_rows, tiles, -(-tiles // per), per, units),)
    n_launches = -(-tiles // (slots * P_MAX_TILES))
    base, extra = divmod(tiles, n_launches)
    launches, tile0 = [], 0
    for i in range(n_launches):
        here = base + (i < extra)
        per = -(-here // min(slots, here))
        row0 = tile0 * P_ROWS
        launches.append(PLaunch(row0, min(here * P_ROWS, n_rows - row0), here, -(-here // per), per, units))
        tile0 += here
    return tuple(launches)


@functools.cache  # called once per forward on the bf16 tier: keep the lookup off that path
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_gates_p")
    lib.fvad_gru_gates_p.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fvad_gru_gates_p.restype = ctypes.c_int
    lib.fvad_gru_gates_p_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.fvad_gru_gates_p_smem_bytes.restype = ctypes.c_int
    lib.fvad_gru_gates_3x.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fvad_gru_gates_3x.restype = ctypes.c_int
    for name in ("fvad_gru_gates_3x_smem_bytes", "fvad_gru_gates_3x_cluster"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_p_plan(n_rows: int, dev: torch.device, units: int = P_UNITS) -> tuple[PLaunch, ...]:
    """``p_launch_plan`` for the card ``dev``."""
    return p_launch_plan(n_rows, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()), units)


def _check(what: str, name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
        )
    if device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned on the card")


def _operands(what: str, net: NSNet2, gi: tuple, dtype: torch.dtype, gi_dtype, state: tuple | None = None) -> tuple:
    """Validate gi and the carried state; -> gi cast to the kernel's gi dtype."""
    if not (net.gru1.linear_before_reset and net.gru2.linear_before_reset):
        raise NotImplementedError(f"{what}: the per-gate GRU kernels support linear_before_reset=1 GRUs only")
    if dtype not in DTYPES:
        raise ValueError(f"{what}: dtype must be one of {DTYPES}, got {dtype}")
    dev = gi[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if gi[0].dim() != 3 or gi[0].shape[-1] != H:
        raise ValueError(f"{what}: gi must be [N, T, {H}], got {tuple(gi[0].shape)}")
    gi = tuple(x.to(gi_dtype) for x in gi)
    for name, x in zip(("gi_z", "gi_r", "gi_n"), gi):
        _check(what, name, x, gi_dtype, tuple(gi[0].shape), dev)
    if state is not None:
        if len(state) != 2:
            raise ValueError(f"{what}: state must be (h1, h2)")
        for name, h in zip(("h1", "h2"), state):
            _check(what, name, h, torch.float32, (gi[0].shape[0], H), dev)
    return gi


def _check_weights(what: str, dev: torch.device, **weights: torch.Tensor) -> None:
    for name, w in weights.items():
        if w.device != dev:
            raise ValueError(f"{what}: weight {name} is on {w.device}, gi on {dev}")


_P_BARRIERS: dict = {}


def _p_barrier(dev: torch.device, stream: int) -> torch.Tensor:
    """The bf16 body's barrier counters for launches on ``stream`` of card
    ``dev``: one 128-byte line a row group, zeroed once. The kernel leaves
    them zero at exit, so launches in order on one stream share them and no
    call fills them; each stream has its own, as launches on two streams may
    run at once. Under CUDA-graph capture the fill is captured with the
    launch instead."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((_sm_count(dev.index) // P_UNIT_GROUPS, 32), dtype=torch.int32, device=dev)
    key = (dev.index, stream)
    if key not in _P_BARRIERS:
        _P_BARRIERS[key] = torch.zeros((_sm_count(dev.index) // P_UNIT_GROUPS, 32), dtype=torch.int32, device=dev)
    return _P_BARRIERS[key]


def _launch_p(wrapper, kind: int, gw: GateWeights, gi: tuple, out_dtype: torch.dtype, state: tuple | None = None):
    """The bf16 form of kernel ``kind`` (``csrc/gru_gates_p.cu``): one
    cooperative launch per ``PLaunch`` of the card's plan, each on its rows'
    slice of gi, out and the carried state with its own exchange buffers
    (``torch.empty``: no fill), all on the stream's barrier counters
    (``_p_barrier``). Each launch is counted in ``wrapper.launches``; one
    the card refuses raises. -> out, and with ``state`` (out, final (h1,
    h2)): h1 written by the kernel, h2 too for kernel 6, else out's last
    step (float32)."""
    n, t, _ = gi[0].shape
    dev = gi[0].device
    what = f"{wrapper.__name__} kernel {kind}"
    _check_weights(what, dev, units=gw.units, b8=gw.b8)
    out = torch.empty((n, t, H), dtype=out_dtype, device=dev)
    final = None
    if state is not None:
        final = tuple(torch.empty((n, H), dtype=torch.float32, device=dev) for _ in range(2 if kind == 6 else 1))
    lib = _lib()
    flags = (int(gw.dtype == torch.bfloat16), int(gi[0].dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        barrier = _p_barrier(dev, stream)
        for launch in device_p_plan(n, dev):
            # x1 and x2, each [2 ping-pong][tiles][25 K steps][32 lanes] x 16 bytes.
            x = torch.empty((2, 2, launch.tiles, H // 16, 32, 4), dtype=torch.int32, device=dev)
            rows = slice(launch.row0, launch.row0 + launch.n_rows)
            carried = (None,) * 4
            if state is not None:
                carried = (*(h[rows].data_ptr() for h in state), final[0][rows].data_ptr(),
                           final[1][rows].data_ptr() if kind == 6 else None)
            err = lib.fvad_gru_gates_p(
                kind, *flags, *(g[rows].data_ptr() for g in gi), gw.units.data_ptr(), gw.b8.data_ptr(),
                out[rows].data_ptr(), x[0].data_ptr(), x[1].data_ptr(), barrier.data_ptr(), *carried,
                launch.n_rows, t, launch.tiles, launch.row_groups, launch.tiles_per_group, stream,
            )
            _build.check(lib, err, f"{what} launch")
            wrapper.launches += 1
    if state is None:
        return out
    return out, (final[0], final[1] if kind == 6 else out[:, -1].contiguous())


def units_3x(net: NSNet2) -> torch.Tensor:
    """``pack_unit_groups_3x`` of the network's float32 wp1 and wp2, cached
    on the module (``_cached``)."""

    def build():
        gw = gate_weights(net, torch.float32)
        return pack_unit_groups_3x(gw.wp1, gw.wp2)

    return _cached(net, "units_3x", build)


def _launch_3x(wrapper, net: NSNet2, gi: tuple, passes: tuple, state: tuple | None = None):
    """Kernel A (``csrc/gru_gates_p.cu``, ``fvad_gru_gates_3x``): the one
    cooperative cluster launch of the card's 8-unit plan, with its exchange
    buffers (hi and lo of h), on the stream's barrier counters, counted in
    ``wrapper.launches``. -> out, and with ``state`` (out, final (h1, h2)):
    h1 the kernel's running h1, h2 out's last step."""
    n, t, _ = gi[0].shape
    dev = gi[0].device
    units, b8 = units_3x(net), gate_weights(net, torch.float32).b8
    _check_weights(wrapper.__name__, dev, units=units, b8=b8)
    out = torch.empty((n, t, H), dtype=torch.float32, device=dev)
    h1 = torch.empty((n, H), dtype=torch.float32, device=dev)  # the running h1: scratch, or the final h1
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        barrier = _p_barrier(dev, stream)
        (launch,) = device_p_plan(n, dev, P3_UNITS)
        # xh, xl, each [2 ping-pong][50 K steps: h1, h2][pairs of tiles][2 tiles][32 lanes] x 16 bytes.
        x = torch.empty((2, 2, 2 * H // 16, -(-launch.tiles // 2), 2, 32, 4), dtype=torch.int32, device=dev)
        carried = (None,) * 2 if state is None else tuple(h.data_ptr() for h in state)
        err = lib.fvad_gru_gates_3x(
            *passes, *(g.data_ptr() for g in gi), units.data_ptr(), b8.data_ptr(), out.data_ptr(),
            x[0].data_ptr(), x[1].data_ptr(), h1.data_ptr(), barrier.data_ptr(), *carried,
            n, t, launch.tiles, launch.row_groups, launch.tiles_per_group, stream,
        )
        _build.check(lib, err, f"{wrapper.__name__} launch")
        wrapper.launches += 1
    return out if state is None else (out, (h1, out[:, -1].contiguous()))


def plan_exchange_bytes_3x(n_rows: int, n_steps: int, levels: tuple, carried: bool = False,
                           cluster: int = P3_CLUSTER) -> int:
    """The plan's count, not a measurement, of the L2 bytes that kernel A's
    CTAs read from the exchange of h in one call of ``n_rows`` x
    ``n_steps``: every tile is fetched once a step by each
    cluster of ``cluster`` CTAs of its row group's 50 (1: by every CTA, the
    first design). A tile's K step is 512 bytes of hi, and as much of lo
    for a class at 'high'; a step reads h1[t-1] (gru_h), h1[t] (gru_i) and
    h2[t-1] (gru_h), but step 0 from h = 0 only h1[0]."""
    level_i, level_h = levels
    width = {level: 512 * 25 * (2 if PASSES[level] == 3 else 1) for level in levels}
    first = width[level_i] + (2 * width[level_h] if carried else 0)
    rest = width[level_i] + 2 * width[level_h]
    return -(-n_rows // P_ROWS) * (H // P3_UNITS // cluster) * (first + (n_steps - 1) * rest)


def _launch(wrapper, kind: int, net: NSNet2, gi: tuple, dtype: torch.dtype, out_dtype: torch.dtype,
            state: tuple | None = None):
    """Run kernel ``kind`` in ``dtype`` on the card and count its launches
    in ``wrapper.launches``: float32 on kernel 1's kernel
    (``nsnet2_cuda.gru_stack_gates``, one launch), bf16 on the bf16 body
    (``_launch_p``, one count a cooperative launch). Raises where autograd
    records and gi, the state or a GRU weight requires grad
    (``_build.refuse_grad``)."""
    _build.refuse_grad(wrapper.__name__, *gi, *(state or ()), *net.gru1.parameters(), *net.gru2.parameters())
    n, t, _ = gi[0].shape
    if n == 0 or t == 0:
        out = torch.empty((n, t, H), dtype=out_dtype, device=gi[0].device)
        return out if state is None else (out, state)
    if dtype == torch.bfloat16:
        return _launch_p(wrapper, kind, gate_weights(net, dtype), gi, out_dtype, state)
    out = nsnet2_cuda.gru_stack_gates(net, gi, stacked_biases(net), out_dtype, state)
    wrapper.launches += 1
    return out


def gru_gates(net: NSNet2, gi_z, gi_r, gi_n, dtype: torch.dtype = torch.float32, state: tuple | None = None):
    """Kernel 4: gi [N, T, H] (cast to ``dtype``) -> h2 [N, T, H] float32;
    with ``state`` -> (h2, final (h1, h2)).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises. ``gru_gates.launches`` counts launches: one a call in
    float32; in bf16 one a ``PLaunch`` of ``device_p_plan`` (more than one
    above 2,240 rows on 132 SMs)."""
    gi = _operands("gru_gates", net, (gi_z, gi_r, gi_n), dtype, dtype, state)
    if gi[0].device.type == "cpu":
        return gru_gates_reference(gate_weights(net, dtype), *gi, state=state)
    return _launch(gru_gates, 4, net, gi, dtype, torch.float32, state)


def gru_gates_p(net: NSNet2, gi_z, gi_r, gi_n, dtype: torch.dtype = torch.float32, state: tuple | None = None):
    """Kernel 5: float32 gi [N, T, H] -> h2 [N, T, H] float32; with
    ``state`` -> (h2, final (h1, h2)).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises. ``gru_gates_p.launches`` counts launches: one a call in
    float32; in bf16 one a ``PLaunch`` of ``device_p_plan`` (more than one
    above 2,240 rows on 132 SMs)."""
    gi = _operands("gru_gates_p", net, (gi_z, gi_r, gi_n), dtype, torch.float32, state)
    if gi[0].device.type == "cpu":
        return gru_gates_p_reference(gate_weights(net, dtype), *gi, state=state)
    return _launch(gru_gates_p, 5, net, gi, dtype, torch.float32, state)


def gru_gates_f(
    net: NSNet2, gi_z, gi_r, gi_n, dtype: torch.dtype = torch.float32,
    tile: int | None = None, out_dtype: torch.dtype | None = None, state: tuple | None = None,
):
    """Kernel 6: gi [N, T, H] (cast to ``dtype``) -> h2 [N, T, H] in
    ``out_dtype`` (default ``dtype``); with ``state`` -> (h2, final (h1,
    h2) in float32). ``tile`` rows per grid slice (default
    all) is the TPU kernel's schedule knob: it changes no bit of the result.
    It is validated, and the card's launch plan ignores it in both forms
    (``nsnet2_cuda.launch_plan`` in float32, ``p_launch_plan`` in bf16).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises. ``gru_gates_f.launches`` counts launches as
    ``gru_gates.launches`` does."""
    out_dtype = out_dtype or dtype
    if out_dtype not in DTYPES:
        raise ValueError(f"gru_gates_f: out_dtype must be one of {DTYPES}, got {out_dtype}")
    gi = _operands("gru_gates_f", net, (gi_z, gi_r, gi_n), dtype, dtype, state)
    if tile is not None and tile < 1:
        raise ValueError(f"gru_gates_f: tile must be a positive number of rows, got {tile}")
    if gi[0].device.type == "cpu":
        return gru_gates_f_reference(gate_weights(net, dtype), *gi, out_dtype=out_dtype, state=state)
    return _launch(gru_gates_f, 6, net, gi, dtype, out_dtype, state)


def gru_gates_3x(net: NSNet2, gi_z, gi_r, gi_n, levels: tuple, state: tuple | None = None):
    """Kernel A: kernel 5's function with float32 gi [N, T, H] -> h2 [N, T,
    H] float32 (with ``state`` -> (h2, final (h1, h2))), its products at
    ``levels`` = (gru_i: wp2's h1 rows, gru_h: wp1 and wp2's h2 rows), each
    'default' (one bf16 pass) or 'high' (bf16_3x, three), not both
    'default' (that is ``gru_gates_p`` in bf16).

    A CPU tensor runs the plain version, ``gru_gates_p_reference`` on the
    float32 weights at those levels; a CUDA tensor launches the kernel or
    raises. ``gru_gates_3x.launches`` counts launches: one a call (the
    8-unit plan is one ``PLaunch`` at any row count)."""
    levels = tuple(levels)
    if len(levels) != 2 or levels == ("default", "default") or any(level not in PASSES for level in levels):
        raise ValueError(f"gru_gates_3x: levels must pair 'default' and 'high', not both 'default', got {levels}")
    gi = _operands("gru_gates_3x", net, (gi_z, gi_r, gi_n), torch.float32, torch.float32, state)
    if gi[0].device.type == "cpu":
        return gru_gates_p_reference(gate_weights(net, torch.float32), *gi, state=state, levels=levels)
    _build.refuse_grad("gru_gates_3x", *gi, *(state or ()), *net.gru1.parameters(), *net.gru2.parameters())
    n, t, _ = gi[0].shape
    if n == 0 or t == 0:
        out = torch.empty((n, t, H), dtype=torch.float32, device=gi[0].device)
        return out if state is None else (out, state)
    return _launch_3x(gru_gates_3x, net, gi, tuple(PASSES[level] for level in levels), state)


gru_gates.launches = 0
gru_gates_p.launches = 0
gru_gates_f.launches = 0
gru_gates_3x.launches = 0
