"""The per-gate NSNet2 GRU-stack recurrence in float32 and bf16: three CUDA
kernel wrappers and their plain versions.

Ports of the three TPU kernels of ``benchmarks/gru_kernel_exp.py``. They
compute one function, both GRU layers (hidden 400, ONNX z|r|n,
linear_before_reset = 1) stepped T times from h = 0 over the per-gate
layer-1 input projections ``gi_z, gi_r, gi_n [N, T, 400]`` (``gi_gates``:
bi1 + bh1 folded into z and r, bi1 only into n), and return the layer-2
hidden sequence ``h2 [N, T, 400]``. With ``dtype`` bf16 the weights are
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
package's split3 scan does at single-pass bf16. Its weights are packed as
the TPU kernel's, without the lane padding: ``wp1 = wh1`` [400, 1200] and
``wp2`` [800, 1600] whose h1 rows are ``wi2`` z | r | n_i | 0 and whose h2
rows are ``wh2`` z | r | 0 | n_h, so layer 2 is one product of
``[h1 | h2]``.

In float32 the three compute kernel 1's function (``nsnet2_cuda``), so
on the card they run on its kernel, ``csrc/gru_stack.cu``, through
``nsnet2_cuda.gru_stack_gates``: its packed weights, and its bias vectors
built once from the per-gate folding (``stacked_biases``). In bf16 CUDA
tensors go to the kernels in ``csrc/gru_gates.cu``. CPU tensors go to the
``*_reference`` plain versions, per-step loops of ``torch.matmul`` on
bf16-rounded operands held in float32 (TF32 off), which reproduce every
rounding point of their kernel. Weights are packed once per network and
dtype (``gate_weights``, cached on the module); a bf16 kernel reads them in
``mma.sync`` fragment order (``pack_fragments``).
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


@dataclasses.dataclass(frozen=True)
class GateWeights:
    """One network's recurrent weights packed for the three kernels in one
    dtype. ``w9`` [9, H, H]: wh1 z r n, wi2 z r n, wh2 z r n; ``wp1`` [H, 3H];
    ``wp2`` [2H, 4H]; ``b8`` [8, H] float32: bh1_n, bi2_z + bh2_z,
    bi2_r + bh2_r, bi2_n, bh2_n, 0, 0, 0. In bf16, ``frag9``, ``frag1`` and
    ``frag2`` hold ``w9``, ``wp1`` and ``wp2`` in fragment order."""

    dtype: torch.dtype
    w9: torch.Tensor
    wp1: torch.Tensor
    wp2: torch.Tensor
    b8: torch.Tensor
    frag9: torch.Tensor | None = None
    frag1: torch.Tensor | None = None
    frag2: torch.Tensor | None = None


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
        gw = dataclasses.replace(
            gw,
            frag9=torch.stack([pack_fragments(w) for w in gw.w9]),
            frag1=pack_fragments(gw.wp1),
            frag2=pack_fragments(gw.wp2),
        )
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
    at stage 'gru_i''s precision; the three come out contiguous."""
    g1 = net.gru1
    gi1 = precision.matmul(x, g1.wi, "gru_i")
    gi_z = gi1[..., :H] + (g1.bi[:H] + g1.bh[:H])
    gi_r = gi1[..., H : 2 * H] + (g1.bi[H : 2 * H] + g1.bh[H : 2 * H])
    gi_n = gi1[..., 2 * H :] + g1.bi[2 * H :]
    return gi_z.contiguous(), gi_r.contiguous(), gi_n.contiguous()


# --------------------------------------------------------------- plain versions


def _rounder(dtype: torch.dtype):
    return (lambda x: x) if dtype == torch.float32 else precision.bf16_round


def _run_w9(gw: GateWeights, gi_z, gi_r, gi_n) -> torch.Tensor:
    """Kernels 4 and 6: per-gate slabs, gi and each h rounded to the dtype."""
    q = _rounder(gw.dtype)
    w, b = gw.w9.float(), gw.b8
    gz, gr, gn = q(gi_z), q(gi_r), q(gi_n)
    h1 = h2 = gz.new_zeros((gz.shape[0], H))
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
    return torch.stack(ys, dim=1)


def gru_gates_reference(gw: GateWeights, gi_z, gi_r, gi_n) -> torch.Tensor:
    """Plain version of kernel 4: -> h2 [N, T, H] float32."""
    return _run_w9(gw, gi_z, gi_r, gi_n)


def gru_gates_p_reference(gw: GateWeights, gi_z, gi_r, gi_n) -> torch.Tensor:
    """Plain version of kernel 5: gi stays float32; one product per layer,
    ``h1 @ wp1`` and ``[h1 | h2] @ wp2`` -> h2 [N, T, H] float32."""
    q = _rounder(gw.dtype)
    wp1, wp2, b = gw.wp1.float(), gw.wp2.float(), gw.b8
    h1 = h2 = gi_z.new_zeros((gi_z.shape[0], H))
    ys = []
    for t in range(gi_z.shape[1]):
        g1 = q(h1) @ wp1
        z1 = torch.sigmoid(gi_z[:, t] + g1[:, :H])
        r1 = torch.sigmoid(gi_r[:, t] + g1[:, H : 2 * H])
        n1 = torch.tanh(gi_n[:, t] + r1 * (g1[:, 2 * H :] + b[0]))
        h1 = (1.0 - z1) * n1 + z1 * h1
        g2 = q(torch.cat([h1, h2], dim=1)) @ wp2
        z2 = torch.sigmoid(g2[:, :H] + b[1])
        r2 = torch.sigmoid(g2[:, H : 2 * H] + b[2])
        n2 = torch.tanh((g2[:, 2 * H : 3 * H] + b[3]) + r2 * (g2[:, 3 * H :] + b[4]))
        h2 = (1.0 - z2) * n2 + z2 * h2
        ys.append(h2)
    return torch.stack(ys, dim=1)


def gru_gates_f_reference(gw: GateWeights, gi_z, gi_r, gi_n, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of kernel 6: kernel 4's arithmetic, h2 stored in
    ``out_dtype`` (default: the weight dtype) -> [N, T, H] ``out_dtype``.
    Its ``tile`` changes no bit, so the plain version has none."""
    return _run_w9(gw, gi_z, gi_r, gi_n).to(out_dtype or gw.dtype)


# --------------------------------------------------------------- wrappers


@functools.cache  # called once per forward on the bf16 tier: keep the lookup off that path
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_gates")
    lib.fvad_gru_gates.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fvad_gru_gates.restype = ctypes.c_int
    return lib


def _check(what: str, name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
        )
    if device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned on the card")


def _operands(what: str, net: NSNet2, gi: tuple, dtype: torch.dtype, gi_dtype) -> tuple:
    """Validate; -> gi cast to the kernel's gi dtype."""
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
    return gi


def _launch_bf16(kind: int, gw: GateWeights, gi: tuple, out_dtype: torch.dtype, tile: int) -> torch.Tensor:
    """One launch of the bf16 form of kernel ``kind`` (``csrc/gru_gates.cu``)."""
    n, t, _ = gi[0].shape
    dev = gi[0].device
    wa, wb = (gw.frag1, gw.frag2) if kind == 5 else (gw.frag9, gw.frag9)
    what = f"gru_gates kernel {kind}"
    for name, w in (("wa", wa), ("wb", wb), ("b8", gw.b8)):
        if w.device != dev:
            raise ValueError(f"{what}: weight {name} is on {w.device}, gi on {dev}")
    out = torch.empty((n, t, H), dtype=out_dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fvad_gru_gates(
            kind, 1, int(gi[0].dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            *(x.data_ptr() for x in gi), wa.data_ptr(), wb.data_ptr(), gw.b8.data_ptr(), out.data_ptr(),
            n, t, tile, stream,
        )
    _build.check(lib, err, f"{what} launch")
    return out


def _launch(wrapper, kind: int, net: NSNet2, gi: tuple, dtype: torch.dtype, out_dtype: torch.dtype,
            tile: int) -> torch.Tensor:
    """Run kernel ``kind`` in ``dtype`` on the card and count the launch in
    ``wrapper.launches``: float32 on kernel 1's kernel
    (``nsnet2_cuda.gru_stack_gates``), bf16 on ``csrc/gru_gates.cu``."""
    n, t, _ = gi[0].shape
    if n == 0 or t == 0:
        return torch.empty((n, t, H), dtype=out_dtype, device=gi[0].device)
    if dtype == torch.float32:
        out = nsnet2_cuda.gru_stack_gates(net, gi, stacked_biases(net), out_dtype)
    else:
        out = _launch_bf16(kind, gate_weights(net, dtype), gi, out_dtype, tile)
    wrapper.launches += 1
    return out


def gru_gates(net: NSNet2, gi_z, gi_r, gi_n, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel 4: gi [N, T, H] (cast to ``dtype``) -> h2 [N, T, H] float32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in ``gru_gates.launches``) or raises."""
    gi = _operands("gru_gates", net, (gi_z, gi_r, gi_n), dtype, dtype)
    if gi[0].device.type == "cpu":
        return gru_gates_reference(gate_weights(net, dtype), *gi)
    return _launch(gru_gates, 4, net, gi, dtype, torch.float32, gi[0].shape[0])


def gru_gates_p(net: NSNet2, gi_z, gi_r, gi_n, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel 5: float32 gi [N, T, H] -> h2 [N, T, H] float32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in ``gru_gates_p.launches``) or raises."""
    gi = _operands("gru_gates_p", net, (gi_z, gi_r, gi_n), dtype, torch.float32)
    if gi[0].device.type == "cpu":
        return gru_gates_p_reference(gate_weights(net, dtype), *gi)
    return _launch(gru_gates_p, 5, net, gi, dtype, torch.float32, gi[0].shape[0])


def gru_gates_f(
    net: NSNet2, gi_z, gi_r, gi_n, dtype: torch.dtype = torch.float32,
    tile: int | None = None, out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Kernel 6: gi [N, T, H] (cast to ``dtype``) -> h2 [N, T, H] in
    ``out_dtype`` (default ``dtype``). ``tile`` rows per grid slice (default
    all) is the TPU kernel's schedule knob: it changes no bit of the result.
    It is validated in every form, but only the bf16 kernel slices its grid
    by it; in float32 the card's launch plan (``nsnet2_cuda.launch_plan``)
    sets the grid whatever the tile.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in ``gru_gates_f.launches``) or raises."""
    out_dtype = out_dtype or dtype
    if out_dtype not in DTYPES:
        raise ValueError(f"gru_gates_f: out_dtype must be one of {DTYPES}, got {out_dtype}")
    gi = _operands("gru_gates_f", net, (gi_z, gi_r, gi_n), dtype, dtype)
    n = gi[0].shape[0]
    if tile is not None and tile < 1:
        raise ValueError(f"gru_gates_f: tile must be a positive number of rows, got {tile}")
    tile = n if tile is None else min(int(tile), n)  # a tile past N covers the same rows as one of N
    if gi[0].device.type == "cpu":
        return gru_gates_f_reference(gate_weights(net, dtype), *gi, out_dtype=out_dtype)
    return _launch(gru_gates_f, 6, net, gi, dtype, out_dtype, tile)


gru_gates.launches = 0
gru_gates_p.launches = 0
gru_gates_f.launches = 0
