"""NSNet2 noise-suppression network as a PyTorch module.

Port of ``formula_vad_tpu/models/nsnet2.py`` (``apply``,
``apply_streaming``, ``apply_head``, ``zero_state``, ``save_npz``,
``load_npz``, ``load``: ``.npz`` and ``.onnx`` files, the latter through
``onnx_import``). The differentiable ``apply`` that training runs is
``train/nsnet2_train.py::apply``: the kernels here are forward only.
Architecture (Microsoft DNS-Challenge NSNet2 baseline):

    [*, T, 161] log-power -> Dense 161->400 -> GRU 400 -> GRU 400
        -> Dense 400->600 + ReLU -> Dense 600->600 + ReLU
        -> Dense 600->161 + sigmoid (spectral gain mask)

Weights keep the JAX package's layout ([in, out] kernels, ONNX z|r|n gate
order), so every product is ``x @ w + b`` as there, at the precision of its
stage (``ops/precision.py``: fc_in, gru_i, gru_h, ff). The input Dense, the
layer-1 input projection and the FF head are products over the whole
sequence, as the JAX package computes them outside its kernel too. The recurrence of both layers runs in one kernel wrapper (a CUDA kernel for
CUDA tensors, its plain PyTorch version for CPU tensors), chosen by the
levels of its two product classes (``precision.gru_levels``: ``gru_i``,
h1 Wi2; ``gru_h``, h1 Wh1 and h2 Wh2) and the storage dtype:

* both 'highest': ``nsnet2_cuda.gru_stack`` (kernel 1), float32.
* one 'highest', the other 'high' or 'default' (a stage override):
  ``nsnet2_cuda.gru_stack_mixed`` (kernel B): kernel 1's tiles, the
  'highest' class on its FMA code and the other on the tensor cores.
* both 'default' (the bf16 tier): ``nsnet2_gates_cuda.gru_gates_p``
  (kernel 5) in bf16, over per-gate input projections with the biases
  folded, as the JAX package's split3 scan rounds there.
* both in {'default', 'high'}, one at least 'high' (the bf16_3x tier and
  its mixes): ``nsnet2_gates_cuda.gru_gates_3x`` (kernel A), kernel 5's
  function on the tensor cores with one bf16 pass for a 'default' class
  and three (bf16_3x) for a 'high' one, as the JAX package's TPU runs
  ``Precision.HIGH`` in its scan.
* bf16 activation storage (``precision.set_io_dtype("bf16")``, at any
  levels: every product then multiplies bf16 operands exactly): features,
  weights and the fc_in output in bf16, as the JAX package casts them; the
  per-gate projections; the recurrence through
  ``nsnet2_gates_cuda.gru_gates_f`` (kernel 6) in bf16 with a bf16 out;
  the head on that bf16 h2. Kernel 6 keeps float32 h on chip and rounds
  it only where it enters a product and on the way out, where the JAX
  scan stores h in bf16 every step: a tier, not a parity mode, whose
  decisions ``testing/tier_fuzz.py`` measures.

Like the reference's per-chunk ONNX run, ``forward`` always starts the GRUs
from h = 0. ``forward_streaming`` (the low-latency mode's model step,
``pipeline/lowlatency.py``) continues a carried state ``(h1, h2)`` through
the same routes, each recurrence wrapper taking the state; the JAX
package's TPU-only options of ``apply_streaming`` (``rider``,
``defer_head``, the wavefront schedule) are not ported. Under the int8
tier (``ops/precision.set_quant("int8")`` or ``FVAD_QUANT=int8``) a
network whose GRUs both have linear_before_reset = 1 runs
``nsnet2_q8.forward_q8`` instead, at either storage dtype, as the
reference's ``apply_streaming`` routes to ``apply_streaming_q8``; lbr = 0
weights keep the float path. There, on any device, their recurrence runs
the plain per-step loop ``nsnet2_cuda.gru_stack_reference`` at the
classes' levels and, under bf16 storage, in bf16: no TPU kernel computes
lbr = 0 (the JAX package's Pallas kernel refuses it, and its scan runs
outside any kernel).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import precision

N_BINS = 161
HIDDEN = 400
FF1 = 600
FF2 = 600

# Keys of the flat weight dict, as written by formula_vad_tpu.models.nsnet2.save_npz.
DENSE_KEYS = ("fc_in", "ff1", "ff2", "out")
GRU_KEYS = ("wi", "wh", "bi", "bh")


class GRU(nn.Module):
    """One GRU layer's weights: wi [in, 3H], wh [H, 3H], bi, bh [3H];
    ``linear_before_reset`` as the ONNX attribute (1 for PyTorch exports)."""

    def __init__(self, in_dim: int, linear_before_reset: int = 1):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(in_dim, 3 * HIDDEN), requires_grad=False)
        self.wh = nn.Parameter(torch.zeros(HIDDEN, 3 * HIDDEN), requires_grad=False)
        self.bi = nn.Parameter(torch.zeros(3 * HIDDEN), requires_grad=False)
        self.bh = nn.Parameter(torch.zeros(3 * HIDDEN), requires_grad=False)
        self.linear_before_reset = int(linear_before_reset)


class Dense(nn.Module):
    """``x @ w + b``, the product at the precision of ``stage``
    (``ops/precision.STAGES``)."""

    def __init__(self, in_dim: int, out_dim: int, stage: str):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(out_dim), requires_grad=False)
        self.stage = stage

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.matmul(x, precision.io_cast(self.w), self.stage) + precision.io_cast(self.b)


def zero_state(lead: tuple = (), device="cpu", dtype: torch.dtype = torch.float32) -> tuple:
    """The GRU state (h1, h2) at h = 0, each [*lead, 400]."""
    return tuple(torch.zeros(tuple(lead) + (HIDDEN,), dtype=dtype, device=device) for _ in range(2))


class NSNet2(nn.Module):
    def __init__(self, lbr1: int = 1, lbr2: int = 1):
        super().__init__()
        self.fc_in = Dense(N_BINS, HIDDEN, "fc_in")
        self.gru1 = GRU(HIDDEN, lbr1)
        self.gru2 = GRU(HIDDEN, lbr2)
        self.ff1 = Dense(HIDDEN, FF1, "ff")
        self.ff2 = Dense(FF1, FF2, "ff")
        self.out = Dense(FF2, N_BINS, "ff")

    def head(self, y: torch.Tensor) -> torch.Tensor:
        """Post-GRU dense stack: [..., 400] -> gains [..., 161]."""
        y = torch.relu(self.ff1(y))
        y = torch.relu(self.ff2(y))
        return torch.sigmoid(self.out(y))

    def forward(self, features: torch.Tensor, out_frames: int | None = None) -> torch.Tensor:
        """features [..., T, 161] -> gains [..., T_out, 161], T_out = out_frames
        (the last frames only; the head skips the dropped ones) or T."""
        return self._run(features, out_frames, None)

    def forward_streaming(self, state: tuple, features: torch.Tensor, out_frames: int | None = None):
        """The network over features [..., T, 161] continuing the GRU state
        ``state = (h1, h2)``, each [..., 400] -> (new state, gains [..., T_out,
        161]), the state in its dtype. The recurrence runs on the tier's
        route as in ``forward``, from the state (cast to float32). Under bf16
        activation storage the state goes in and comes back rounded to bf16
        (widened to its dtype), as the JAX package casts it and its scan
        stores it: a chain of calls rounds it once a call."""
        if features.shape[-2] == 0:
            return state, features.new_zeros(features.shape[:-1] + (N_BINS,))
        return self._run(features, out_frames, state)

    def _run(self, features: torch.Tensor, out_frames: int | None, state: tuple | None):
        """``forward`` (``state`` None: h = 0, -> gains) or
        ``forward_streaming`` (-> (state, gains))."""
        lbr = bool(self.gru1.linear_before_reset and self.gru2.linear_before_reset)
        io = precision.io_dtype()
        if precision.quant_int8() and lbr:
            from .nsnet2_q8 import forward_q8

            return forward_q8(self, features, out_frames, state)
        levels = precision.gru_levels()
        lead, t = features.shape[:-2], features.shape[-2]
        x = self.fc_in(precision.io_cast(features.reshape((-1, t, N_BINS))))
        # The recurrence wrappers take the state flat, float32 and contiguous;
        # under bf16 storage rounded to bf16, as the JAX package casts it.
        h0 = None if state is None else tuple(h.reshape(-1, HIDDEN).float().contiguous() for h in state)
        if h0 is not None and io is not None:
            h0 = tuple(precision.bf16_round(h) for h in h0)
        if not lbr:  # the plain loop in the storage dtype, as the JAX scan runs
            from .nsnet2_cuda import gru_stack_reference

            gi1 = precision.matmul(x, precision.io_cast(self.gru1.wi), "gru_i") + precision.io_cast(self.gru1.bi)
            h0 = None if h0 is None else tuple(precision.io_cast(h) for h in h0)
            ys = gru_stack_reference(self, gi1.contiguous(), state=h0, levels=levels)  # [N, T, H]
        elif io is not None:
            from .nsnet2_gates_cuda import gi_gates, gru_gates_f

            ys = gru_gates_f(self, *gi_gates(self, x), dtype=torch.bfloat16, out_dtype=torch.bfloat16, state=h0)
        elif levels == ("default", "default"):
            from .nsnet2_gates_cuda import gi_gates, gru_gates_p

            ys = gru_gates_p(self, *gi_gates(self, x), dtype=torch.bfloat16, state=h0)  # [N, T, H]
        elif "highest" not in levels:
            from .nsnet2_gates_cuda import gi_gates, gru_gates_3x

            ys = gru_gates_3x(self, *gi_gates(self, x), levels=levels, state=h0)
        else:
            from .nsnet2_cuda import gru_stack, gru_stack_mixed

            gi1 = (precision.matmul(x, self.gru1.wi, "gru_i") + self.gru1.bi).contiguous()  # [N, T, 3H]
            if levels == ("highest", "highest"):
                ys = gru_stack(self, gi1, state=h0)
            else:
                ys = gru_stack_mixed(self, gi1, levels, state=h0)
        if state is not None:
            ys, h_t = ys
            if io is not None:
                h_t = tuple(precision.bf16_round(h) for h in h_t)
            state = tuple(h.to(s.dtype).reshape(s.shape) for h, s in zip(h_t, state))
        if out_frames is not None and out_frames < t:
            ys = ys[:, t - out_frames :]
        gains = self.head(ys)
        gains = gains.reshape(lead + gains.shape[-2:])
        return gains if state is None else (state, gains)


def weights_key(net: NSNet2) -> tuple:
    """A key that changes when any parameter of ``net`` moves (``net.to``),
    is replaced, or is written in place (``load_state_dict``, ``copy_``:
    its version counter moves): caches of weights derived from ``net`` are
    keyed on it. Tensors made under ``torch.inference_mode`` keep no version
    counter, so an in-place write to one of those goes unseen."""
    return tuple((p.device, p.data_ptr(), None if p.is_inference() else p._version) for p in net.parameters())


def _tensors(net: NSNet2):
    """(flat key, parameter) for every weight of ``net``."""
    for name in DENSE_KEYS:
        yield f"{name}_w", getattr(net, name).w
        yield f"{name}_b", getattr(net, name).b
    for name in ("gru1", "gru2"):
        for key in GRU_KEYS:
            yield f"{name}_{key}", getattr(getattr(net, name), key)


def from_numpy(flat: dict) -> NSNet2:
    """Build the module (on the CPU) from a flat dict of numpy arrays keyed
    as ``formula_vad_tpu.models.nsnet2.save_npz`` writes them; float16
    arrays are upcast to float32 (the packaged weights are stored f16). An
    array of another shape than the network's raises ValueError."""
    lbr = tuple(int(np.asarray(flat.get(f"gru{i}_lbr", 1))) for i in (1, 2))
    net = NSNet2(*lbr)
    with torch.no_grad():
        for key, p in _tensors(net):
            a = np.asarray(flat[key])
            if a.shape != tuple(p.shape):
                raise ValueError(f"NSNet2 weight {key} has shape {a.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))))
    return net


def to_numpy(net: NSNet2) -> dict:
    """The flat float32 dict of ``net``'s weights (``from_numpy``'s input),
    with ``gru{1,2}_lbr`` as int32."""
    flat = {key: p.detach().float().cpu().numpy() for key, p in _tensors(net)}
    for name in ("gru1", "gru2"):
        flat[f"{name}_lbr"] = np.int32(getattr(net, name).linear_before_reset)
    return flat


def save_npz(path: str, net: NSNet2, dtype=None) -> None:
    """Write ``net``'s weights as the JAX package's ``save_npz`` does: the
    flat keys, float32 (or ``dtype``, e.g. np.float16 to halve the file),
    ``gru{1,2}_lbr`` as int32, ``np.savez_compressed``; its ``load_npz``
    reads the file."""
    flat = to_numpy(net)
    if dtype is not None:
        flat = {k: v if k.endswith("_lbr") else v.astype(dtype) for k, v in flat.items()}
    np.savez_compressed(path, **flat)


def load_npz(path: str) -> NSNet2:
    with np.load(path) as z:
        return from_numpy({k: z[k] for k in z.files})


def load(path: str) -> NSNet2:
    """NSNet2 weights from an ``.npz`` or ``.onnx`` file (on the CPU)."""
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".onnx"):
        from . import onnx_import

        return from_numpy(onnx_import.load_nsnet2_onnx(path))
    raise ValueError(f"unsupported NSNet2 weight format: {path}")


def init_params(generator: torch.Generator) -> NSNet2:
    """Random Glorot-uniform weights with zero biases (the JAX package's
    ``init_params`` scheme; the numbers differ, since the generators do)."""

    def glorot(shape):
        lim = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim

    net = NSNet2()
    with torch.no_grad():
        for name in DENSE_KEYS:
            dense = getattr(net, name)
            dense.w.copy_(glorot(tuple(dense.w.shape)))
        for name in ("gru1", "gru2"):
            gru = getattr(net, name)
            gru.wi.copy_(glorot(tuple(gru.wi.shape)))
            gru.wh.copy_(glorot(tuple(gru.wh.shape)))
    return net
