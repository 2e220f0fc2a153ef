"""Int8 NSNet2: port of ``formula_vad_tpu/models/nsnet2_q8.py::
apply_streaming_q8`` (both GRUs with linear_before_reset = 1), from h = 0
or from a carried GRU state. Under bf16 activation storage
(``precision.set_io_dtype("bf16")``) the layer-1 input projection, the
GRU outputs and the gains are stored in bf16, as the reference stores its
scan's inputs and outputs and its gains in the io dtype; the recurrence's
h stays float32, as its carry does, and so does the returned state.

The scheme is the reference's, op for op (symmetric, no zero point):

* Weights: per-output-column int8, ``s_w = max|col| / 127``. Where the
  activation has the static scale 127, 1/127 is folded into ``s_w``.
* Out-of-scan activations (features, the fc_in output, the head's ReLU
  outputs): dynamic per-frame scales, one max-abs over the last axis.
* In-scan activations (h1, h2) and the GRU output entering the head: the
  static scale 127, since |h| <= 1 by gate algebra from h = 0 (and from any
  state the recurrence reached).
* Accumulation in int32, dequantized to float32 for the gate math.

Every ``_dot8(...).astype(f32) * ...`` of the reference is one call of
``ops/matmul_q8.matmul_q8`` (the int8 tensor-core kernel on the card).
Quantization is per output column, so quantizing the z|r|n slabs one by one
(the reference's ``_qgru``) gives the same int8 values and scales as
quantizing the whole [in, 1200] matrix: gi1, ``h1 @ wh1``, ``h1 @ wi2`` and
``h2 @ wh2`` are each one launch over 1,200 columns, split afterwards. Per
forward of T steps that is fc_in, gi1, 3 per step, ff1, ff2 and out: 3T + 5
launches, 167 at T = 54 and 8 at the low-latency mode's T = 1. The gate math stays plain torch per step, as the
reference runs it in XLA outside any kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops import precision
from ..ops.matmul_q8 import Q8Weight, matmul_q8
from .nsnet2 import HIDDEN, N_BINS, NSNet2, weights_key
from .nsnet2_cuda import _gates


def qw(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 weight quant -> (q [K, N], scale [N])."""
    w = w.to(torch.float32)
    s = torch.clamp(w.abs().amax(dim=0), min=1e-20) / 127.0
    return torch.round(w / s).to(torch.int8), s


def qw_static(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight quant with the static activation scale 1/127 folded in."""
    q, s = qw(w)
    return q, s / 127.0


def qa_dyn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row (last-axis) activation quant -> (q, scale [..., 1])."""
    x = x.to(torch.float32)
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-20) / 127.0
    return torch.round(x / s).to(torch.int8), s


def qa_static(h: torch.Tensor) -> torch.Tensor:
    """Static-scale quant for gate-bounded activations (|h| <= 1)."""
    return torch.clamp(torch.round(h.to(torch.float32) * 127.0), -127.0, 127.0).to(torch.int8)


def quantize(net: NSNet2) -> dict[str, Q8Weight]:
    """The int8 weights of every product, packed for ``matmul_q8``."""
    g1, g2 = net.gru1, net.gru2
    pairs = {
        "fc_in": (qw(net.fc_in.w), net.fc_in.b),
        # wi1's folded 1/127 is undone by the row scale sx1 * 127: its input
        # is scaled dynamically, not statically.
        "wi1": (qw_static(g1.wi), g1.bi),
        "wh1": (qw_static(g1.wh), g1.bh),
        "wi2": (qw_static(g2.wi), g2.bi),
        "wh2": (qw_static(g2.wh), g2.bh),
        "ff1": (qw_static(net.ff1.w), net.ff1.b),
        "ff2": (qw(net.ff2.w), net.ff2.b),
        "out": (qw(net.out.w), net.out.b),
    }
    return {name: Q8Weight.pack(q, s, b) for name, ((q, s), b) in pairs.items()}


def _weights(net: NSNet2) -> dict[str, Q8Weight]:
    """``quantize(net)``, cached on the module and redone when its weights
    move, are replaced or are written in place (``nsnet2.weights_key``)."""
    key = weights_key(net)
    cached = getattr(net, "_q8_cache", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, quantize(net))
        net._q8_cache = cached
    return cached[1]


def forward_q8(net: NSNet2, features: torch.Tensor, out_frames: int | None = None, state: tuple | None = None):
    """features [..., T, 161] -> gains [..., T_out, 161], as ``NSNet2.forward``;
    with ``state = (h1, h2)`` ([..., 400] each) the recurrence continues it,
    cast to float32, and the call returns (new state in the state's dtype,
    gains), as ``NSNet2.forward_streaming``. On the card it raises where
    autograd records and the features, the state or a weight requires grad
    (the int8 products are kernel launches: ``_build.refuse_grad``)."""
    if features.device.type == "cuda":
        _build.refuse_grad("forward_q8", features, *(state or ()), *net.parameters())
    w = _weights(net)
    store = precision.io_cast  # the storage dtype of gi1, the GRU outputs and the gains
    lead, t = features.shape[:-2], features.shape[-2]
    qx, sx = qa_dyn(features.reshape((-1, t, N_BINS)))
    x = matmul_q8(qx, w["fc_in"], sx, order="row_col")  # [N, T, 400]
    qx1, sx1 = qa_dyn(x)
    gi1 = store(matmul_q8(qx1, w["wi1"], sx1 * 127.0, order="row_col"))  # [N, T, 1200]
    if state is None:
        h1 = h2 = x.new_zeros((x.shape[0], HIDDEN))
    else:
        h1, h2 = (h.reshape(-1, HIDDEN).float() for h in state)
    ys = []
    for step in range(t):
        h1 = _gates(gi1[:, step].float(), matmul_q8(qa_static(h1), w["wh1"]), h1)
        h2 = _gates(matmul_q8(qa_static(h1), w["wi2"]), matmul_q8(qa_static(h2), w["wh2"]), h2)
        ys.append(store(h2))
    y = torch.stack(ys, dim=1)
    if out_frames is not None and out_frames < t:
        y = y[:, t - out_frames :]
    a = torch.relu(matmul_q8(qa_static(y), w["ff1"]))
    qa2, sa2 = qa_dyn(a)
    a = torch.relu(matmul_q8(qa2, w["ff2"], sa2, order="row_col"))
    qa3, sa3 = qa_dyn(a)
    gains = store(torch.sigmoid(matmul_q8(qa3, w["out"], sa3, order="row_col")))
    gains = gains.reshape(lead + gains.shape[-2:])
    if state is None:
        return gains
    return tuple(h.to(s.dtype).reshape(s.shape) for h, s in zip((h1, h2), state)), gains
