"""Minimal ONNX weight importer and writer (port of
``formula_vad_tpu/models/onnx_import.py``; no ``onnx``/``onnxruntime``
dependency).

The reference executes ``data/nsnet2-20ms-baseline.onnx`` via ONNX Runtime
(``src/NSNet2.zig:53-112``); the port runs the network in PyTorch
(``nsnet2.py``) and only needs the *weights* out of the ONNX file. This
module holds a small protobuf wire-format reader, just enough of the ONNX
schema (ModelProto/GraphProto/NodeProto/TensorProto/AttributeProto) to
extract initializers and node topology, and a mapper that matches the
NSNet2 baseline graph onto the flat numpy dict that the JAX package's
``nsnet2.save_npz`` writes (``gru{1,2}_lbr`` included), from which
``nsnet2.from_numpy`` builds the module. Everything here is numpy.

Weight resolution is by graph topology (dataflow chain walk after constant
folding), never by initializer name or file order, and it accepts the
encodings real exporters emit: Gemm with/without transB, MatMul+Add,
Constant-node weights, Transpose/Squeeze/Unsqueeze/Reshape wrappers and
initial-state subgraphs around the GRUs (the PyTorch export idiom),
fp16/bf16/f64 initializers, raw and typed tensor payloads. bf16 is decoded
from its uint16 bits (widened to the high half of a float32: exact), so
no ``ml_dtypes`` is needed. The refusals are the JAX importer's: nonzero
``initial_h``, Gemm ``alpha``/``beta`` != 1, ``transA``, external data,
foreign directions and activations. A GRU without ``linear_before_reset``
maps to lbr = 0.

``export_nsnet2_onnx`` writes the JAX writer's bytes for the same weights,
including its one fault: gru1's ``linear_before_reset`` goes into both GRU
nodes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------------
# Protobuf wire format
# ---------------------------------------------------------------------------

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for each field in a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 0x7
        if wtype == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == _WT_I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == _WT_I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        if pos > n:
            raise ValueError("truncated protobuf message")
        yield fnum, wtype, val


def _write_tag(fnum: int, wtype: int) -> bytes:
    return _encode_varint((fnum << 3) | wtype)


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _write_tag(fnum, _WT_LEN) + _encode_varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# ONNX schema subset
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.dtype("<f4"),   # FLOAT
    2: np.dtype("u1"),    # UINT8
    3: np.dtype("i1"),    # INT8
    4: np.dtype("<u2"),   # UINT16
    5: np.dtype("<i2"),   # INT16
    6: np.dtype("<i4"),   # INT32
    7: np.dtype("<i8"),   # INT64
    9: np.dtype("?"),     # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
    12: np.dtype("<u4"),  # UINT32
    13: np.dtype("<u8"),  # UINT64
}


_BF16 = 16  # TensorProto.BFLOAT16


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 payload (its uint16 bits) -> float32, exactly: a bf16 is the
    high half of a float32."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


@dataclass
class OnnxTensor:
    name: str = ""
    dims: tuple[int, ...] = ()
    data_type: int = 1
    array: np.ndarray | None = None


@dataclass
class OnnxAttr:
    name: str = ""
    i: int | None = None
    f: float | None = None
    ints: tuple[int, ...] = ()
    t: OnnxTensor | None = None
    s: bytes | None = None


@dataclass
class OnnxNode:
    op_type: str = ""
    name: str = ""
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    attrs: dict[str, OnnxAttr] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: list[OnnxNode] = field(default_factory=list)
    initializers: dict[str, np.ndarray] = field(default_factory=dict)
    input_names: list[str] = field(default_factory=list)
    output_names: list[str] = field(default_factory=list)


def _unpack_varints(val: object, wtype: int) -> list[int]:
    if wtype == _WT_VARINT:
        return [int(val)]
    out: list[int] = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _parse_tensor(buf: bytes) -> OnnxTensor:
    """Parse a TensorProto. Handles every encoding a real exporter emits:
    raw_data bytes, typed float_data/double_data, int32_data (which per the
    ONNX spec also carries float16/bfloat16 payloads as uint16), int64_data,
    and rejects externally-stored tensors with a clean error."""
    t = OnnxTensor()
    dims: list[int] = []
    float_data: list[float] = []
    double_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    raw = b""
    external = False
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:  # dims (repeated int64)
            dims.extend(_unpack_varints(val, wtype))
        elif fnum == 2 and wtype == _WT_VARINT:
            t.data_type = int(val)
        elif fnum == 4:  # float_data
            if wtype == _WT_I32:
                float_data.append(struct.unpack("<f", val)[0])
            else:  # packed
                float_data.extend(struct.unpack(f"<{len(val)//4}f", val))
        elif fnum == 5:  # int32_data (also carries f16/bf16 as uint16)
            # Varints are two's-complement-encoded as 10-byte negatives for
            # int32; mask to 32 bits and re-sign below via dtype view.
            int32_data.extend(v & 0xFFFFFFFF for v in _unpack_varints(val, wtype))
        elif fnum == 7:  # int64_data
            int64_data.extend(_unpack_varints(val, wtype))
        elif fnum == 8 and wtype == _WT_LEN:
            t.name = val.decode("utf-8")
        elif fnum == 9 and wtype == _WT_LEN:
            raw = bytes(val)
        elif fnum == 10:  # double_data
            if wtype == _WT_I64:
                double_data.append(struct.unpack("<d", val)[0])
            else:  # packed
                double_data.extend(struct.unpack(f"<{len(val)//8}d", val))
        elif fnum == 14 and wtype == _WT_VARINT and int(val) == 1:
            external = True
    t.dims = tuple(dims)
    if external:
        raise ValueError(
            f"tensor {t.name!r} uses external data storage, which this "
            "importer does not support; re-export with embedded weights"
        )
    if t.data_type == _BF16:
        dtype = np.dtype("<u2")  # the bits; widened to float32 below
    elif t.data_type in _DTYPES:
        dtype = _DTYPES[t.data_type]
    else:
        raise ValueError(f"tensor {t.name!r} has unsupported data_type {t.data_type}")
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
        if t.data_type == _BF16:
            arr = _bf16_to_f32(arr)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif double_data:
        arr = np.asarray(double_data, dtype=np.float64)
    elif int32_data:
        if t.data_type == _BF16:  # f16/bf16 ride int32_data as uint16
            arr = _bf16_to_f32(np.asarray(int32_data, dtype=np.uint32).astype(np.uint16))
        elif t.data_type == 10:
            arr = np.asarray(int32_data, dtype=np.uint32).astype(np.uint16).view(dtype)
        else:
            arr = np.asarray(int32_data, dtype=np.uint32).view(np.int32)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=np.float32 if t.data_type == _BF16 else dtype)
    if t.dims:
        if arr.size != int(np.prod(dims)):
            raise ValueError(
                f"tensor {t.name!r}: {arr.size} elements but dims {t.dims}"
            )
        arr = arr.reshape(t.dims)
    t.array = arr
    return t


def _parse_attr(buf: bytes) -> OnnxAttr:
    a = OnnxAttr()
    ints: list[int] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == _WT_LEN:
            a.name = val.decode("utf-8")
        elif fnum == 2 and wtype == _WT_I32:
            a.f = struct.unpack("<f", val)[0]
        elif fnum == 3 and wtype == _WT_VARINT:
            # sint not used by ONNX attrs; plain int64 varint
            a.i = int(val)
        elif fnum == 4 and wtype == _WT_LEN:
            a.s = bytes(val)
        elif fnum == 5 and wtype == _WT_LEN:
            a.t = _parse_tensor(val)
        elif fnum == 8:
            if wtype == _WT_VARINT:
                ints.append(int(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(v)
    a.ints = tuple(ints)
    return a


def _parse_node(buf: bytes) -> OnnxNode:
    n = OnnxNode()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == _WT_LEN:
            n.inputs.append(val.decode("utf-8"))
        elif fnum == 2 and wtype == _WT_LEN:
            n.outputs.append(val.decode("utf-8"))
        elif fnum == 3 and wtype == _WT_LEN:
            n.name = val.decode("utf-8")
        elif fnum == 4 and wtype == _WT_LEN:
            n.op_type = val.decode("utf-8")
        elif fnum == 5 and wtype == _WT_LEN:
            a = _parse_attr(val)
            n.attrs[a.name] = a
    return n


def _parse_value_info_name(buf: bytes) -> str:
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == _WT_LEN:
            return val.decode("utf-8")
    return ""


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == _WT_LEN:
            g.nodes.append(_parse_node(val))
        elif fnum == 5 and wtype == _WT_LEN:
            t = _parse_tensor(val)
            g.initializers[t.name] = t.array
        elif fnum == 11 and wtype == _WT_LEN:
            g.input_names.append(_parse_value_info_name(val))
        elif fnum == 12 and wtype == _WT_LEN:
            g.output_names.append(_parse_value_info_name(val))
    return g


def parse_model(data: bytes) -> OnnxGraph:
    """Parse an ONNX ModelProto byte string into an OnnxGraph.

    Malformed input (truncated file, non-protobuf bytes) raises ValueError."""
    try:
        for fnum, wtype, val in _iter_fields(data):
            if fnum == 7 and wtype == _WT_LEN:  # ModelProto.graph
                return _parse_graph(val)
    except (IndexError, struct.error) as e:
        raise ValueError(f"malformed ONNX protobuf: {e}") from e
    raise ValueError("no graph found in ONNX model")


def parse_model_file(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        return parse_model(f.read())


# ---------------------------------------------------------------------------
# NSNet2 graph mapping
# ---------------------------------------------------------------------------

# Ops that only reshape/relabel the activation tensor flowing through the
# chain — their input 0 is the data path, everything else (shape/axes
# operands) is constant. Real PyTorch exports wrap the GRUs in
# Transpose/Squeeze/Unsqueeze/Reshape; all are data-layout no-ops for weight
# extraction because the GRU weights themselves are initializers.
_SHAPE_OPS = {
    "Squeeze", "Unsqueeze", "Reshape", "Transpose", "Identity", "Cast",
    "Flatten", "Dropout",
}
# Ops whose whole fan-in subgraph exists only to build the GRU's zero
# initial state (Shape -> Gather -> Concat -> ConstantOfShape in torch
# exports); they never sit on the features->gains data path.
_STATE_SUBGRAPH_OPS = {"Shape", "Gather", "Concat", "ConstantOfShape", "Slice", "Mul"}


def _f32(arr: np.ndarray) -> np.ndarray:
    """Initializer to contiguous float32 (fp16/bf16/f64 all appear in
    real-world exports)."""
    return np.ascontiguousarray(np.asarray(arr).astype(np.float32))


def _fold_constants(g: OnnxGraph) -> None:
    """Fold Constant nodes and shape-ops over constants into
    ``g.initializers`` so the chain walk only ever sees dynamic dataflow.
    PyTorch exporters routinely emit weights as Constant nodes and biases as
    Constant->Unsqueeze chains rather than graph initializers."""
    init = g.initializers
    nodes = list(g.nodes)
    changed = True
    while changed:
        changed = False
        remaining: list[OnnxNode] = []
        for node in nodes:
            op = node.op_type
            if op == "Constant":
                val = node.attrs.get("value")
                if val is not None and val.t is not None and val.t.array is not None:
                    init[node.outputs[0]] = val.t.array
                    changed = True
                    continue
            elif op in ("Transpose", "Reshape", "Squeeze", "Unsqueeze",
                        "Identity", "Cast", "Flatten") and node.inputs and node.inputs[0] in init:
                folded = _fold_shape_op(node, init)
                if folded is not None:
                    init[node.outputs[0]] = folded
                    changed = True
                    continue
            remaining.append(node)
        nodes = remaining
    g.nodes = nodes


def _axes_of(node: OnnxNode, init: dict) -> tuple[int, ...] | None:
    """Squeeze/Unsqueeze axes: attribute pre-opset-13, input 1 after."""
    a = node.attrs.get("axes")
    if a is not None and a.ints:
        return tuple(int(v) for v in a.ints)
    if len(node.inputs) > 1 and node.inputs[1] in init:
        return tuple(int(v) for v in np.asarray(init[node.inputs[1]]).reshape(-1))
    return None


def _fold_shape_op(node: OnnxNode, init: dict) -> np.ndarray | None:
    arr = init[node.inputs[0]]
    op = node.op_type
    if op in ("Identity", "Cast"):
        return arr
    if op == "Transpose":
        perm = node.attrs.get("perm")
        axes = tuple(int(v) for v in perm.ints) if (perm and perm.ints) else None
        return np.transpose(arr, axes)
    if op == "Reshape":
        if len(node.inputs) > 1 and node.inputs[1] in init:
            shape = tuple(int(v) for v in np.asarray(init[node.inputs[1]]).reshape(-1))
            return arr.reshape(shape)
        return None
    if op == "Flatten":
        ax_attr = node.attrs.get("axis")
        ax = int(ax_attr.i) if (ax_attr is not None and ax_attr.i is not None) else 1
        lead = int(np.prod(arr.shape[:ax])) if ax else 1
        return arr.reshape(lead, -1)
    axes = _axes_of(node, init)
    if op == "Squeeze":
        return np.squeeze(arr, axis=axes) if axes else np.squeeze(arr)
    if op == "Unsqueeze":
        if axes is None:
            return None
        return np.expand_dims(arr, axis=list(axes))
    return None


def _trace_chain(g: OnnxGraph) -> list[OnnxNode]:
    """Walk the single features->gains dataflow chain from the graph input.

    Resolution is purely topological: initializer names/ordering are
    irrelevant, and side subgraphs that compute GRU initial states (fed from
    the same activations via Shape) are recognized and bypassed."""
    init = g.initializers
    produced = {o for n in g.nodes for o in n.outputs}
    consumers: dict[str, list[OnnxNode]] = {}
    for node in g.nodes:
        for name in node.inputs:
            if name and name not in init:
                consumers.setdefault(name, []).append(node)

    inputs = [n for n in g.input_names if n and n not in init and n not in produced]
    if not inputs:
        inputs = sorted(
            {i for n in g.nodes for i in n.inputs if i and i not in init and i not in produced}
        )
    if len(inputs) != 1:
        raise ValueError(
            f"expected exactly one dynamic graph input, found {inputs or 'none'}"
        )

    def _first_dynamic_input(n: OnnxNode) -> str | None:
        for name in n.inputs:
            if name and name not in init:
                return name
        return None

    chain: list[OnnxNode] = []
    cur = inputs[0]
    for _ in range(len(g.nodes) + 1):
        nexts = consumers.get(cur, [])
        # The data path always consumes the activation as the node's first
        # DYNAMIC input (a bias-first Add has an initializer at slot 0; a
        # GRU taking a computed initial state has it at slot 5); state
        # subgraphs hang off via Shape/Gather etc.
        main = [n for n in nexts if _first_dynamic_input(n) == cur
                and n.op_type not in _STATE_SUBGRAPH_OPS]
        if not main:
            return chain
        if len(main) > 1:
            ops = [n.op_type for n in main]
            raise ValueError(f"dataflow forks at tensor {cur!r} into {ops}")
        node = main[0]
        chain.append(node)
        if not node.outputs:
            return chain
        cur = node.outputs[0]
    raise ValueError("dataflow contains a cycle")


def _chain_weight(name: str, init: dict, node: OnnxNode) -> np.ndarray:
    if name not in init:
        raise ValueError(
            f"{node.op_type} node {node.name!r} expects constant weights, "
            f"but {name!r} is a dynamic tensor"
        )
    return init[name]


def _attr_f(node: OnnxNode, name: str, default: float) -> float:
    a = node.attrs.get(name)
    return float(a.f) if (a is not None and a.f is not None) else default


def _linear_from_gemm(node: OnnxNode, init: dict) -> tuple[np.ndarray, np.ndarray | None]:
    if _attr_f(node, "alpha", 1.0) != 1.0 or _attr_f(node, "beta", 1.0) != 1.0:
        raise ValueError(f"Gemm {node.name!r}: alpha/beta != 1 is not supported")
    ta = node.attrs.get("transA")
    if ta is not None and ta.i:
        raise ValueError(f"Gemm {node.name!r}: transA=1 is not supported")
    w = _f32(_chain_weight(node.inputs[1], init, node))
    if w.ndim != 2:
        raise ValueError(f"Gemm {node.name!r}: weight must be 2-D, got {w.shape}")
    tb = node.attrs.get("transB")
    if tb is not None and tb.i:
        w = np.ascontiguousarray(w.T)
    b = None
    if len(node.inputs) > 2 and node.inputs[2]:
        b = _f32(init[node.inputs[2]]).reshape(-1)
    return w, b


def _linear_from_matmul(node: OnnxNode, init: dict) -> tuple[np.ndarray, np.ndarray | None]:
    if node.inputs[0] in init and node.inputs[1] not in init:
        raise ValueError(
            f"MatMul {node.name!r}: constant left operand (W @ x form) is "
            "not supported; expected activations @ weights"
        )
    w = _f32(_chain_weight(node.inputs[1], init, node))
    if w.ndim != 2:
        raise ValueError(f"MatMul {node.name!r}: weight must be 2-D, got {w.shape}")
    return w, None


def _gru_from_node(node: OnnxNode, init: dict) -> dict:
    """One GRU layer's weights from an ONNX GRU node (gate order z|r|h per
    spec) -> {"wi" [in, 3H], "wh" [H, 3H], "bi", "bh" [3H], "lbr"}.

    The real nsnet2-20ms-baseline export (src/NSNet2.zig:53-112 runs it via
    ONNX Runtime) uses single-direction GRUs with default activations and
    linear_before_reset=1; anything else gets a clean error, not silent
    wrong numerics."""
    d = node.attrs.get("direction")
    if d is not None and d.s is not None and d.s not in (b"forward", b""):
        raise ValueError(f"GRU {node.name!r}: direction {d.s!r} is not supported")
    acts = node.attrs.get("activations")
    if acts is not None and acts.s is not None and acts.s not in (b"", b"SigmoidTanh"):
        # (repeated-string attrs land concatenated in .s only for our own
        # exporter; foreign files use repeated field 7 which we don't parse —
        # absent means default Sigmoid/Tanh, which is what every NSNet2
        # export uses.)
        raise ValueError(f"GRU {node.name!r}: non-default activations unsupported")
    w = _f32(_chain_weight(node.inputs[1], init, node))  # [D, 3H, in]
    r = _f32(_chain_weight(node.inputs[2], init, node))  # [D, 3H, H]
    if w.ndim != 3 or r.ndim != 3 or w.shape[0] != 1 or r.shape[0] != 1:
        raise ValueError(
            f"GRU {node.name!r}: expected single-direction [1,3H,*] weights, "
            f"got W{w.shape} R{r.shape}"
        )
    hidden = r.shape[-1]
    if w.shape[1] != 3 * hidden or r.shape[1] != 3 * hidden:
        raise ValueError(
            f"GRU {node.name!r}: gate dim {w.shape[1]} != 3*hidden ({3 * hidden})"
        )
    hs = node.attrs.get("hidden_size")
    if hs is not None and hs.i is not None and int(hs.i) != hidden:
        raise ValueError(
            f"GRU {node.name!r}: hidden_size attr {hs.i} != R hidden dim {hidden}"
        )
    if len(node.inputs) > 3 and node.inputs[3] and node.inputs[3] in init:
        b = _f32(init[node.inputs[3]]).reshape(-1)  # [6H]: Wb(zrh) | Rb(zrh)
        if b.size != 6 * hidden:
            raise ValueError(
                f"GRU {node.name!r}: bias has {b.size} elements, expected {6 * hidden}"
            )
        bi, bh = b[: 3 * hidden], b[3 * hidden :]
    else:
        bi = np.zeros(3 * hidden, np.float32)
        bh = np.zeros(3 * hidden, np.float32)
    # initial_h (inputs[5]): the model always starts from h0=0 (the
    # per-chunk stateless ONNX Runtime semantics, NSNet2.zig:220). A
    # foreign export supplying a NONZERO constant initial state would be
    # silently mis-mapped — name it instead of importing wrong numerics.
    # (Zero constants — the torch Shape->ConstantOfShape idiom — are fine;
    # dynamic initial states resolved to a weight also get checked.)
    if len(node.inputs) > 5 and node.inputs[5]:
        h0_name = node.inputs[5]
        if h0_name in init:
            h0 = _f32(init[h0_name])
            if np.any(h0 != 0.0):
                raise ValueError(
                    f"GRU {node.name!r}: nonzero initial_h is not supported "
                    "(the NSNet2 chunk semantics run from h0=0)"
                )
    lbr_attr = node.attrs.get("linear_before_reset")
    lbr = int(lbr_attr.i) if (lbr_attr is not None and lbr_attr.i is not None) else 0
    return {
        "wi": np.ascontiguousarray(w[0].T),
        "wh": np.ascontiguousarray(r[0].T),
        "bi": bi,
        "bh": bh,
        "lbr": lbr,
    }


def load_nsnet2_graph(g: OnnxGraph) -> dict:
    """Map an NSNet2 export (Dense, GRU, GRU, Dense+ReLU x2, Dense+Sigmoid)
    by graph topology onto the flat float32 dict ``save_npz`` writes
    (``{fc_in,ff1,ff2,out}_{w,b}``, ``gru{1,2}_{wi,wh,bi,bh}``, and
    ``gru{1,2}_lbr`` as int32), which ``nsnet2.from_numpy`` builds.

    Tolerant to the encodings real exporters produce: Gemm (any transB) or
    MatMul+Add linears, Constant-node weights, Transpose/Squeeze/Unsqueeze/
    Reshape wrapping around the GRUs, initial-state subgraphs, fp16/f64/bf16
    initializers, and arbitrary initializer naming/ordering. Structural
    mismatches raise ValueError with the offending construct named."""
    _fold_constants(g)
    init = g.initializers
    chain = _trace_chain(g)
    if not chain:
        raise ValueError("no compute nodes reachable from the graph input")

    linears: list[list] = []  # [w, b or None]
    grus: list[dict] = []
    for node in chain:
        op = node.op_type
        if op in _SHAPE_OPS:
            continue
        if op == "Gemm":
            w, b = _linear_from_gemm(node, init)
            linears.append([w, b])
        elif op == "MatMul":
            w, b = _linear_from_matmul(node, init)
            linears.append([w, b])
        elif op == "Add":
            const_in = [i for i in node.inputs if i in init]
            if len(const_in) != 1 or not linears or linears[-1][1] is not None:
                raise ValueError(
                    f"Add {node.name!r} is not a bias for a preceding linear layer"
                )
            linears[-1][1] = _f32(init[const_in[0]]).reshape(-1)
        elif op == "GRU":
            grus.append(_gru_from_node(node, init))
        elif op in ("Relu", "Sigmoid"):
            continue
        else:
            raise ValueError(f"unsupported op {op!r} on the NSNet2 data path")

    if len(grus) != 2 or len(linears) != 4:
        raise ValueError(
            f"unexpected NSNet2 graph shape: {len(linears)} linear layers, "
            f"{len(grus)} GRUs (expected 4 and 2)"
        )
    resolved = []
    for w, b in linears:
        if b is None:
            b = np.zeros(w.shape[1], np.float32)
        if b.size != w.shape[1]:
            raise ValueError(
                f"linear bias has {b.size} elements for weight {w.shape}"
            )
        resolved.append((w, b))
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = resolved

    # Dataflow-dimension consistency (catches orientation mistakes early).
    gru_in = grus[0]["wi"].shape[0]
    if w0.shape[1] != gru_in:
        raise ValueError(
            f"input Dense produces {w0.shape[1]} features but GRU 1 expects {gru_in}"
        )
    if w1.shape[0] != grus[1]["wh"].shape[0]:
        raise ValueError(
            f"Dense after GRUs expects {w1.shape[0]} features but GRU 2 "
            f"outputs {grus[1]['wh'].shape[0]}"
        )
    for (wa, _), (wb, _) in zip(resolved[1:], resolved[2:]):
        if wa.shape[1] != wb.shape[0]:
            raise ValueError(
                f"dense chain dimension mismatch: {wa.shape} -> {wb.shape}"
            )
    flat = {}
    for name, (w, b) in zip(("fc_in", "ff1", "ff2", "out"), resolved):
        flat[f"{name}_w"], flat[f"{name}_b"] = w, b
    for name, gru in zip(("gru1", "gru2"), grus):
        for key in ("wi", "wh", "bi", "bh"):
            flat[f"{name}_{key}"] = gru[key]
        flat[f"{name}_lbr"] = np.int32(gru["lbr"])
    return flat


def load_nsnet2_onnx(path: str) -> dict:
    """The flat weight dict of an NSNet2 ONNX file (``load_nsnet2_graph``)."""
    return load_nsnet2_graph(parse_model_file(path))


# ---------------------------------------------------------------------------
# Writer: an NSNet2 ONNX model with the Microsoft baseline export's graph
# shape; its helpers also build the test matrix's encodings.
# ---------------------------------------------------------------------------


_SER_DTYPES = {"f32": (1, np.float32), "f16": (10, np.float16), "f64": (11, np.float64)}


def _ser_tensor(name: str, arr: np.ndarray, dtype: str = "f32", encoding: str = "raw") -> bytes:
    """Serialize a TensorProto. ``dtype`` in {f32,f16,f64}; ``encoding``
    'raw' (raw_data bytes) or 'typed' (float_data / int32_data /
    double_data — the per-type repeated fields real exporters also emit)."""
    code, np_dtype = _SER_DTYPES[dtype]
    data = np.ascontiguousarray(np.asarray(arr).astype(np_dtype))
    out = b""
    for d in data.shape:
        out += _write_tag(1, _WT_VARINT) + _encode_varint(d)
    out += _write_tag(2, _WT_VARINT) + _encode_varint(code)
    if encoding == "raw":
        out += _len_field(9, data.tobytes())
    elif dtype == "f32":  # packed float_data
        out += _len_field(4, data.reshape(-1).tobytes())
    elif dtype == "f64":  # packed double_data
        out += _len_field(10, data.reshape(-1).tobytes())
    else:  # f16 rides int32_data as uint16 varints (the spec's encoding)
        payload = b"".join(
            _encode_varint(int(v)) for v in data.reshape(-1).view(np.uint16)
        )
        out += _len_field(5, payload)
    out += _len_field(8, name.encode())
    return out


def _ser_attr_int(name: str, value: int) -> bytes:
    return _len_field(5, _len_field(1, name.encode()) + _write_tag(3, _WT_VARINT) + _encode_varint(value))


def _ser_attr_ints(name: str, values: tuple[int, ...]) -> bytes:
    body = _len_field(1, name.encode())
    for v in values:
        body += _write_tag(8, _WT_VARINT) + _encode_varint(v)
    return _len_field(5, body)


def _ser_attr_str(name: str, value: bytes) -> bytes:
    return _len_field(5, _len_field(1, name.encode()) + _len_field(4, value))


def _ser_attr_tensor(name: str, tensor_bytes: bytes) -> bytes:
    return _len_field(5, _len_field(1, name.encode()) + _len_field(5, tensor_bytes))


def _ser_value_info(name: str) -> bytes:
    return _len_field(1, name.encode())


def _ser_node(op: str, inputs: list[str], outputs: list[str], attrs: bytes = b"") -> bytes:
    out = b""
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    out += _len_field(4, op.encode())
    out += attrs
    return out


def export_nsnet2_onnx(net) -> bytes:
    """Serialize the weights of ``net`` (an ``nsnet2.NSNet2``) as a real ONNX
    model with the baseline graph layout (Gemm, GRU x2, Gemm+Relu x2,
    Gemm+Sigmoid), byte for byte as the JAX package's writer serializes the
    same weights: they round-trip to ONNX Runtime consumers, including the
    original reference (src/NSNet2.zig loads exactly this graph shape). As
    there, gru1's linear_before_reset is written into both GRU nodes."""
    from .nsnet2 import to_numpy

    flat = to_numpy(net)

    def np_(key):
        return np.asarray(flat[key], np.float32)

    inits = b""
    inits += _len_field(5, _ser_tensor("fc_in_w", np_("fc_in_w").T))  # Gemm transB=1
    inits += _len_field(5, _ser_tensor("fc_in_b", np_("fc_in_b")))
    for name in ("gru1", "gru2"):
        inits += _len_field(5, _ser_tensor(f"{name}_W", np_(f"{name}_wi").T[None]))
        inits += _len_field(5, _ser_tensor(f"{name}_R", np_(f"{name}_wh").T[None]))
        b6 = np.concatenate([np_(f"{name}_bi"), np_(f"{name}_bh")])[None]
        inits += _len_field(5, _ser_tensor(f"{name}_B", b6))
    for i, name in enumerate(("ff1", "ff2", "out")):
        inits += _len_field(5, _ser_tensor(f"ff{i}_w", np_(f"{name}_w").T))
        inits += _len_field(5, _ser_tensor(f"ff{i}_b", np_(f"{name}_b")))

    gemm_attrs = _ser_attr_int("transB", 1)
    lbr = _ser_attr_int("linear_before_reset", int(flat["gru1_lbr"]))
    nodes = [
        _ser_node("Gemm", ["input", "fc_in_w", "fc_in_b"], ["x0"], gemm_attrs),
        _ser_node("GRU", ["x0", "gru1_W", "gru1_R", "gru1_B"], ["x1"], lbr),
        _ser_node("Squeeze", ["x1"], ["x1s"]),
        _ser_node("GRU", ["x1s", "gru2_W", "gru2_R", "gru2_B"], ["x2"], lbr),
        _ser_node("Squeeze", ["x2"], ["x2s"]),
        _ser_node("Gemm", ["x2s", "ff0_w", "ff0_b"], ["x3"], gemm_attrs),
        _ser_node("Relu", ["x3"], ["x4"]),
        _ser_node("Gemm", ["x4", "ff1_w", "ff1_b"], ["x5"], gemm_attrs),
        _ser_node("Relu", ["x5"], ["x6"]),
        _ser_node("Gemm", ["x6", "ff2_w", "ff2_b"], ["x7"], gemm_attrs),
        _ser_node("Sigmoid", ["x7"], ["output"]),
    ]
    graph = b"".join(_len_field(1, n) for n in nodes) + inits
    return _len_field(7, graph)
