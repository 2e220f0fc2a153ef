"""The port's ONNX importer and writer (``models/onnx_import.py``) against
the JAX package's, on the matrix of ``tests/test_onnx_formats.py``.

Each valid blob serializes one network another way (the canonical Gemm
export, the PyTorch-export idiom, typed payloads with scrambled names and
transB = 0, fp16, f64 and bf16 storage, a GRU without linear_before_reset);
both importers read it and must give the same float32 weights bit for bit,
lbr included. The bf16 blobs are decoded by the JAX importer through
``ml_dtypes`` and by the port from their uint16 bits. Each malformed blob
must be refused by both, with the same ValueError. A file genuinely written
by ``torch.onnx.export`` goes through both; the port's writer must write the
JAX writer's bytes; ``load_denoiser("*.onnx")`` builds the module from the
imported weights, and an imported model scores segments identical to the
JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_nsnet2 import _flat

from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models import onnx_import as jonnx
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.parallel.runner import BatchRunner as JBatchRunner
from formula_vad_tpu_torch.config import VADConfig
from formula_vad_tpu_torch.models import nsnet2, registry
from formula_vad_tpu_torch.models import onnx_import as onnx
from formula_vad_tpu_torch.models.onnx_import import (
    _WT_VARINT,
    _encode_varint,
    _len_field,
    _ser_attr_int,
    _ser_attr_ints,
    _ser_attr_str,
    _ser_attr_tensor,
    _ser_node,
    _ser_tensor,
    _ser_value_info,
    _write_tag,
)
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.testing import synth


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops, for which torch's intra-op threads only add
    overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jnsnet2.init_params(jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def small():
    """NSNet2-shaped JAX params at narrow widths (12 bins, hidden 8, head
    10), every bias nonzero: the importers are shape-generic, and the typed
    payloads parse a varint at a time."""
    rng = np.random.default_rng(7)
    bins, hidden, ff = 12, 8, 10

    def a(*shape):
        return jnp.asarray(rng.normal(0.0, 0.5, shape).astype(np.float32))

    def gru(in_dim):
        return jnsnet2.GRUParams(wi=a(in_dim, 3 * hidden), wh=a(hidden, 3 * hidden), bi=a(3 * hidden),
                                 bh=a(3 * hidden), linear_before_reset=1)

    return jnsnet2.NSNet2Params(fc_in_w=a(bins, hidden), fc_in_b=a(hidden), gru1=gru(hidden), gru2=gru(hidden),
                                ff1_w=a(hidden, ff), ff1_b=a(ff), ff2_w=a(ff, ff), ff2_b=a(ff),
                                out_w=a(ff, bins), out_b=a(bins))


def _np(x, dt=np.float32):
    return np.asarray(x, dt)


def _model(nodes, inits, inputs=(), outputs=()) -> bytes:
    graph = b"".join(_len_field(1, n) for n in nodes)
    graph += b"".join(_len_field(5, i) for i in inits)
    graph += b"".join(_len_field(11, _ser_value_info(n)) for n in inputs)
    graph += b"".join(_len_field(12, _ser_value_info(n)) for n in outputs)
    return _len_field(7, graph)


def _ser_int64_tensor(name: str, values) -> bytes:
    arr = np.asarray(values, "<i8")
    t = b""
    for d in arr.shape:
        t += _write_tag(1, _WT_VARINT) + _encode_varint(d)
    t += _write_tag(2, _WT_VARINT) + _encode_varint(7)  # int64
    t += _len_field(9, arr.tobytes())
    t += _len_field(8, name.encode())
    return t


def _ser_bf16(name: str, arr, encoding: str = "raw") -> bytes:
    """A BFLOAT16 TensorProto of ``arr`` rounded to nearest even: raw_data,
    or (typed) its uint16 bits as int32_data varints, the spec's encoding."""
    f = np.ascontiguousarray(np.asarray(arr, np.float32))
    u = f.view(np.uint32).astype(np.uint64)
    bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    out = b""
    for d in f.shape:
        out += _write_tag(1, _WT_VARINT) + _encode_varint(d)
    out += _write_tag(2, _WT_VARINT) + _encode_varint(16)
    if encoding == "raw":
        out += _len_field(9, bits.tobytes())
    else:
        out += _len_field(5, b"".join(_encode_varint(int(v)) for v in bits.reshape(-1)))
    out += _len_field(8, name.encode())
    return out


def _plain_graph(p, *, dtype="f32", encoding="raw", trans_b=True, scramble=False, names=None, lbr=True):
    """tests/test_onnx_formats.py's flexible Gemm-graph serializer, plus
    bf16 storage and GRUs without the linear_before_reset attribute."""
    n = names or {}

    def nm(default):
        return n.get(default, default)

    def ser(name, arr):
        if dtype == "bf16":
            return _ser_bf16(name, arr, encoding)
        return _ser_tensor(name, arr, dtype, encoding)

    lbr_attr = _ser_attr_int("linear_before_reset", p.gru1.linear_before_reset) if lbr else b""
    gemm_attrs = _ser_attr_int("transB", 1) if trans_b else b""

    def lin_w(w):
        return _np(w).T if trans_b else _np(w)

    inits = {
        nm("w0"): ser(nm("w0"), lin_w(p.fc_in_w)),
        nm("b0"): ser(nm("b0"), _np(p.fc_in_b)),
        nm("g1W"): ser(nm("g1W"), _np(p.gru1.wi).T[None]),
        nm("g1R"): ser(nm("g1R"), _np(p.gru1.wh).T[None]),
        nm("g1B"): ser(nm("g1B"), np.concatenate([_np(p.gru1.bi), _np(p.gru1.bh)])[None]),
        nm("g2W"): ser(nm("g2W"), _np(p.gru2.wi).T[None]),
        nm("g2R"): ser(nm("g2R"), _np(p.gru2.wh).T[None]),
        nm("g2B"): ser(nm("g2B"), np.concatenate([_np(p.gru2.bi), _np(p.gru2.bh)])[None]),
        nm("w1"): ser(nm("w1"), lin_w(p.ff1_w)),
        nm("b1"): ser(nm("b1"), _np(p.ff1_b)),
        nm("w2"): ser(nm("w2"), lin_w(p.ff2_w)),
        nm("b2"): ser(nm("b2"), _np(p.ff2_b)),
        nm("w3"): ser(nm("w3"), lin_w(p.out_w)),
        nm("b3"): ser(nm("b3"), _np(p.out_b)),
    }
    nodes = [
        _ser_node("Gemm", ["input", nm("w0"), nm("b0")], ["x0"], gemm_attrs),
        _ser_node("GRU", ["x0", nm("g1W"), nm("g1R"), nm("g1B")], ["x1"], lbr_attr),
        _ser_node("Squeeze", ["x1"], ["x1s"]),
        _ser_node("GRU", ["x1s", nm("g2W"), nm("g2R"), nm("g2B")], ["x2"], lbr_attr),
        _ser_node("Squeeze", ["x2"], ["x2s"]),
        _ser_node("Gemm", ["x2s", nm("w1"), nm("b1")], ["x3"], gemm_attrs),
        _ser_node("Relu", ["x3"], ["x4"]),
        _ser_node("Gemm", ["x4", nm("w2"), nm("b2")], ["x5"], gemm_attrs),
        _ser_node("Relu", ["x5"], ["x6"]),
        _ser_node("Gemm", ["x6", nm("w3"), nm("b3")], ["x7"], gemm_attrs),
        _ser_node("Sigmoid", ["x7"], ["output"]),
    ]
    init_list = list(inits.values())
    if scramble:
        rng = np.random.default_rng(3)
        init_list = [init_list[i] for i in rng.permutation(len(init_list))]
    return _model(nodes, init_list)


def _pytorch_idiom(p, h0_name="h0", extra=()):
    """The torch.onnx.export idiom of tests/test_onnx_formats.py: Constant
    weights, MatMul+Add linears (bias on either side), Unsqueeze/Transpose/
    Reshape wrapping, GRU 1 with its full 6-input signature whose initial
    state is ``h0_name`` (by default the Shape->...->ConstantOfShape zero
    subgraph), opset-13 Squeeze."""
    lbr = _ser_attr_int("linear_before_reset", 1)
    fwd = _ser_attr_str("direction", b"forward")
    hidden = _np(p.gru1.wh).shape[0]
    hs = _ser_attr_int("hidden_size", hidden)
    consts = []

    def const(name, arr):
        consts.append(_ser_node("Constant", [], [name], _ser_attr_tensor("value", _ser_tensor(name, arr))))
        return name

    def gru_b(gp):
        return np.concatenate([_np(gp.bi), _np(gp.bh)])[None]

    inits = [
        _ser_int64_tensor("sq_axes", [1]),
        _ser_int64_tensor("g_idx", 0),
        _ser_int64_tensor("h_dims", [1, hidden]),
        _ser_int64_tensor("rsh", [-1, hidden]),
        *extra,
    ]
    state_nodes = [
        _ser_node("Shape", ["x_in"], ["shp"]),
        _ser_node("Gather", ["shp", "g_idx"], ["dim0"]),
        _ser_node("Unsqueeze", ["dim0"], ["dim0u"], _ser_attr_ints("axes", (0,))),
        _ser_node("Concat", ["dim0u", "h_dims"], ["h_shape"], _ser_attr_int("axis", 0)),
        _ser_node("ConstantOfShape", ["h_shape"], ["h0"]),
    ]
    nodes = [
        _ser_node("MatMul", ["x_in", const("c_w0", _np(p.fc_in_w))], ["m0"]),
        _ser_node("Add", ["m0", const("c_b0", _np(p.fc_in_b)[None])], ["a0"]),
        _ser_node("Unsqueeze", ["a0"], ["a0u"], _ser_attr_ints("axes", (1,))),
        *state_nodes,
        _ser_node(
            "GRU",
            ["a0u", const("c_g1w", _np(p.gru1.wi).T[None]), const("c_g1r", _np(p.gru1.wh).T[None]),
             const("c_g1b", gru_b(p.gru1)), "", h0_name],
            ["y1", "y1h"],
            lbr + fwd + hs,
        ),
        _ser_node("Transpose", ["y1"], ["y1t"], _ser_attr_ints("perm", (0, 2, 1, 3))),
        _ser_node("Reshape", ["y1t", "rsh"], ["x1"]),
        _ser_node("Unsqueeze", ["x1"], ["x1u"], _ser_attr_ints("axes", (1,))),
        _ser_node(
            "GRU",
            ["x1u", const("c_g2w", _np(p.gru2.wi).T[None]), const("c_g2r", _np(p.gru2.wh).T[None]),
             const("c_g2b", gru_b(p.gru2))],
            ["y2"],
            lbr + hs,
        ),
        _ser_node("Squeeze", ["y2", "sq_axes"], ["x2"]),
        _ser_node("MatMul", ["x2", const("c_w1", _np(p.ff1_w))], ["m1"]),
        _ser_node("Add", [const("c_b1", _np(p.ff1_b)), "m1"], ["a1"]),  # bias first
        _ser_node("Relu", ["a1"], ["r1"]),
        _ser_node("MatMul", ["r1", const("c_w2", _np(p.ff2_w))], ["m2"]),
        _ser_node("Add", ["m2", const("c_b2", _np(p.ff2_b))], ["a2"]),
        _ser_node("Relu", ["a2"], ["r2"]),
        _ser_node("MatMul", ["r2", const("c_w3", _np(p.out_w))], ["m3"]),
        _ser_node("Add", ["m3", const("c_b3", _np(p.out_b))], ["a3"]),
        _ser_node("Sigmoid", ["a3"], ["out"]),
    ]
    return _model(consts + nodes, inits, inputs=["x_in"], outputs=["out"])


MISLEADING = {
    "w0": "ff2.weight", "b0": "gru1.bias", "w1": "fc_in.w", "b1": "out_b", "w2": "out.weight",
    "b2": "fc_in.b", "w3": "ff1.weight", "b3": "ff1.bias", "g1W": "gru2_W", "g1R": "gru2_R",
    "g1B": "gru2_B", "g2W": "gru1_W", "g2R": "gru1_R", "g2B": "gru1_B",
}
VALID = {
    "canonical_gemm_export": lambda p: jonnx.export_nsnet2_onnx(p),
    "pytorch_idiom_graph": _pytorch_idiom,
    "typed_float_data_transb0_scrambled_names": lambda p: _plain_graph(
        p, encoding="typed", trans_b=False, scramble=True, names=MISLEADING),
    "fp16_raw": lambda p: _plain_graph(p, dtype="f16"),
    "fp16_typed_int32_data": lambda p: _plain_graph(p, dtype="f16", encoding="typed"),
    "f64_typed_double_data": lambda p: _plain_graph(p, dtype="f64", encoding="typed"),
    "f64_raw": lambda p: _plain_graph(p, dtype="f64"),
    "bf16_raw": lambda p: _plain_graph(p, dtype="bf16"),
    "bf16_typed_int32_data": lambda p: _plain_graph(p, dtype="bf16", encoding="typed"),
    "no_linear_before_reset_attr": lambda p: _plain_graph(p, lbr=False),
}


def _alpha_gemm(p):
    alpha = _len_field(5, _len_field(1, b"alpha") + _write_tag(2, 5) + np.float32(2.0).tobytes())
    return _model([_ser_node("Gemm", ["input", "w0"], ["output"], alpha)], [_ser_tensor("w0", _np(p.fc_in_w).T)])


def _external(p):
    t = _write_tag(1, _WT_VARINT) + _encode_varint(4) + _write_tag(2, _WT_VARINT) + _encode_varint(1)
    t += _write_tag(14, _WT_VARINT) + _encode_varint(1) + _len_field(8, b"w_ext")  # EXTERNAL
    return _model([], [t])


def _missing_gru(p):
    inits = [_ser_tensor("w0", _np(p.fc_in_w).T), _ser_tensor("g1W", _np(p.gru1.wi).T[None]),
             _ser_tensor("g1R", _np(p.gru1.wh).T[None])]
    nodes = [
        _ser_node("Gemm", ["input", "w0"], ["x0"], _ser_attr_int("transB", 1)),
        _ser_node("GRU", ["x0", "g1W", "g1R"], ["x1"], _ser_attr_int("linear_before_reset", 1)),
        _ser_node("Sigmoid", ["x1"], ["output"]),
    ]
    return _model(nodes, inits)


def _softmax(p):
    nodes = [_ser_node("Gemm", ["input", "w0"], ["x0"], _ser_attr_int("transB", 1)),
             _ser_node("Softmax", ["x0"], ["output"])]
    return _model(nodes, [_ser_tensor("w0", _np(p.fc_in_w).T)])


# (blob, the message both importers must raise, matched as a regex)
REFUSED = {
    "truncated_file": (lambda p: jonnx.export_nsnet2_onnx(p)[: len(jonnx.export_nsnet2_onnx(p)) // 2], ""),
    "garbage_bytes": (lambda p: b"\xff" * 64 + b"not an onnx file" * 10, ""),
    "empty_model": (lambda p: b"", "no graph"),
    "wrong_architecture_missing_gru": (_missing_gru, "unexpected NSNet2 graph shape"),
    "unsupported_op_on_data_path": (_softmax, "Softmax"),
    "gemm_alpha_rejected": (_alpha_gemm, "alpha"),
    "external_data_rejected": (_external, "external"),
    "matmul_constant_left_rejected": (
        lambda p: _model([_ser_node("MatMul", ["w0", "input"], ["output"])], [_ser_tensor("w0", _np(p.fc_in_w))]),
        "left operand"),
    "nonzero_initial_h_rejected": (
        lambda p: _pytorch_idiom(p, h0_name="h_init", extra=[_ser_tensor("h_init", np.full((1, 1, 8), 0.5))]),
        "nonzero initial_h"),
}


def _same_weights(got: dict, jparams) -> None:
    want = _flat(jparams)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key


@pytest.mark.parametrize("case", list(VALID))
def test_imported_weights_equal_the_jax_importers(small, case):
    blob = VALID[case](small)
    got = onnx.load_nsnet2_graph(onnx.parse_model(blob))
    want = jonnx.load_nsnet2_graph(jonnx.parse_model(blob))
    _same_weights(got, want)
    assert int(got["gru1_lbr"]) == int(got["gru2_lbr"]) == (0 if case == "no_linear_before_reset_attr" else 1)
    if case in ("canonical_gemm_export", "pytorch_idiom_graph", "f64_raw"):  # storage without rounding
        _same_weights(got, small)


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_equal_the_jax_importers(small, case):
    make, match = REFUSED[case]
    blob = make(small)
    errors = []
    for module in (onnx, jonnx):
        with pytest.raises(ValueError, match=match) as info:
            module.load_nsnet2_graph(module.parse_model(blob))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_writer_bytes_equal_the_jax_writers(params):
    """Random and demo weights; and gru1 at lbr = 0 beside gru2 at 1, which
    both writers write as gru1's lbr into both GRU nodes (the JAX writer's
    fault, kept: the port is held to its bytes)."""
    demo = jnsnet2.load_npz(DEMO_WEIGHTS)
    mixed = dataclasses.replace(params, gru1=dataclasses.replace(params.gru1, linear_before_reset=0))
    for jp in (params, demo, mixed):
        blob = jonnx.export_nsnet2_onnx(jp)
        assert onnx.export_nsnet2_onnx(nsnet2.from_numpy(_flat(jp))) == blob
    back = onnx.load_nsnet2_graph(onnx.parse_model(onnx.export_nsnet2_onnx(nsnet2.from_numpy(_flat(mixed)))))
    assert int(back["gru1_lbr"]) == int(back["gru2_lbr"]) == 0


def test_genuine_torch_onnx_export(tmp_path, monkeypatch):
    """A file written by torch.onnx.export (TorchScript exporter, opset 13),
    as tests/test_onnx_formats.py makes it: both importers give the same
    weights, equal to the state_dict after the torch (r, z, n) -> ONNX
    (z, r, n) gate permutation; the port's model from them against the
    torch module within 2e-6."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    monkeypatch.setattr(onnx_proto_utils, "_add_onnxscript_fn", lambda model_bytes, custom_opsets: model_bytes)
    torch.manual_seed(5)

    class NSNet2Torch(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc_in = torch.nn.Linear(161, 400)
            self.gru = torch.nn.GRU(400, 400, num_layers=2)
            self.ff1 = torch.nn.Linear(400, 600)
            self.ff2 = torch.nn.Linear(600, 600)
            self.out = torch.nn.Linear(600, 161)

        def forward(self, x):  # [T, 161]
            h, _ = self.gru(self.fc_in(x).unsqueeze(1))
            h = torch.relu(self.ff1(h.squeeze(1)))
            return torch.sigmoid(self.out(torch.relu(self.ff2(h))))

    m = NSNet2Torch().eval()
    x = torch.randn(8, 161)
    path = tmp_path / "nsnet2_torch.onnx"
    with torch.no_grad():
        torch.onnx.export(m, (x,), str(path), input_names=["input"], output_names=["output"],
                          dynamo=False, opset_version=13)
    blob = path.read_bytes()
    got = onnx.load_nsnet2_graph(onnx.parse_model(blob))
    _same_weights(got, jonnx.load_nsnet2_graph(jonnx.parse_model(blob)))

    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    h = 400

    def to_onnx_gates(w):
        return np.concatenate([w[h : 2 * h], w[:h], w[2 * h :]])

    assert np.array_equal(got["fc_in_w"], sd["fc_in.weight"].T)
    for layer, name in ((0, "gru1"), (1, "gru2")):
        assert int(got[f"{name}_lbr"]) == 1
        assert np.array_equal(got[f"{name}_wi"], to_onnx_gates(sd[f"gru.weight_ih_l{layer}"]).T)
        assert np.array_equal(got[f"{name}_wh"], to_onnx_gates(sd[f"gru.weight_hh_l{layer}"]).T)
        assert np.array_equal(got[f"{name}_bi"], to_onnx_gates(sd[f"gru.bias_ih_l{layer}"]))
        assert np.array_equal(got[f"{name}_bh"], to_onnx_gates(sd[f"gru.bias_hh_l{layer}"]))
    for name in ("ff1", "ff2", "out"):
        assert np.array_equal(got[f"{name}_w"], sd[f"{name}.weight"].T)
        assert np.array_equal(got[f"{name}_b"], sd[f"{name}.bias"])
    with torch.inference_mode():
        np.testing.assert_allclose(nsnet2.from_numpy(got)(x).numpy(), m(x).numpy(), rtol=0, atol=2e-6)


def test_load_denoiser_routes_onnx(tmp_path, params, small):
    """``load_denoiser("*.onnx")`` and ``nsnet2.load``: the demo weights
    through the writer come back as the ``.npz`` model's, bit for bit; a
    file whose GRUs carry lbr = 0 loads with lbr = 0 and scores through the
    plain loop as the JAX model does (atol 1e-5); a file of other widths,
    a missing file and another suffix are refused."""
    demo = registry.load_denoiser("demo", device="cpu")
    path = tmp_path / "demo.onnx"
    path.write_bytes(onnx.export_nsnet2_onnx(demo))
    got = registry.load_denoiser(str(path), device="cpu")
    assert isinstance(got, nsnet2.NSNet2)
    for (name, a), (_, b) in zip(demo.named_parameters(), got.named_parameters()):
        assert torch.equal(a, b), name
    lbr0 = tmp_path / "lbr0.onnx"
    lbr0.write_bytes(_plain_graph(params, lbr=False))
    net = nsnet2.load(str(lbr0))
    assert net.gru1.linear_before_reset == net.gru2.linear_before_reset == 0
    feats = np.random.default_rng(4).normal(-3.0, 1.5, (2, 8, 161)).astype(np.float32)
    want = np.asarray(jnsnet2.apply(jonnx.load_nsnet2_onnx(str(lbr0)), jnp.asarray(feats)))
    with torch.inference_mode():
        np.testing.assert_allclose(net(torch.from_numpy(feats)).numpy(), want, rtol=0, atol=1e-5)
    narrow = tmp_path / "narrow.onnx"
    narrow.write_bytes(jonnx.export_nsnet2_onnx(small))
    with pytest.raises(ValueError, match="fc_in_w has shape"):
        registry.load_denoiser(str(narrow), device="cpu")
    with pytest.raises(OSError):
        registry.load_denoiser(str(tmp_path / "missing.onnx"), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        nsnet2.load(str(tmp_path / "weights.pt"))


def test_imported_model_segments_equal_the_jax_packages(tmp_path):
    """The demo weights written as ONNX and imported by each package score
    2 synthetic streams x 20 s to the same segments (ratio at rtol 1e-6,
    ROADMAP §3 fault 1)."""
    path = tmp_path / "demo.onnx"
    path.write_bytes(jonnx.export_nsnet2_onnx(jnsnet2.load_npz(DEMO_WEIGHTS)))
    rng = np.random.default_rng(3)
    audio = np.stack([synth.synth_stream(rng, 20.0)[0] for _ in range(2)])
    got = BatchRunner(registry.load_denoiser(str(path), device="cpu"), VADConfig()).run(audio)
    want = JBatchRunner(jnsnet2.load(str(path)), JVADConfig(), use_mesh=False).run(audio)
    n = 0
    for g, w in zip(got, want):
        assert len(g.segments) == len(w.segments)
        for a, b in zip(g.segments, w.segments):
            assert {k: a[k] for k in ("sample_from", "sample_to", "vad_met_sec")} == {
                k: b[k] for k in ("sample_from", "sample_to", "vad_met_sec")}
            assert a["avg_channel_vol_ratio"] == pytest.approx(b["avg_channel_vol_ratio"], rel=1e-6)
            n += 1
    assert n > 0
