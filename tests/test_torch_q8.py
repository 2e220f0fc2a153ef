"""The port's int8 denoiser tier (``ops/precision.py``, ``models/
nsnet2_q8.py``) against the JAX package's (``models/nsnet2_q8.py``).

Bars: quantized weights, scales and activations bit for bit (the same
float32 operations, and ``torch.round`` rounds half to even as ``jnp.round``
does). The int8 gains are held at max |d| < 0.05 and mean < 5e-3, the JAX
package's own bound for this path across batchings (tests/test_quant.py):
a one-ulp difference before quantization can move a value into the next
int8 step. The int8 slice gives the same segments within one FSM window
and window volumes within 5% (the bound of tests/test_quant.py for the int8
tier against float).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models import nsnet2_q8 as jq8
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.ops import precision as jprecision
from formula_vad_tpu.parallel.runner import BatchRunner as JBatchRunner
from formula_vad_tpu.pipeline import offline as joffline
from formula_vad_tpu.pipeline import vad as jvad
from formula_vad_tpu_torch.config import VADConfig
from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_q8, registry
from formula_vad_tpu_torch.ops import matmul_q8 as mq
from formula_vad_tpu_torch.ops import precision
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.pipeline import offline, vad
from formula_vad_tpu_torch.testing.synth import synth_stream

FFT = 1024


@pytest.fixture(autouse=True)
def _restore_precision():
    yield
    jprecision.set_quant("off")
    jprecision.set_matmul_precision("highest")
    jprecision.set_io_dtype("f32")
    precision.set_quant("off")


@pytest.fixture(scope="module")
def pair():
    return jnsnet2.load_npz(DEMO_WEIGHTS), registry.load_denoiser("demo", device="cpu")


@pytest.fixture(scope="module")
def feats():
    # Log-power-spectrum-shaped features, as tests/test_quant.py makes them.
    return (np.random.RandomState(7).rand(2, 54, 161) * 10.0 - 9.0).astype(np.float32)


def _count_matmuls(monkeypatch) -> list:
    """Count the wrapper's dispatches to the plain version (the CPU route)."""
    calls = [0]
    plain = mq.matmul_q8_reference

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(mq, "matmul_q8_reference", counted)
    return calls


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy().reshape(want.shape)
    return got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize(
    "layer, quant",
    [("fc_in_w", "qw"), ("ff1_w", "qw_static"), ("ff2_w", "qw"), ("out_w", "qw"),
     ("gru1.wi", "qw_static"), ("gru1.wh", "qw_static"), ("gru2.wi", "qw_static"), ("gru2.wh", "qw_static")],
)
def test_weight_quant_equals_jax(pair, layer, quant):
    jp, net = pair
    obj, key = (jp, layer) if "." not in layer else (getattr(jp, layer.split(".")[0]), layer.split(".")[1])
    jw = getattr(obj, key)
    tw = torch.from_numpy(np.array(jw, np.float32))
    q, s = getattr(nsnet2_q8, quant)(tw)
    jqv, js = getattr(jq8, "_" + quant)(jw)
    assert _same(q, jqv) and _same(s, js)
    if layer.startswith("gru"):
        # The port quantizes z|r|n as one [in, 1200] matrix; the reference
        # per gate (_qgru). Per-column quant makes the two the same.
        (wi3, wh3, _, _) = jq8._qgru(obj)
        gates = wi3 if key == "wi" else wh3
        assert _same(q, jnp.concatenate([g[0] for g in gates], axis=-1))
        assert _same(s, jnp.concatenate([g[1] for g in gates], axis=-1))


def test_packed_weights_hold_the_quantized_values(pair):
    _, net = pair
    w = nsnet2_q8.quantize(net)
    assert set(w) == {"fc_in", "wi1", "wh1", "wi2", "wh2", "ff1", "ff2", "out"}
    q, s = nsnet2_q8.qw_static(net.gru2.wh)
    assert torch.equal(w["wh2"].qt[:, : w["wh2"].k], q.t()) and torch.equal(w["wh2"].scale, s)
    assert torch.equal(w["wh2"].bias, net.gru2.bh) and w["fc_in"].qt.shape == (400, 192)


def test_activation_quant_equals_jax(feats):
    x = feats * 3.0
    q, s = nsnet2_q8.qa_dyn(torch.from_numpy(x))
    jqv, js = jq8._qa_dyn(jnp.asarray(x))
    assert _same(q, jqv) and _same(s, js)
    h = np.tanh(np.random.RandomState(1).standard_normal((6, 400)) * 3.0).astype(np.float32)
    h[0, :3] = (1.0, -1.0, 0.5 / 127.0)  # the clip and a round-half-to-even tie
    assert _same(nsnet2_q8.qa_static(torch.from_numpy(h)), jq8._qa_static(jnp.asarray(h)))


def test_int8_gains_match_jax(pair, feats):
    jp, net = pair
    float_gains = np.asarray(jnsnet2.apply(jp, jnp.asarray(feats), out_frames=50), np.float64)
    jprecision.set_quant("int8")
    precision.set_quant("int8")
    want = np.asarray(jnsnet2.apply(jp, jnp.asarray(feats), out_frames=50), np.float64)
    with torch.inference_mode():
        got = net(torch.from_numpy(feats), out_frames=50).numpy().astype(np.float64)
    assert got.shape == want.shape == (2, 50, 161)
    d = np.abs(got - want)
    assert d.max() < 0.05 and d.mean() < 5e-3, (d.max(), d.mean())
    # Both tiers really ran int8 (not a vacuous pass through the float path).
    assert np.abs(want - float_gains).max() > 0 and np.abs(got - float_gains).max() > 0


def test_int8_state_bounded(pair, monkeypatch):
    """|h| <= 1 holds under wild inputs, which the static in-scan scale 127
    relies on."""
    _, net = pair
    seen = [0.0]
    gates = nsnet2_q8._gates

    def watched(gi, gh, h):
        out = gates(gi, gh, h)
        seen[0] = max(seen[0], float(out.abs().max()))
        return out

    monkeypatch.setattr(nsnet2_q8, "_gates", watched)
    wild = torch.from_numpy(np.random.RandomState(0).randn(3, 30, 161).astype(np.float32) * 50)
    precision.set_quant("int8")
    with torch.inference_mode():
        gains = net(wild)
    assert 0.0 < seen[0] <= 1.0 + 1e-6
    assert bool(torch.isfinite(gains).all()) and bool(((gains >= 0) & (gains <= 1)).all())


def test_int8_forward_launch_count(pair, feats, monkeypatch):
    """3 per step, plus fc_in, gi1, ff1, ff2 and out: 167 at 54 steps; the
    float GRU is not run."""
    _, net = pair
    calls = _count_matmuls(monkeypatch)

    def no_float_gru(*args, **kw):
        raise AssertionError("the float GRU ran under the int8 tier")

    monkeypatch.setattr(nsnet2_cuda, "gru_stack_reference", no_float_gru)
    precision.set_quant("int8")
    with torch.inference_mode():
        net(torch.from_numpy(feats), out_frames=50)
    assert calls[0] == 167
    net(torch.from_numpy(feats[:, :10]))
    assert calls[0] == 167 + 3 * 10 + 5


def test_lbr0_keeps_float_path(feats, monkeypatch):
    net = registry.load_denoiser("random", seed=3, device="cpu")
    net.gru1.linear_before_reset = net.gru2.linear_before_reset = 0
    x = torch.from_numpy(feats)
    with torch.inference_mode():
        ref = net(x)
        calls = _count_matmuls(monkeypatch)
        precision.set_quant("int8")
        got = net(x)
    assert calls[0] == 0 and torch.equal(ref, got)


def test_weight_cache_follows_the_weights():
    net = registry.load_denoiser("demo", device="cpu")
    first = nsnet2_q8._weights(net)
    assert nsnet2_q8._weights(net) is first
    with torch.no_grad():
        net.ff2.w.data = net.ff2.w.data * 2.0  # a replaced tensor re-quantizes
    assert torch.equal(nsnet2_q8._weights(net)["ff2"].scale, first["ff2"].scale * 2.0)


def test_weight_cache_follows_in_place_loads(feats):
    """``load_state_dict`` writes the parameters in place (same data_ptr):
    the next int8 forward quantizes the new weights, as a fresh module's
    does, and not the cached ones."""
    net = registry.load_denoiser("random", seed=3, device="cpu")
    demo = registry.load_denoiser("demo", device="cpu")
    x = torch.from_numpy(feats)
    precision.set_quant("int8")
    with torch.inference_mode():
        first = net(x, out_frames=50)
    net.load_state_dict(demo.state_dict())
    with torch.inference_mode():
        got = net(x, out_frames=50)
        want = registry.load_denoiser("demo", device="cpu")(x, out_frames=50)
    assert torch.equal(got, want)
    assert not torch.equal(got, first)


def test_set_quant_validates():
    with pytest.raises(ValueError):
        precision.set_quant("int4")
    assert not precision.quant_int8()
    precision.set_quant("int8")
    assert precision.quant_int8()


@pytest.fixture
def reload_precision(monkeypatch):
    """Re-import ops/precision under a patched environment, and restore it."""
    for name in ("FVAD_QUANT", "FVAD_PRECISION", "FVAD_IO_DTYPE"):
        monkeypatch.delenv(name, raising=False)

    def reload(**env):
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        return importlib.reload(precision)

    yield reload
    monkeypatch.undo()
    importlib.reload(precision)


@pytest.mark.parametrize(
    "env, error, match",
    [
        ({"FVAD_QUANT": "int4"}, ValueError, "FVAD_QUANT"),
        ({"FVAD_PRECISION": "fastest"}, ValueError, "FVAD_PRECISION"),
        ({"FVAD_IO_DTYPE": "f16"}, ValueError, "FVAD_IO_DTYPE"),
    ],
)
def test_env_guards(reload_precision, env, error, match):
    """A value outside a switch's choices raises at import."""
    with pytest.raises(error, match=match):
        reload_precision(**env)
        registry.load_denoiser("demo", device="cpu")(torch.zeros((1, 3, 161)))


@pytest.mark.parametrize("level", [None, "default", "high"])
def test_env_runs_int8_with_bf16_storage(reload_precision, monkeypatch, level):
    """FVAD_QUANT=int8 with FVAD_IO_DTYPE=bf16, at every matmul level: the
    forward runs the int8 model (3T + 5 int8 products) and stores its gains
    in bf16, as the JAX package's ``apply_streaming_q8`` does."""
    env = {"FVAD_QUANT": "int8", "FVAD_IO_DTYPE": "bf16", **({"FVAD_PRECISION": level} if level else {})}
    reload_precision(**env)
    calls = _count_matmuls(monkeypatch)
    with torch.inference_mode():
        gains = registry.load_denoiser("demo", device="cpu")(torch.zeros((1, 3, 161)))
    assert calls[0] == 3 * 3 + 5 and gains.dtype == torch.bfloat16 and bool(torch.isfinite(gains.float()).all())


def test_env_selects_int8(reload_precision):
    assert reload_precision(FVAD_QUANT="INT8", FVAD_PRECISION="highest", FVAD_IO_DTYPE="f32").quant_int8()
    assert not reload_precision(FVAD_QUANT="off").quant_int8()


@pytest.fixture(scope="module")
def int8_runs():
    """The JAX and port BatchRunners and window inputs under int8, on the
    slice's synthetic streams (2 x 20 s, one of them ragged)."""
    rng = np.random.default_rng(0)
    audio = np.stack([synth_stream(rng, 20.0)[0] for _ in range(2)])
    lengths = [audio.shape[-1], audio.shape[-1] - 70_000]
    n_valid = np.array([n // 24000 for n in lengths], np.int32)
    t = (audio.shape[-1] // 24000) * 24000
    jp = jnsnet2.load_npz(DEMO_WEIGHTS)
    net = registry.load_denoiser("demo", device="cpu")
    jprecision.set_quant("int8")
    precision.set_quant("int8")
    try:
        want = JBatchRunner(jp, JVADConfig()).run(audio, lengths)
        got = BatchRunner(net, VADConfig()).run(audio, lengths)
        want_mv = np.asarray(
            joffline.window_inputs_batch(jp, jvad.statics_from_config(JVADConfig()), jnp.asarray(audio[..., :t]),
                                         jnp.asarray(n_valid))[0]
        )
        with torch.inference_mode():
            got_mv = offline.window_inputs_batch(
                net, vad.statics_from_config(VADConfig()), torch.from_numpy(audio[..., :t]), torch.from_numpy(n_valid)
            )[0].numpy()
    finally:
        jprecision.set_quant("off")
        precision.set_quant("off")
    return want, got, want_mv, got_mv


def test_int8_slice_segments_match_jax(int8_runs):
    want, got, _, _ = int8_runs
    assert sum(len(r.segments) for r in want) > 0
    for w, g in zip(want, got):
        assert len(g.segments) == len(w.segments)
        for a, b in zip(g.segments, w.segments):
            assert abs(a["sample_from"] - b["sample_from"]) <= FFT
            assert abs(a["sample_to"] - b["sample_to"]) <= FFT


def test_int8_slice_window_volumes_match_jax(int8_runs):
    _, _, want_mv, got_mv = int8_runs
    assert got_mv.shape == want_mv.shape
    d = np.abs(got_mv.astype(np.float64) - want_mv)
    assert d.max() <= 0.05 * max(np.abs(want_mv).max(), 1e-9), d.max()
