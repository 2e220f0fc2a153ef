"""The port's precision tiers (``ops/precision.py``) against the JAX
package's: the API contract, the 'default' and 'high' products, bf16
activation storage, the model forward at each tier and the scoring slice.

XLA:CPU computes every precision level the same way
(tests/test_stage_precision.py), so the JAX package's main path at 'default'
is plain float32 here. The numbers of the bf16 tier are therefore held to
JAX computations on bf16 arrays, which do round on the CPU: the product to
``jnp.matmul`` of bf16 operands with ``preferred_element_type=float32``
(bar: 1e-6 relative to the operands' scale, the float32 summation order),
and the forward to a reference written here from such products and the TPU
kernel 5 (``benchmarks/gru_kernel_exp.gru_stack_kernel_p``) run in interpret
mode with bf16 weights (bar: gains max 2e-3, mean 2e-5; another float32
summation order now and then moves an h value across a bf16 rounding step).
The bf16 tier's simulator run (``--precision default``) is held to the JAX
float tier on decisions only: the same segment count, every boundary within
one FSM window (1,024 samples).

'high' (bf16_3x) is held to three JAX products of the bf16 halves with
``preferred_element_type=float32`` (bar: 2e-8 relative to the operands'
scale, the float32 summation order, 20x below its distance from the float32
product), and its forward, whose recurrence runs bf16_3x products (kernel
A's plain version), to a ``lax.scan`` of such products over
``jnsnet2._gates_lbr`` (``_jax_scan_forward``; bar: gains max 2e-6, mean
3e-7; the recurrence's float32 summation order over the steps). bf16
storage: its forward to bf16-rounded JAX pieces and the TPU kernel 6 in
interpret mode with a bf16 out (bar: gains max 4e-3, one bf16 step of a
gain in [0.5, 1), mean 2e-5; both 10x below its distance from the float
and bf16 tiers); its simulator run (``--precision default --io-dtype
bf16``) to the JAX package's bf16_io run on decisions: the same segment
count, every boundary within one FSM window. The forwards at 'high' and
under bf16 storage use random weights (the JAX ``init_params``), whose
gains stay near 0.5, where the demo weights' saturate.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import gru_kernel_exp as jexp
from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.ops import precision as jprecision
from formula_vad_tpu.parallel.runner import BatchRunner as JBatchRunner
from formula_vad_tpu_torch.apps import simulator as sim
from formula_vad_tpu_torch.io_ import AudioSource
from formula_vad_tpu_torch.models import nsnet2, nsnet2_cuda, nsnet2_gates_cuda, registry
from formula_vad_tpu_torch.ops import precision
from formula_vad_tpu_torch.testing.synth import write_corpus

FFT = 1024
NAMES = {jax.lax.Precision.HIGHEST: "highest", jax.lax.Precision.HIGH: "high", jax.lax.Precision.DEFAULT: "default"}


@pytest.fixture(autouse=True)
def _restore():
    yield
    for module in (precision, jprecision):
        module.set_stage_overrides(None)
        module.set_matmul_precision("highest")
        module.set_io_dtype("f32")
        module.set_quant("off")


def _both(fn):
    """Apply ``fn`` to both modules; -> (port result, JAX result as a name)."""
    got, want = fn(precision), fn(jprecision)
    return got, NAMES.get(want, want)


def test_routing_matches_jax():
    for level in ("highest", "high", "default"):
        assert _both(lambda m: m.set_matmul_precision(level)) == (None, None)
        for stage in precision.STAGES + (None,):
            assert _both(lambda m: m.matmul_precision(stage)) == (level, level)
    assert precision.STAGES == jprecision.STAGES
    _both(lambda m: m.set_matmul_precision("highest"))
    _both(lambda m: m.set_stage_precision("gru_h", "default"))
    for stage in precision.STAGES:
        got, want = _both(lambda m: m.matmul_precision(stage))
        assert got == want == ("default" if stage == "gru_h" else "highest")
    assert _both(lambda m: m.matmul_precision()) == ("highest", "highest")
    _both(lambda m: m.set_stage_precision("gru_h", None))
    assert _both(lambda m: m.matmul_precision("gru_h")) == ("highest", "highest")


def test_overrides_match_jax():
    _both(lambda m: m.set_stage_overrides({"band": "default", "ff": "default"}))
    assert precision.stage_overrides() == jprecision.stage_overrides() == {"band": "default", "ff": "default"}
    _both(lambda m: m.set_stage_overrides({"stft": "highest"}))
    assert precision.stage_overrides() == jprecision.stage_overrides() == {"stft": "highest"}
    _both(lambda m: m.set_stage_overrides(None))
    assert precision.stage_overrides() == jprecision.stage_overrides() == {}


@pytest.mark.parametrize(
    "call, match",
    [(lambda m: m.set_stage_precision("nonsense", "default"), "stage"),
     (lambda m: m.set_stage_precision("stft", "fastest"), "precision"),
     (lambda m: m.set_matmul_precision("fastest"), "precision")],
)
def test_validation_matches_jax(call, match):
    for module in (precision, jprecision):
        with pytest.raises(ValueError, match=match):
            call(module)


def test_bf16_3x_is_selectable():
    """'high' is selected globally, for one stage and through the override
    map, as in the JAX package."""
    assert _both(lambda m: m.set_matmul_precision("high")) == (None, None)
    assert _both(lambda m: m.matmul_precision("ff")) == ("high", "high")
    _both(lambda m: m.set_matmul_precision("highest"))
    _both(lambda m: m.set_stage_precision("ff", "high"))
    assert _both(lambda m: m.matmul_precision("ff")) == ("high", "high")
    assert _both(lambda m: m.matmul_precision("band")) == ("highest", "highest")
    _both(lambda m: m.set_stage_overrides({"stft": "high", "ff": "default"}))
    assert precision.stage_overrides() == jprecision.stage_overrides() == {"stft": "high", "ff": "default"}
    assert _both(lambda m: m.matmul_precision("ff")) == ("default", "default")


def test_io_dtype_matches_jax():
    x = np.linspace(-3.0, 3.0, 7, dtype=np.float32) / 3.0
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        _both(lambda m: m.set_io_dtype(name))
        assert precision.io_dtype() == dtype and (jprecision.io_dtype() is None) == (dtype is None)
        got = precision.io_cast(torch.from_numpy(x))
        want = np.asarray(jprecision.io_cast(jnp.asarray(x)))
        assert got.dtype == (dtype or torch.float32) and str(want.dtype) == ("bfloat16" if dtype else "float32")
        assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    for module in (precision, jprecision):
        with pytest.raises(ValueError, match="io dtype"):
            module.set_io_dtype("f16")
        module.set_io_dtype("f32")


@pytest.fixture
def reload_precision(monkeypatch):
    """Re-import ops/precision under a patched environment (only ``env``
    of its three variables set), and restore it."""

    def reload(**env):
        for name in ("FVAD_QUANT", "FVAD_PRECISION", "FVAD_IO_DTYPE"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        return importlib.reload(precision)

    yield reload
    monkeypatch.undo()
    importlib.reload(precision)


def test_env_selects_every_tier(reload_precision):
    assert reload_precision(FVAD_PRECISION="DEFAULT").matmul_precision("band") == "default"
    assert reload_precision(FVAD_PRECISION="high").matmul_precision("ff") == "high"
    assert reload_precision(FVAD_PRECISION="highest").matmul_precision() == "highest"
    assert reload_precision(FVAD_IO_DTYPE="bf16").io_dtype() == torch.bfloat16
    assert reload_precision(FVAD_IO_DTYPE="f32").io_dtype() is None
    for env in ({"FVAD_PRECISION": "fastest"}, {"FVAD_IO_DTYPE": "f16"}, {"FVAD_QUANT": "int4"}):
        with pytest.raises(ValueError, match=next(iter(env))):
            reload_precision(**env)


@pytest.mark.parametrize("shape", [(37, 161, 400), (3, 54, 400, 1200)])
def test_default_product_matches_jax_bf16(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.standard_normal(shape[:-1]).astype(np.float32) * 3.0
    b = rng.standard_normal(shape[-2:]).astype(np.float32) * 0.1
    want = np.asarray(
        jnp.matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), preferred_element_type=jnp.float32)
    )
    precision.set_matmul_precision("default")
    got = precision.matmul(torch.from_numpy(a), torch.from_numpy(b), "fc_in")
    assert got.dtype == torch.float32
    scale = np.abs(a).max() * np.abs(b).max() * a.shape[-1]
    d = np.abs(got.numpy() - want).max()
    assert d <= 1e-6 * scale, (d, scale)
    # Not a float32 product: the operands were rounded.
    assert np.abs(a @ b - want).max() > 100 * d
    # At 'highest', and for a stage overridden to it, the product is a @ b.
    precision.set_stage_precision("fc_in", "highest")
    assert torch.equal(precision.matmul(torch.from_numpy(a), torch.from_numpy(b), "fc_in"),
                       torch.from_numpy(a) @ torch.from_numpy(b))


def _jdot(x, y):
    return jnp.matmul(x, y, preferred_element_type=jnp.float32)


def _jax_bf16_3x(a, b):
    """bf16_3x from JAX pieces: each operand's bf16 high half and the bf16
    rounding of the rest; the two small products, then the large one."""

    def split(x):
        hi = x.astype(jnp.bfloat16)
        return hi, (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)

    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return (_jdot(a_hi, b_lo) + _jdot(a_lo, b_hi)) + _jdot(a_hi, b_hi)


@pytest.mark.parametrize("shape", [(37, 161, 400), (3, 54, 400, 1200)])
def test_high_product_matches_jax_bf16_3x(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.standard_normal(shape[:-1]).astype(np.float32) * 3.0
    b = rng.standard_normal(shape[-2:]).astype(np.float32) * 0.1
    want = np.asarray(_jax_bf16_3x(jnp.asarray(a), jnp.asarray(b)))
    precision.set_matmul_precision("high")
    got = precision.matmul(torch.from_numpy(a), torch.from_numpy(b), "fc_in")
    assert got.dtype == torch.float32
    scale = np.abs(a).max() * np.abs(b).max() * a.shape[-1]
    d = np.abs(got.numpy() - want).max()
    assert d <= 2e-8 * scale, (d, scale)
    # Not the float32 product (lo x lo is dropped), and far closer to it
    # than the single-pass bf16 product.
    assert np.abs(a @ b - want).max() > 10 * d
    single = np.asarray(_jdot(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)))
    assert np.abs(single - want).max() > 100 * np.abs(a @ b - want).max()


@pytest.mark.parametrize("level", ["highest", "high", "default"])
def test_bf16_operands_multiply_exactly_at_every_level(level):
    """Under bf16 storage both operands are bf16: every level multiplies
    them exactly and rounds the float32 sums once to bf16, as ``jnp.matmul``
    of two bf16 arrays; a bf16 operand against a float32 one is promoted."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((5, 33, 161)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((161, 400)).astype(np.float32) * 0.1).to(torch.bfloat16)
    precision.set_matmul_precision(level)
    got = precision.matmul(a, b, "stft")
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    w = np.asarray(jnp.matmul(jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(b.float().numpy(), jnp.bfloat16)))
    w = w.astype(np.float32)
    # The same bf16 value but where another float32 summation order (1e-6
    # of the operands' scale, as above) lands on the other side of a
    # rounding step: one bf16 step, 2^-7 of the value.
    scale = float(a.float().abs().max() * b.float().abs().max()) * a.shape[-1]
    assert np.all(np.abs(g - w) <= 2.0**-7 * np.abs(w) + 1e-6 * scale), np.abs(g - w).max()
    assert np.mean(g == w) > 0.99
    mixed = precision.matmul(a, b.float(), "stft")
    assert mixed.dtype == torch.float32 and torch.equal(mixed, a.float() @ b.float())


def _bf16_dense(x, w, b):
    return jnp.matmul(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16), preferred_element_type=jnp.float32) + b


def _jax_bf16_forward(jp, feats):
    """The bf16 tier's forward from JAX pieces that really round on the
    CPU: fc_in, gi1 and the head as bf16-operand products, the recurrence
    through the TPU kernel 5 with bf16 weights (interpret mode)."""
    h = jnsnet2.HIDDEN
    g1 = jp.gru1
    x = _bf16_dense(feats, jp.fc_in_w, jp.fc_in_b)
    gi1 = _bf16_dense(x, g1.wi, 0.0)
    gi_z = gi1[..., :h] + (g1.bi[:h] + g1.bh[:h])
    gi_r = gi1[..., h : 2 * h] + (g1.bi[h : 2 * h] + g1.bh[h : 2 * h])
    gi_n = gi1[..., 2 * h :] + g1.bi[2 * h :]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jexp, "INTERPRET", True)
        mp.setattr(jexp, "ROW_TILE", 8)
        y = jexp.gru_stack_kernel_p(jp, gi_z, gi_r, gi_n, dtype=jnp.bfloat16)
    y = jax.nn.relu(_bf16_dense(y, jp.ff1_w, jp.ff1_b))
    y = jax.nn.relu(_bf16_dense(y, jp.ff2_w, jp.ff2_b))
    return jax.nn.sigmoid(_bf16_dense(y, jp.out_w, jp.out_b))


def test_forward_at_default_matches_jax_bf16(monkeypatch):
    jp = jnsnet2.load_npz(DEMO_WEIGHTS)
    net = registry.load_denoiser("demo", device="cpu")
    feats = np.random.default_rng(7).normal(-3.0, 1.5, (12, 10, 161)).astype(np.float32)
    want = np.asarray(_jax_bf16_forward(jp, jnp.asarray(feats)), np.float64)
    with torch.inference_mode():
        float_gains = net(torch.from_numpy(feats)).numpy()
        precision.set_matmul_precision("default")
        calls = [0]
        plain = nsnet2_gates_cuda.gru_gates_p_reference

        def counted(*args, **kw):
            calls[0] += 1
            return plain(*args, **kw)

        monkeypatch.setattr(nsnet2_gates_cuda, "gru_gates_p_reference", counted)
        monkeypatch.setattr(nsnet2_cuda, "gru_stack_reference", None)  # the float recurrence must not run
        got = net(torch.from_numpy(feats)).numpy()
    assert calls[0] == 1
    d = np.abs(got - want)
    assert d.max() <= 2e-3 and d.mean() <= 2e-5, (d.max(), d.mean())
    assert np.abs(float_gains - want).mean() > 10 * d.mean()  # the tier really rounded


@pytest.fixture(scope="module")
def random_pair(tmp_path_factory):
    """(JAX params, port module) holding the JAX ``init_params(PRNGKey(21))``."""
    jp = jnsnet2.init_params(jax.random.PRNGKey(21))
    path = str(tmp_path_factory.mktemp("weights") / "init21.npz")
    jnsnet2.save_npz(path, jp)
    feats = np.random.default_rng(7).normal(-3.0, 1.5, (12, 10, 161)).astype(np.float32)
    return jp, nsnet2.load_npz(path), feats


_LEVEL_INDEX = {"highest": 0, "high": 1, "default": 2}
# A float32 product at each level from JAX pieces that round on the CPU:
# ``jnp.matmul`` at 'highest', ``_jax_bf16_3x`` at 'high', bf16 operands
# with float32 sums at 'default' (in ``_LEVEL_INDEX`` order).
_JAX_PRODUCTS = (
    lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST),
    lambda a, b: _jax_bf16_3x(a, b),
    lambda a, b: _jdot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)),
)


@jax.jit
def _jax_scan(jp, feats, codes):
    """The forward from JAX pieces, each stage's products at its level
    (``codes``: the ``_LEVEL_INDEX`` of fc_in, gru_i, gru_h and ff, an
    argument, so that one program serves every level): fc_in, the layer-1
    input projection (gru_i) and the head as products at their stage's
    level; the recurrence a ``lax.scan`` over ``jnsnet2._gates_lbr`` (lbr =
    1) or the lbr = 0 gate math of ``gru_cell_pre``, with h1 Wh1 and h2 Wh2
    at gru_h and h1 Wi2 at gru_i, as the JAX package's TPU runs each product
    at its stage's level. -> (gains, h2 sequence)."""
    h = jnsnet2.HIDDEN

    def product(stage):
        return lambda a, b: jax.lax.switch(codes[stage], _JAX_PRODUCTS, a, b)

    p_fc, p_i, p_h, p_ff = map(product, range(4))

    def cell(g, hp, gi):
        if g.linear_before_reset:
            return jnsnet2._gates_lbr(gi, p_h(hp, g.wh) + g.bh, hp)
        z = jax.nn.sigmoid(gi[..., :h] + p_h(hp, g.wh[:, :h]) + g.bh[:h])
        r = jax.nn.sigmoid(gi[..., h : 2 * h] + p_h(hp, g.wh[:, h : 2 * h]) + g.bh[h : 2 * h])
        n = jnp.tanh(gi[..., 2 * h :] + p_h(r * hp, g.wh[:, 2 * h :]) + g.bh[2 * h :])
        return (1.0 - z) * n + z * hp

    g1, g2 = jp.gru1, jp.gru2
    gi1 = p_i(p_fc(feats, jp.fc_in_w) + jp.fc_in_b, g1.wi) + g1.bi

    def step(carry, gi_t):
        h1, h2 = carry
        h1 = cell(g1, h1, gi_t)
        h2 = cell(g2, h2, p_i(h1, g2.wi) + g2.bi)
        return (h1, h2), h2

    zero = jnp.zeros(gi1.shape[:-2] + (h,), jnp.float32)
    _, ys = jax.lax.scan(step, (zero, zero), jnp.moveaxis(gi1, -2, 0))
    y = jnp.moveaxis(ys, 0, -2)
    a = jax.nn.relu(p_ff(y, jp.ff1_w) + jp.ff1_b)
    a = jax.nn.relu(p_ff(a, jp.ff2_w) + jp.ff2_b)
    return jax.nn.sigmoid(p_ff(a, jp.out_w) + jp.out_b), y


def _jax_scan_forward(jp, feats, fc_in="highest", gru_i="highest", gru_h="highest", ff="highest"):
    """``_jax_scan`` at the stages' levels -> numpy (gains, h2 sequence)."""
    codes = jnp.asarray([_LEVEL_INDEX[level] for level in (fc_in, gru_i, gru_h, ff)], jnp.int32)
    gains, y = _jax_scan(jp, jnp.asarray(feats), codes)
    return np.asarray(gains, np.float64), np.asarray(y, np.float64)


def _jax_high_forward(jp, feats):
    """The 'high' tier's forward from JAX pieces (``_jax_scan_forward``):
    every product bf16_3x, the recurrence's too, as the JAX package's TPU
    runs its scan and kernel 1 at ``Precision.HIGH``."""
    return _jax_scan_forward(jp, feats, "high", "high", "high", "high")[0]


def _counting(monkeypatch, module, names: tuple, forbidden: tuple) -> dict:
    """Count calls of ``module``'s plain versions ``names``; the plain
    versions ``forbidden`` (of nsnet2_cuda or nsnet2_gates_cuda) must not run."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        plain = getattr(module, name)

        def counted(*args, name=name, plain=plain, **kw):
            calls[name] += 1
            return plain(*args, **kw)

        monkeypatch.setattr(module, name, counted)
    for mod, name in forbidden:
        monkeypatch.setattr(mod, name, None)
    return calls


def test_forward_at_high_matches_jax_bf16_3x(random_pair, monkeypatch):
    """The 'high' tier's forward, its recurrence on kernel A's plain
    version (bf16_3x products), against ``_jax_high_forward``."""
    jp, net, feats = random_pair
    want = _jax_high_forward(jp, feats)
    calls = _counting(monkeypatch, nsnet2_gates_cuda, ("gru_gates_p_reference",),
                      ((nsnet2_cuda, "gru_stack_reference"), (nsnet2_gates_cuda, "gru_gates_f_reference")))
    precision.set_matmul_precision("high")
    with torch.inference_mode():
        got = net(torch.from_numpy(feats))
    assert calls == {"gru_gates_p_reference": 1}
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() - want)
    assert d.max() <= 2e-6 and d.mean() <= 3e-7, (d.max(), d.mean())


def _rb(x):
    """Round to bf16, held in float32 (``reduce_precision``: no XLA pass
    can drop it as excess precision)."""
    return jax.lax.reduce_precision(x.astype(jnp.float32), exponent_bits=8, mantissa_bits=7)


def _jax_io_dense(x, w, b):
    """A product of bf16 operands rounded to bf16, plus the bf16 bias, rounded."""
    return _rb(_rb(_jdot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16))) + _rb(b))


def _jax_io_forward(jp, feats):
    """The bf16-storage tier's forward from JAX pieces that round on the
    CPU: bf16 features, weights, fc_in output and gi1; the per-gate
    projections with the biases folded in float32; the TPU kernel 6 with
    bf16 gi and a bf16 out (interpret mode); the head on bf16 operands with
    each output rounded to bf16."""
    h, g1 = jnsnet2.HIDDEN, jp.gru1
    x = _jax_io_dense(feats, jp.fc_in_w, jp.fc_in_b)
    gi1 = _rb(_jdot(x.astype(jnp.bfloat16), g1.wi.astype(jnp.bfloat16)))
    gi_z = gi1[..., :h] + (g1.bi[:h] + g1.bh[:h])
    gi_r = gi1[..., h : 2 * h] + (g1.bi[h : 2 * h] + g1.bh[h : 2 * h])
    gi_n = gi1[..., 2 * h :] + g1.bi[2 * h :]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jexp, "INTERPRET", True)
        mp.setattr(jexp, "ROW_TILE", 8)
        y = jexp.gru_stack_kernel_f(jp, gi_z, gi_r, gi_n, dtype=jnp.bfloat16, out_dtype=jnp.bfloat16)
    y = jax.nn.relu(_jax_io_dense(y, jp.ff1_w, jp.ff1_b))
    y = jax.nn.relu(_jax_io_dense(y, jp.ff2_w, jp.ff2_b))
    return _rb(jax.nn.sigmoid(_jax_io_dense(y, jp.out_w, jp.out_b)))


def test_forward_with_bf16_storage_matches_jax(random_pair, monkeypatch):
    jp, net, feats = random_pair
    want = np.asarray(_jax_io_forward(jp, jnp.asarray(feats)), np.float64)
    with torch.inference_mode():
        float_gains = net(torch.from_numpy(feats)).numpy()
        precision.set_matmul_precision("default")
        bf16_gains = net(torch.from_numpy(feats)).numpy()
        calls = _counting(monkeypatch, nsnet2_gates_cuda, ("gru_gates_f_reference",),
                          ((nsnet2_cuda, "gru_stack_reference"), (nsnet2_gates_cuda, "gru_gates_p_reference")))
        precision.set_io_dtype("bf16")
        got = net(torch.from_numpy(feats))
    assert calls == {"gru_gates_f_reference": 1}
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert d.max() <= 4e-3 and d.mean() <= 2e-5, (d.max(), d.mean())
    # The storage tier really rounded, unlike the float and bf16 tiers.
    for other in (float_gains, bf16_gains):
        assert np.abs(other - want).mean() > 10 * 2e-5


def test_kernel_6_runs_in_bf16_with_a_bf16_out(random_pair, monkeypatch):
    """bf16 storage hands kernel 6 the per-gate projections of the bf16
    fc_in output in bf16 weights and asks for a bf16 h2."""
    _, net, feats = random_pair
    seen = []
    gru_gates_f = nsnet2_gates_cuda.gru_gates_f

    def spy(net_, gi_z, gi_r, gi_n, dtype=torch.float32, tile=None, out_dtype=None, **kw):
        seen.append((gi_z.dtype, dtype, out_dtype))
        return gru_gates_f(net_, gi_z, gi_r, gi_n, dtype=dtype, tile=tile, out_dtype=out_dtype, **kw)

    monkeypatch.setattr(nsnet2_gates_cuda, "gru_gates_f", spy)
    precision.set_io_dtype("bf16")
    with torch.inference_mode():
        net(torch.from_numpy(feats))
    assert seen == [(torch.float32, torch.bfloat16, torch.bfloat16)]


def _simulate(root, plan: str, *flags: str) -> list:
    """The port's simulator on ``plan`` with ``flags`` and ``--device cpu``;
    -> its instances (segments in ``vad_segments``). The tier is reset."""
    seen = {}
    run_batched = sim.run_batched

    def capture(instances, *args, **kwargs):
        run_batched(instances, *args, **kwargs)
        seen["instances"] = instances

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim, "run_batched", capture)
        try:
            assert sim.main(["-i", str(root / f"plan_{plan}.json"), *flags, "--device", "cpu"]) == 0
            seen["tier"] = (precision.matmul_precision(), precision.io_dtype())
        finally:
            precision.set_matmul_precision("highest")
            precision.set_io_dtype("f32")
    return seen["instances"], seen["tier"]


def _corpus_audio(root) -> np.ndarray:
    audio = []
    for i in range(3):
        src = AudioSource.open_stream(str(root / f"s{i}.wav"))
        audio.append(src.read(src.n_frames))
        src.close()
    return np.stack(audio).astype(np.float32)


@pytest.fixture(scope="module")
def tier_runs(tmp_path_factory):
    """The port's simulator with ``--precision default --device cpu`` on a
    3-stream synthetic corpus (3 x 20 s), and the JAX float tier's
    BatchRunner on the same audio: (JAX results, port instances)."""
    root = tmp_path_factory.mktemp("bf16_tier")
    write_corpus(str(root), 3, 20.0, seed=4, plans={"bf16": {}})
    got, tier = _simulate(root, "bf16", "--precision", "default")
    assert tier == ("default", None)
    want = JBatchRunner(jnsnet2.load_npz(DEMO_WEIGHTS), JVADConfig()).run(_corpus_audio(root))
    return want, got


@pytest.fixture(scope="module")
def storage_runs(tmp_path_factory):
    """The port's simulator with ``--precision default --io-dtype bf16`` and
    with ``--precision high`` on the corpus of ``tier_runs``; the JAX
    package's BatchRunner at its bf16_io tier and at its float tier on the
    same audio: ({tier: JAX results}, {tier: port instances})."""
    root = tmp_path_factory.mktemp("io_tier")
    write_corpus(str(root), 3, 20.0, seed=4, plans={"tiers": {}})
    got = {}
    for name, flags, want_tier in (("bf16_io", ("--precision", "default", "--io-dtype", "bf16"), ("default", torch.bfloat16)),
                                   ("high", ("--precision", "high"), ("high", None))):
        got[name], tier = _simulate(root, "tiers", *flags)
        assert tier == want_tier
    audio = _corpus_audio(root)
    want = {"float": JBatchRunner(jnsnet2.load_npz(DEMO_WEIGHTS), JVADConfig()).run(audio)}
    jprecision.set_matmul_precision("default")
    jprecision.set_io_dtype("bf16")
    try:
        want["bf16_io"] = JBatchRunner(jnsnet2.load_npz(DEMO_WEIGHTS), JVADConfig()).run(audio)
    finally:
        jprecision.set_matmul_precision("highest")
        jprecision.set_io_dtype("f32")
    return want, got


def test_bf16_io_segments_match_the_jax_bf16_io_run(storage_runs):
    want, got = storage_runs
    total = equal = 0
    for w, g in zip(want["bf16_io"], got["bf16_io"]):
        assert len(g.vad_segments) == len(w.segments)
        for a, b in zip(g.vad_segments, w.segments):
            for key in ("sample_from", "sample_to"):
                assert abs(a[key] - b[key]) <= FFT
                equal += a[key] == b[key]
                total += 1
    assert total > 0
    print(f"bf16_io tier vs the JAX bf16_io tier: {equal} of {total} boundaries exactly equal")


def test_high_simulator_boundaries_equal_the_jax_float_tier(storage_runs):
    """XLA:CPU computes 'high' in float32; the port's bf16_3x run keeps
    every boundary of the JAX float tier on this corpus."""
    want, got = storage_runs
    spans = [[(s["sample_from"], s["sample_to"]) for s in g.vad_segments] for g in got["high"]]
    assert spans == [[(s["sample_from"], s["sample_to"]) for s in w.segments] for w in want["float"]]
    assert sum(map(len, spans)) > 0


def test_bf16_tier_segments_match_the_jax_float_tier(tier_runs):
    want, got = tier_runs
    total = equal = 0
    for w, g in zip(want, got):
        assert len(g.vad_segments) == len(w.segments)
        for a, b in zip(g.vad_segments, w.segments):
            for key in ("sample_from", "sample_to"):
                assert abs(a[key] - b[key]) <= FFT
                equal += a[key] == b[key]
                total += 1
    assert total > 0
    print(f"bf16 tier vs JAX float tier: {equal} of {total} boundaries exactly equal")
