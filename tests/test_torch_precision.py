"""The port's matmul-precision tier (``ops/precision.py``) against the JAX
package's: the API contract, the 'default' product, the model forward and
the scoring slice.

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
from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_gates_cuda, registry
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


def _both(fn):
    """Apply ``fn`` to both modules; -> (port result, JAX result as a name)."""
    got, want = fn(precision), fn(jprecision)
    return got, NAMES.get(want, want)


def test_routing_matches_jax():
    for level in ("highest", "default"):
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


def test_bf16_3x_is_not_ported():
    """'high' is accepted by the JAX package and refused here, naming ROADMAP."""
    jprecision.set_matmul_precision("high")
    for call in (lambda: precision.set_matmul_precision("high"), lambda: precision.set_stage_precision("ff", "high"),
                 lambda: precision.set_stage_overrides({"ff": "high"})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    assert precision.matmul_precision("ff") == "highest"


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


def test_env_selects_the_tier(reload_precision):
    assert reload_precision(FVAD_PRECISION="DEFAULT").matmul_precision("band") == "default"
    assert reload_precision(FVAD_PRECISION="highest").matmul_precision() == "highest"
    for env in ({"FVAD_PRECISION": "high"}, {"FVAD_IO_DTYPE": "bf16"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
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

        def counted(*args):
            calls[0] += 1
            return plain(*args)

        monkeypatch.setattr(nsnet2_gates_cuda, "gru_gates_p_reference", counted)
        monkeypatch.setattr(nsnet2_cuda, "gru_stack_reference", None)  # the float recurrence must not run
        got = net(torch.from_numpy(feats)).numpy()
    assert calls[0] == 1
    d = np.abs(got - want)
    assert d.max() <= 2e-3 and d.mean() <= 2e-5, (d.max(), d.mean())
    assert np.abs(float_gains - want).mean() > 10 * d.mean()  # the tier really rounded


def test_mixed_gru_stages_raise():
    net = registry.load_denoiser("demo", device="cpu")
    precision.set_stage_precision("gru_h", "default")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        net(torch.zeros((1, 3, 161)))


@pytest.fixture(scope="module")
def tier_runs(tmp_path_factory):
    """The port's simulator with ``--precision default --device cpu`` on a
    3-stream synthetic corpus (3 x 20 s), and the JAX float tier's
    BatchRunner on the same audio: (JAX results, port instances)."""
    root = tmp_path_factory.mktemp("bf16_tier")
    write_corpus(str(root), 3, 20.0, seed=4, plans={"bf16": {}})
    seen = {}
    run_batched = sim.run_batched

    def capture(instances, *args, **kwargs):
        run_batched(instances, *args, **kwargs)
        seen["instances"] = instances

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim, "run_batched", capture)
        try:
            assert sim.main(["-i", str(root / "plan_bf16.json"), "--precision", "default", "--device", "cpu"]) == 0
            assert precision.matmul_precision() == "default"
        finally:
            precision.set_matmul_precision("highest")
    audio = []
    for i in range(3):
        src = AudioSource.open_stream(str(root / f"s{i}.wav"))
        audio.append(src.read(src.n_frames))
        src.close()
    want = JBatchRunner(jnsnet2.load_npz(DEMO_WEIGHTS), JVADConfig()).run(np.stack(audio).astype(np.float32))
    return want, seen["instances"]


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
