"""The spectral gate (``models/spectral_gate.py``) against the JAX package's
``SpectralGateParams``, and on every runner the JAX package runs it on.

Gains: max |d| <= 1e-6 against ``apply_gains`` on the same features, in
the float tier (float32 features; ``10 ** x`` differs by an ulp between
torch and XLA:CPU now and then) and in the bf16_io tier (bf16 features).
Segments: identical to the JAX package's (but for each segment's
channel-volume ratio, held at rtol 1e-6, ROADMAP §3 fault 1): the offline
``BatchRunner`` in both tiers, the slab runner and the simulator's batched
plan against the JAX ``BatchRunner``, ``OnlineBatchServer`` against the JAX
server; and among the port's own runners (offline, streaming, the slab
runner, the simulator) bit for bit. The low-latency mode refuses
the gate, as the JAX mode runs NSNet2 only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import CHUNK, MACHINE, _cfg, speechy

from formula_vad_tpu.config import PipelineConfig as JPipelineConfig
from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.config import VADMachineConfig as JVADMachineConfig
from formula_vad_tpu.models import registry as jregistry
from formula_vad_tpu.models.spectral_gate import SpectralGateParams
from formula_vad_tpu.ops import precision as jprecision
from formula_vad_tpu.parallel.online import OnlineBatchServer as JOnlineBatchServer
from formula_vad_tpu.parallel.runner import BatchRunner as JBatchRunner
from formula_vad_tpu_torch.apps import simulator as sim
from formula_vad_tpu_torch.config import VADConfig
from formula_vad_tpu_torch.device import model_device
from formula_vad_tpu_torch.models import registry
from formula_vad_tpu_torch.models.spectral_gate import SpectralGate
from formula_vad_tpu_torch.ops import precision
from formula_vad_tpu_torch.parallel.online import OnlineBatchServer
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.parallel.slab_runner import SlabRunner
from formula_vad_tpu_torch.pipeline import lowlatency
from formula_vad_tpu_torch.testing import synth

GAIN_TOL = 1e-6
RATIO_RTOL = 1e-6
TIERS = {"float": ("highest", "f32"), "bf16_io": ("default", "bf16")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops, for which torch's intra-op threads only add
    overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tier(request):
    """Both packages at one tier (matmul level, io dtype), restored after."""
    level, io = TIERS[request.param]
    for module in (precision, jprecision):
        module.set_matmul_precision(level)
        module.set_io_dtype(io)
    yield request.param
    for module in (precision, jprecision):
        module.set_matmul_precision("highest")
        module.set_io_dtype("f32")


@pytest.fixture(scope="module")
def gate():
    return registry.load_denoiser("spectral_gate", device="cpu")


@pytest.fixture(scope="module")
def audio():
    """2 synthetic streams x 20 s (the slice's generator)."""
    rng = np.random.default_rng(3)
    return np.stack([synth.synth_stream(rng, 20.0)[0] for _ in range(2)])


@pytest.fixture(scope="module")
def jax_segments(audio):
    """The JAX BatchRunner's segments with the gate in the float tier: for
    the slice's two streams (``LENGTHS``), and for the first stream alone
    (the simulator's corpus)."""
    runner = JBatchRunner(SpectralGateParams(), JVADConfig(), use_mesh=False)
    return ([r.segments for r in runner.run(audio, _lengths(audio))],
            [r.segments for r in runner.run(audio[:1])])


def _lengths(audio):
    return [audio.shape[-1], audio.shape[-1] - 100_000]


def _same_segments(got, want):
    """Per stream: boundaries and met time identical, ratio at rtol 1e-6."""
    n = 0
    assert len(got) == len(want)
    for g_stream, w_stream in zip(got, want):
        assert len(g_stream) == len(w_stream)
        for g, w in zip(g_stream, w_stream):
            assert {k: g[k] for k in ("sample_from", "sample_to", "vad_met_sec")} == {
                k: w[k] for k in ("sample_from", "sample_to", "vad_met_sec")}
            assert g["avg_channel_vol_ratio"] == pytest.approx(w["avg_channel_vol_ratio"], rel=RATIO_RTOL)
            n += 1
    return n


@pytest.mark.parametrize("tier", list(TIERS), indirect=True)
@pytest.mark.parametrize("spec", ["spectral_gate", "spectral_gate:0.3,2.0,0.05"])
def test_gains_match_the_jax_gate(tier, spec):
    feats = np.random.default_rng(0).normal(-5.0, 1.5, (6, 54, 161)).astype(np.float32)
    x = torch.from_numpy(feats)
    jx = jnp.asarray(feats)
    if tier == "bf16_io":
        x, jx = x.bfloat16(), jx.astype(jnp.bfloat16)
    net = registry.load_denoiser(spec, device="cpu")
    want = np.asarray(jregistry.load_denoiser(spec).apply_gains(jx))
    with torch.inference_mode():
        got = net(x)
        tail = net(x, out_frames=50)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GAIN_TOL)
    assert torch.equal(tail, got[:, 4:])
    assert float(got.min()) >= net.floor and float(got.max()) <= 1.0


def test_gate_specs_match_the_jax_registry():
    for spec in ("spectral_gate", "spectral_gate:0.2,2.0,0.05"):
        net, want = registry.load_denoiser(spec, device="cpu"), jregistry.load_denoiser(spec)
        assert isinstance(net, SpectralGate) and isinstance(want, SpectralGateParams)
        assert (net.quantile, net.alpha, net.floor) == (want.quantile, want.alpha, want.floor)
        assert model_device(net) == torch.device("cpu") and not list(net.parameters())
    for bad in ("spectral_gate:0.1", "spectral_gate:0.1,x,0.2", "spectral_gate:", "spectral_gate:1,2,3,4"):
        with pytest.raises(ValueError, match="malformed denoiser spec"):
            registry.load_denoiser(bad, device="cpu")
    with pytest.raises(ValueError, match="unsupported NSNet2 weight format"):
        registry.load_denoiser("spectral_gates", device="cpu")


@pytest.mark.parametrize("tier", list(TIERS), indirect=True)
def test_batch_runner_matches_the_jax_runner(tier, gate, audio):
    """Offline and streaming, in each tier, against the JAX BatchRunner on
    the same gate and audio; the streaming run bit for bit with offline."""
    lengths = _lengths(audio)
    want = JBatchRunner(SpectralGateParams(), JVADConfig(), use_mesh=False).run(audio, lengths)
    offline = BatchRunner(gate, VADConfig()).run(audio, lengths)
    stream = BatchRunner(gate, VADConfig(), use_offline=False).run(audio, lengths)
    assert _same_segments([r.segments for r in offline], [r.segments for r in want]) > 0
    assert [r.segments for r in stream] == [r.segments for r in offline]


def test_slab_runner_equals_the_one_shot_runner(gate, audio, jax_segments):
    """The slab runner's segments against the JAX BatchRunner's, and bit for
    bit with the port's one-shot runner on its host FSM."""
    lengths = _lengths(audio)
    got = [r.segments for r in SlabRunner(gate, VADConfig(), slab_chunks=32).run(audio, lengths)]
    assert _same_segments(got, jax_segments[0]) > 0
    one_shot = BatchRunner(gate, VADConfig(), use_host_fsm=True).run(audio, lengths)
    assert got == [r.segments for r in one_shot]


def test_online_server_matches_the_jax_server(gate):
    """2 streams over 8 ticks (the serving tests' bursts and machine): the
    port's fleet and the JAX fleet, each with the gate, give the same
    segments."""
    streams = [speechy(8, bursts, seed=40 + i).astype(np.float32) / np.float32(32768.0)
               for i, bursts in enumerate(([(0.3, 1.0)], [(0.5, 1.0), (2.5, 1.0)]))]
    jcfg = JPipelineConfig(vad_config=JVADConfig(vad_machine_config=JVADMachineConfig(**MACHINE)))
    servers = (OnlineBatchServer(_cfg(), 2, params=gate, device="cpu"),
               JOnlineBatchServer(jcfg, 2, params=SpectralGateParams(), use_shared_fill=False))
    for k in range(8):
        chunks = np.stack([s[:, k * CHUNK : (k + 1) * CHUNK] for s in streams])
        for server in servers:
            server.push(chunks)
    got, want = (s.segments for s in servers)
    assert _same_segments(got, want) > 0
    assert servers[0].tick_stats()["ticks"] == 8


def test_simulator_plans_with_the_gate(gate, audio, jax_segments, tmp_path, monkeypatch):
    """The simulator's batched and streaming plans naming the gate score
    the JAX BatchRunner's segments (and the port's BatchRunner's, bit for
    bit) and write each segment's clips (re-denoised on the gate's device)."""
    synth.write_corpus(str(tmp_path), 1, 20.0, seed=3, plans={
        "batched": {"vad_config": {"denoiser_model_path": "spectral_gate"}},
        "streaming": {"batch_streams": False, "vad_config": {"denoiser_model_path": "spectral_gate"}}})
    seen = {}
    orig = sim.run_batched

    def run_batched(instances, *args, **kwargs):
        orig(instances, *args, **kwargs)
        seen["batched"] = [inst.vad_segments for inst in instances]

    monkeypatch.setattr(sim, "run_batched", run_batched)
    for plan in ("batched", "streaming"):
        assert sim.main(["-i", str(tmp_path / f"plan_{plan}.json"), "--device", "cpu"]) == 0
    assert _same_segments(seen["batched"], jax_segments[1]) > 0
    (want,) = BatchRunner(gate, VADConfig()).run(audio[:1])
    assert seen["batched"] == [want.segments]
    reports = [next((tmp_path / f"out_{plan}").iterdir()) for plan in ("batched", "streaming")]
    assert (reports[0] / "report.txt").read_text() == (reports[1] / "report.txt").read_text()
    names = {p.name.split(".")[0] for p in reports[0].rglob("*-denoised.*")}
    assert {f"{seg['sample_from']}-denoised" for seg in want.segments} <= names


def test_lowlatency_refuses_the_gate(gate):
    with pytest.raises(ValueError, match="SpectralGate"):
        lowlatency.run(gate, torch.zeros((1, 2, 960)))
    state = lowlatency.init_state((1, 2), device="cpu")
    with pytest.raises(ValueError, match="SpectralGate"):
        lowlatency.step(gate, state, torch.zeros((1, 2, 480)))
