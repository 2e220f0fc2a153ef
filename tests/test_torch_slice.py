"""The batched scoring slice end to end: the port's simulator (``--device
cpu``) against the JAX simulator on a synthetic corpus (2 streams x 20 s of
stereo 48 kHz WAV with Audacity labels and a plan JSON).

report.txt and the Audacity segment files must be byte-identical, and the
segments identical; only each segment's average channel-volume ratio is
held at rtol 1e-6, because the chunk RMS behind it is reduced in another
order than XLA:CPU's (ops/volume.py). Each simulator runs once per module.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from formula_vad_tpu.apps import simulator as jsim
from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.pipeline import offline as joffline
from formula_vad_tpu.pipeline import vad as jvad
from formula_vad_tpu.testing import synth as jsynth
from formula_vad_tpu_torch.apps import simulator as sim
from formula_vad_tpu_torch.config import VADConfig, VADMachineConfig
from formula_vad_tpu_torch.models import registry
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.pipeline import fsm, offline, vad
from formula_vad_tpu_torch.testing import synth

N_STREAMS, SECONDS = 2, 20.0


def _capture_segments(module, mp):
    """Wrap ``module.run_batched`` so the run's instances can be read back."""
    seen = {}
    orig = module.run_batched

    def wrapped(instances, *args, **kwargs):
        orig(instances, *args, **kwargs)
        seen["instances"] = instances

    mp.setattr(module, "run_batched", wrapped)
    return seen


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    synth.write_corpus(str(root), N_STREAMS, SECONDS, seed=0, plans={"jax": {}, "port": {}})
    return root


@pytest.fixture(scope="module")
def runs(corpus):
    """One JAX simulator run and one port run: {pkg: (out_dir, instances)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        seen_jax = _capture_segments(jsim, mp)
        seen_port = _capture_segments(sim, mp)
        assert jsim.main(["-i", str(corpus / "plan_jax.json")]) == 0
        assert sim.main(["-i", str(corpus / "plan_port.json"), "--device", "cpu"]) == 0
    for pkg, seen in (("jax", seen_jax), ("port", seen_port)):
        (run_dir,) = os.listdir(corpus / f"out_{pkg}")
        out[pkg] = (corpus / f"out_{pkg}" / run_dir, seen["instances"])
    return out


@pytest.fixture(scope="module")
def audio(corpus):
    from formula_vad_tpu.io_ import AudioSource

    streams = []
    for i in range(N_STREAMS):
        src = AudioSource.open_stream(str(corpus / f"s{i}.wav"))
        streams.append(src.read(src.n_frames))
        src.close()
    return np.stack(streams).astype(np.float32)


@pytest.mark.parametrize("name", ["report.txt"] + [f"s{i}-audacity.txt" for i in range(N_STREAMS)])
def test_simulator_files_identical(runs, name):
    want = (runs["jax"][0] / name).read_bytes()
    got = (runs["port"][0] / name).read_bytes()
    assert got == want


def test_simulator_segments_identical(runs):
    total = 0
    for jinst, inst in zip(runs["jax"][1], runs["port"][1]):
        assert len(inst.vad_segments) == len(jinst.vad_segments), inst.name
        for got, want in zip(inst.vad_segments, jinst.vad_segments):
            for key in ("sample_from", "sample_to", "vad_met_sec"):
                assert got[key] == want[key], (inst.name, key)
            assert got["avg_channel_vol_ratio"] == pytest.approx(want["avg_channel_vol_ratio"], rel=1e-6)
        total += len(inst.vad_segments)
    assert total > 0


def test_simulator_writes_clips(runs):
    for inst in runs["port"][1]:
        for seg in inst.vad_segments:
            names = {os.path.splitext(n)[0] for n in os.listdir(inst.out_dir)}
            assert {f"{seg['sample_from']}-original", f"{seg['sample_from']}-denoised"} <= names


def test_window_inputs_batch_matches_jax(audio):
    n_valid = np.array([audio.shape[-1] // 24000, audio.shape[-1] // 24000 - 3], np.int32)
    t = (audio.shape[-1] // 24000) * 24000
    jst = jvad.statics_from_config(JVADConfig())
    want = joffline.window_inputs_batch(
        jnsnet2.load_npz(DEMO_WEIGHTS), jst, jnp.asarray(audio[..., :t]), jnp.asarray(n_valid)
    )
    st = vad.statics_from_config(VADConfig())
    with torch.inference_mode():
        got = offline.window_inputs_batch(
            registry.load_denoiser("demo", device="cpu"), st, torch.from_numpy(audio[..., :t]), torch.from_numpy(n_valid)
        )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-7)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    with torch.inference_mode():
        one = offline.window_inputs(registry.load_denoiser("demo", device="cpu"), st, torch.from_numpy(audio[1, :, :t]), int(n_valid[1]))
    for a, b in zip(one, got):
        assert torch.equal(a, b[1]), "one stream alone must equal its row of the batch"


def test_device_fsm_equals_host_decoder(audio):
    net = registry.load_denoiser("demo", device="cpu")
    lengths = [audio.shape[-1], audio.shape[-1] - 70_000]
    device_fsm = BatchRunner(net).run(audio, lengths)
    host_fsm = BatchRunner(net, use_host_fsm=True).run(audio, lengths)
    assert [r.segments for r in device_fsm] == [r.segments for r in host_fsm]


def test_unported_paths_raise(corpus, monkeypatch, tmp_path):
    net = registry.load_denoiser("demo", device="cpu")
    # Alternative machines are ported: the base config's is the primary
    # machine, and a streaming plan with them runs (one 4 s stream).
    runner = BatchRunner(net, VADConfig(alt_vad_machine_configs=[VADMachineConfig()]))
    assert runner.alt_configs == (VADMachineConfig(),) and fsm.n_machines(runner.machines) == 2
    synth.write_corpus(str(tmp_path), 1, 4.0, seed=0, plans={
        "streaming": {"batch_streams": False, "vad_config": {"alt_vad_machine_configs": [{}]}}})
    assert sim.main(["-i", str(tmp_path / "plan_streaming.json"), "--device", "cpu"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.main(["-i", str(corpus / "plan_port.json")])


def test_denoise_carry_chaining_and_span(audio):
    """Chaining slabs through the carry equals one whole-stream run, and
    ``denoise_span`` (the clips' re-denoise) equals the same chunks of it."""
    net = registry.load_denoiser("demo", device="cpu")
    x = torch.from_numpy(audio[:1, :, : 6 * 24000])
    with torch.inference_mode():
        whole = offline.denoise_offline(net, x)
        carry = offline.init_slab_carry(x.shape[:-1], 3)
        first, carry = offline.denoise_offline_carry(net, x[..., : 2 * 24000], carry)
        second, _ = offline.denoise_offline_carry(net, x[..., 2 * 24000 :], carry)
        span = offline.denoise_span(net, x, 3, 5)
    np.testing.assert_allclose(torch.cat([first, second], -1).numpy(), whole.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(span.numpy(), whole[..., 3 * 24000 : 5 * 24000].numpy(), rtol=0, atol=1e-6)


def test_port_synth_equals_reference():
    """The port's stream generator draws like the JAX package's: one seed,
    the same audio and labels, bit for bit."""
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for seconds in (20.0, 31.5):
        got, got_labels = synth.synth_stream(rng_a, seconds)
        want, want_labels = jsynth.synth_stream(rng_b, seconds)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert got_labels == want_labels and got_labels
