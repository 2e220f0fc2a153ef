"""The port's slab runner (``parallel/slab_runner.py``) on the CPU, where
every kernel wrapper runs its plain version: against the port's one-shot
``BatchRunner`` and against the JAX package's ``SlabRunner``, on the
packaged demo weights (mirrors tests/test_slab_runner.py,
tests/test_fsm_host.py and tests/test_parity_fuzz.py's slab cases).

Bars: segments identical to the port's one-shot run, and to the JAX slab
run but for each segment's average channel-volume ratio, held at rtol 1e-6
(the chunk RMS behind it is reduced in another order than XLA:CPU's; ROADMAP
§3 fault 1).
"""

import json
import os

import numpy as np
import pytest
import torch

from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.config import VADMachineConfig as JVADMachineConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.parallel.slab_runner import SlabRunner as JSlabRunner
from formula_vad_tpu_torch.apps import simulator as sim
from formula_vad_tpu_torch.config import VADConfig, VADMachineConfig
from formula_vad_tpu_torch.models import registry
from formula_vad_tpu_torch.ops import precision
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.parallel.slab_runner import SLAB_ALIGN_CHUNKS, SlabRunner
from formula_vad_tpu_torch.pipeline import fsm, fsm_cuda, offline
from formula_vad_tpu_torch.testing import synth

CHUNK = 24000
CFG = dict(long_term_speech_avg_sec=10.0)
VC = VADConfig(vad_machine_config=VADMachineConfig(**CFG))


@pytest.fixture(scope="module")
def net():
    return registry.load_denoiser("demo", device="cpu")


def speechy(n_chunks, bursts, seed):
    """Stereo noise with two-tone speech bursts at (start_sec, dur_sec)."""
    rng = np.random.default_rng(seed)
    t_total = n_chunks * CHUNK
    t = np.arange(t_total) / 48000.0
    base = 0.003 * rng.standard_normal((2, t_total))
    env = np.zeros(t_total)
    for a, d in bursts:
        env[int(a * 48000) : int((a + d) * 48000)] = 1.0
    s = (0.25 * np.sin(2 * np.pi * 700 * t) + 0.15 * np.sin(2 * np.pi * 1300 * t)) * env
    return (base + np.stack([s, 0.9 * s])).astype(np.float32)


def batch_of(streams, lengths=None):
    lengths = lengths or [s.shape[1] for s in streams]
    batch = np.zeros((len(streams), 2, max(s.shape[1] for s in streams)), np.float32)
    for i, s in enumerate(streams):
        batch[i, :, : lengths[i]] = s[:, : lengths[i]]
    return batch, lengths


@pytest.fixture(scope="module")
def ragged():
    """2 ragged streams of 55 and 40 chunks, bursts across 16 s slab edges."""
    return batch_of([
        speechy(55, [(3.0, 2.0), (15.0, 2.5), (22.0, 2.5), (31.0, 2.0)], seed=1),
        speechy(40, [(1.0, 1.2), (10.0, 2.0)], seed=2),
    ])


def assert_same_as_jax(got, want):
    """Identical segments but for the ratio, held at rtol 1e-6."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g.segments) == len(w.segments)
        for a, b in zip(g.segments, w.segments):
            for key in ("sample_from", "sample_to", "vad_met_sec"):
                assert a[key] == b[key], key
            assert a["avg_channel_vol_ratio"] == pytest.approx(b["avg_channel_vol_ratio"], rel=1e-6)


def jax_slab(batch, lengths, slab_chunks, vc=JVADConfig(vad_machine_config=JVADMachineConfig(**CFG))):
    runner = JSlabRunner(jnsnet2.load_npz(DEMO_WEIGHTS), vc, slab_chunks=slab_chunks, use_mesh=False, use_host_fsm=True)
    return runner.run(batch, lengths)


def test_matches_one_shot_and_jax(net, ragged):
    """2 ragged streams, 32-chunk slabs: the port's one-shot segments, and the JAX slab runner's."""
    batch, lengths = ragged
    want = BatchRunner(net, VC).run(batch, lengths)
    got = SlabRunner(net, VC, slab_chunks=32).run(batch, lengths)
    assert [r.segments for r in got] == [r.segments for r in want]
    assert all(r.segments for r in got), "each stream must produce segments"
    assert_same_as_jax(got, jax_slab(batch, lengths, 32))


def test_reader_interface(net):
    """run_readers (streaming from a callable) == run (arrays)."""
    audio = speechy(40, [(2.0, 2.0), (11.0, 3.0)], seed=3)
    a = SlabRunner(net, VC, slab_chunks=32).run(audio[None], [audio.shape[1]])
    b = SlabRunner(net, VC, slab_chunks=32).run_readers([lambda s, n: audio[:, s : s + n]], [audio.shape[1]])
    assert a[0].segments == b[0].segments
    assert a[0].segments, "test audio must produce segments"


def test_raw16_matches_f32(net):
    """Raw int16 slabs dequantised by the runner equal the host's PCM16
    decode: the same segments, boundary for boundary."""
    audio = speechy(40, [(2.0, 2.0), (11.0, 3.0)], seed=3)
    q = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    dec = q.astype(np.float32) / 32768.0  # what the host decoder yields
    a = SlabRunner(net, VC, slab_chunks=32).run_readers([lambda s, n: dec[:, s : s + n]], [audio.shape[1]])
    b = SlabRunner(net, VC, slab_chunks=32).run_readers([lambda s, n: q[:, s : s + n]], [audio.shape[1]], raw16=True)
    assert a[0].segments == b[0].segments
    assert a[0].segments, "test audio must produce segments"


def test_host_fsm_matches_device_fsm(net):
    """3 streams over two whole slabs and 5 chunks: the host decoder's
    chained carry and the FSM's give the same segments."""
    n = 2 * SLAB_ALIGN_CHUNKS + 5
    streams = [speechy(n, [(2.0 + i, 2.0), (15.0, 2.5), (23.0 + i, 3.0)], seed=10 + i) for i in range(3)]
    batch, lengths = batch_of(streams, [n * CHUNK, n * CHUNK - 70_000, (n - 30) * CHUNK])
    host = SlabRunner(net, VC, slab_chunks=SLAB_ALIGN_CHUNKS, use_host_fsm=True).run(batch, lengths)
    dev = SlabRunner(net, VC, slab_chunks=SLAB_ALIGN_CHUNKS).run(batch, lengths)
    assert [r.segments for r in host] == [r.segments for r in dev]
    assert sum(len(r.segments) for r in dev) >= 3


def test_off_boundary_lengths(net):
    """6 streams, every length off the slab boundary (sub-chunk tails
    included): the one-shot run's segments, and the JAX slab runner's."""
    k = SLAB_ALIGN_CHUNKS
    lengths = [k * CHUNK - 1, k * CHUNK + 1, (k + 3) * CHUNK + 12345, (2 * k - 1) * CHUNK, CHUNK + 7, 3 * CHUNK]
    streams = [speechy(-(-n // CHUNK), [(1.0, 1.5), (8.0, 2.5), (17.0, 2.0)], seed=20 + i) for i, n in enumerate(lengths)]
    batch, lengths = batch_of(streams, lengths)
    got = SlabRunner(net, VC, slab_chunks=k).run(batch, lengths)
    want = BatchRunner(net, VC).run(batch, lengths)
    assert [r.segments for r in got] == [r.segments for r in want]
    assert sum(len(r.segments) for r in got) >= 4
    assert_same_as_jax(got, jax_slab(batch, lengths, k))


def test_empty_and_refused(net):
    res = SlabRunner(net).run(np.zeros((2, 2, CHUNK - 1), np.float32))
    assert [r.segments for r in res] == [[], []]
    with pytest.raises(ValueError, match="multiple of 32"):
        SlabRunner(net, slab_chunks=48)
    # Alternative machines are ported: empty input gives each an empty list.
    res = SlabRunner(net, VADConfig(alt_vad_machine_configs=[VADMachineConfig()])).run(np.zeros((2, 2, CHUNK - 1), np.float32))
    assert [(r.segments, r.alt_segments) for r in res] == [([], [[]])] * 2


def test_denoiser_carry_holds_no_view_of_the_slab(net):
    """The carry keeps copies of the slab's tails, so the slab's audio,
    features and OLA are freed with the slab."""
    audio = torch.from_numpy(speechy(4, [(0.5, 1.0)], seed=4)[None])
    carry = offline.init_slab_carry((1, 2))
    with torch.inference_mode():
        _, _, new = offline.denoise_offline_16k(net, audio, carry)
    for name, x in new.items():
        assert x._base is None, name
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size(), name


@pytest.mark.parametrize("tier", [("high", "f32"), ("default", "bf16")], ids=["high", "bf16_io"])
def test_slab_runner_under_the_storage_and_bf16_3x_tiers(net, ragged, tier):
    """The slab runner under 'high' and under bf16 storage: every slab's
    denoiser carry stays float32 (a copy, not a view), and the segments keep
    the one-shot runner's count under the same tier, every boundary within
    one FSM window (identical under 'high')."""
    batch, lengths = ragged
    precision.set_matmul_precision(tier[0])
    precision.set_io_dtype(tier[1])
    try:
        runner = SlabRunner(net, VC, slab_chunks=32)
        carries = []
        front_end = runner._front_end

        def capture(*args):
            out = front_end(*args)
            carries.append(out[0])
            return out

        runner._front_end = capture
        got = runner.run(batch, lengths)
        want = BatchRunner(net, VC).run(batch, lengths)
    finally:
        precision.set_matmul_precision("highest")
        precision.set_io_dtype("f32")
    assert len(carries) == 2
    for carry in carries:
        for name, x in carry.items():
            assert x.dtype == torch.float32 and x._base is None, name
    assert sum(len(r.segments) for r in got) > 0
    for g, w in zip(got, want):
        assert len(g.segments) == len(w.segments)
        for a, b in zip(g.segments, w.segments):
            for key in ("sample_from", "sample_to"):
                assert abs(a[key] - b[key]) <= (0 if tier[0] == "high" else 1024), key


def test_window_chunk_indices_are_made_once(net):
    """The slab loop's window-to-chunk indices are built once per shape and device."""
    first = offline._window_chunks(128, 3000, CHUNK, 1024, torch.device("cpu"))
    assert offline._window_chunks(128, 3000, CHUNK, 1024, torch.device("cpu")) is first


def test_plain_scan_checks_an_outside_carry():
    """The plain version refuses a carry with a ring index out of range or
    a wrong shape, through either entry point: only the card's chained
    calls within the slab loop skip the index read-back."""
    shape, params = fsm.statics_from_config(VADMachineConfig(), 48000, 1024)
    args = [torch.from_numpy(x) for x in synth.fsm_inputs(2, 40, seed=4)]
    _, carry = fsm_cuda.scan_windows(shape, params, *args)
    wb = torch.full((2,), 40, dtype=torch.int32)
    for col, bad in ((fsm.I_LONG_IDX, -1), (fsm.I_SHORT_IDX, shape.short_window), (fsm.I_RATIO_IDX, -5)):
        broken = dict(carry, ireg=carry["ireg"].clone())
        broken["ireg"][1, col] = bad
        for entry in (fsm_cuda.scan_windows_reference, fsm_cuda.scan_windows, fsm_cuda._scan_chained):
            with pytest.raises(ValueError, match="ring index"):
                entry(shape, params, *args, broken, wb)
    short = dict(carry, long_buf=carry["long_buf"][:, 1:])
    with pytest.raises(ValueError, match="shape"):
        fsm_cuda._scan_chained(shape, params, *args, short, wb)
    # The carry it returned itself continues the machines.
    got, _ = fsm_cuda._scan_chained(shape, params, *args, carry, wb)
    want, _ = fsm_cuda.scan_windows_reference(shape, params, *args, carry, wb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_simulator_slab_plans_equal_one_shot(tmp_path):
    """The simulator on a PCM16 corpus: a use_slabs plan (raw int16
    readers) and a one-shot plan write identical report.txt and Audacity
    files; a plan above SLAB_AUTO_BYTES takes the slab runner on its own."""
    synth.write_corpus(str(tmp_path), 2, 20.0, seed=5, fmt="pcm16",
                       plans={"slab": {"use_slabs": True, "slab_chunks": 32}, "one": {}, "auto": {}})
    for name in ("slab", "one"):
        assert sim.main(["-i", str(tmp_path / f"plan_{name}.json"), "--device", "cpu"]) == 0
    runs = {name: tmp_path / f"out_{name}" / os.listdir(tmp_path / f"out_{name}")[0] for name in ("slab", "one")}
    for name in ["report.txt", "s0-audacity.txt", "s1-audacity.txt"]:
        assert (runs["slab"] / name).read_bytes() == (runs["one"] / name).read_bytes(), name
    assert any(not line.endswith("missed") for line in (runs["slab"] / "s0-audacity.txt").read_text().splitlines())
    used = []
    orig = sim.SlabRunner.run_readers

    def spy(self, readers, lengths, raw16=False):
        used.append(raw16)
        return orig(self, readers, lengths, raw16)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim, "SLAB_AUTO_BYTES", 1 << 20)
        mp.setattr(sim.SlabRunner, "run_readers", spy)
        assert sim.main(["-i", str(tmp_path / "plan_auto.json"), "--device", "cpu"]) == 0
    assert used == [True]
    run = tmp_path / "out_auto" / os.listdir(tmp_path / "out_auto")[0]
    assert (run / "report.txt").read_bytes() == (runs["one"] / "report.txt").read_bytes()
    assert json.loads((run / "plan.json").read_text())["config"] == {"output_dir": "out_auto"}
