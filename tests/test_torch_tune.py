"""K machines a stream (``alt_vad_machine_configs``) and the threshold tuner
(``apps/tune.py``) against the JAX package, on the same inputs.

The port runs the primary machine and the K alternatives as (stream,
config) rows of one FSM scan behind one front end, where the JAX
``BatchRunner`` runs the front end again for them: their segments must be
the same on every path (offline, streaming, host FSM, the slab runner over
two slabs, ``AudioPipeline`` across a checkpoint), and the alternative
equal to the base config is the primary machine bit for bit. Segments are
compared as the port's other tests do: identical but for each one's
channel-volume ratio, held at rtol 1e-6 against the JAX package (ROADMAP
§3 fault 1) and bit for bit between the port's own paths. The tuner's
leaderboard text and ``--out`` file are the JAX tool's byte for byte.
The JAX runner's offline run is the reference of every path (its streaming
run gives the same segments, tests/test_apps.py).
"""

import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from formula_vad_tpu.apps import simulator as jsimulator
from formula_vad_tpu.apps import tune as jtune
from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.config import VADMachineConfig as JVADMachineConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.parallel.runner import BatchRunner as JBatchRunner
from formula_vad_tpu_torch.apps import tune
from formula_vad_tpu_torch.config import PipelineConfig, VADConfig, VADMachineConfig
from formula_vad_tpu_torch.models import registry
from formula_vad_tpu_torch.parallel.online import OnlineBatchServer
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.parallel.slab_runner import SLAB_ALIGN_CHUNKS, SlabRunner
from formula_vad_tpu_torch.pipeline import fsm, fsm_cuda, fsm_host, offline, vad
from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline
from formula_vad_tpu_torch.testing import synth

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
import make_synthetic_corpus  # noqa: E402

CHUNK = 24000
RATIO_RTOL = 1e-6
BASE = dict(long_term_speech_avg_sec=10.0, max_speech_gap_sec=0.4)
# K = 4 dynamic-only configs, the base (0.7, 0.4) first.
GRID = [dict(min_vad_duration_sec=a, max_speech_gap_sec=b) for a in (0.7, 1.3) for b in (0.4, 1.0)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops, for which torch's intra-op threads only add
    overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def host_fsm_on_cpu(monkeypatch):
    """The native host decoder in place of the FSM's plain version on the
    CPU: bit for bit the same (tests/test_torch_fsm.py), and a tenth of its
    time, which keeps this file inside its budget. The plain version runs
    the K machines' rows in the offline, streaming and one-scan tests."""

    def host(shape, params, mv, vr, va, carry=None, win_base=None):
        np_carry = None if carry is None else {k: v.numpy() for k, v in carry.items()}
        out, new = fsm_host.scan_windows_host(shape, params, mv.numpy(), vr.numpy(), va.numpy(), np_carry,
                                              None if win_base is None else win_base.numpy())
        return type(out)(*map(torch.from_numpy, out)), {k: torch.from_numpy(v) for k, v in new.items()}

    monkeypatch.setattr(fsm_cuda, "scan_windows_reference", host)


def _config(vad_cls, machine_cls):
    return vad_cls(vad_machine_config=machine_cls(**BASE),
                   alt_vad_machine_configs=[machine_cls(**{**BASE, **g}) for g in GRID])


def speechy(n_chunks, bursts, seed):
    """Stereo noise with two-tone speech bursts at (start_sec, dur_sec)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_chunks * CHUNK) / 48000.0
    env = np.zeros(t.shape)
    for a, d in bursts:
        env[int(a * 48000) : int((a + d) * 48000)] = 1.0
    s = (0.25 * np.sin(2 * np.pi * 700 * t) + 0.15 * np.sin(2 * np.pi * 1300 * t)) * env
    return (0.003 * rng.standard_normal((2, t.size)) + np.stack([s, 0.9 * s])).astype(np.float32)


@pytest.fixture(scope="module")
def net():
    return registry.load_denoiser("demo", device="cpu")


@pytest.fixture(scope="module")
def streams():
    """2 streams x 6 s, the second ragged."""
    audio = np.stack([speechy(12, [(0.4, 1.5), (2.6, 0.5), (3.4, 1.0)], 1), speechy(12, [(0.3, 1.2), (3.0, 0.9)], 2)])
    return audio, [audio.shape[-1], audio.shape[-1] - 30_000]


@pytest.fixture(scope="module")
def jax_results(streams):
    """The JAX BatchRunner's results (offline)."""
    audio, lengths = streams
    return JBatchRunner(jnsnet2.load_npz(DEMO_WEIGHTS), _config(JVADConfig, JVADMachineConfig), use_mesh=False).run(
        audio, lengths)


def _same_as_jax(got: list[dict], want: list[dict]) -> None:
    assert [{k: v for k, v in s.items() if k != "avg_channel_vol_ratio"} for s in got] == [
        {k: v for k, v in s.items() if k != "avg_channel_vol_ratio"} for s in want]
    np.testing.assert_allclose([s["avg_channel_vol_ratio"] for s in got],
                               [s["avg_channel_vol_ratio"] for s in want], rtol=RATIO_RTOL, atol=0)


def _check_results(got, want) -> None:
    """Per stream: every config's segments as the JAX runner's, the base
    alternative the primary bit for bit, and the configs telling apart."""
    for g, w in zip(got, want):
        assert len(g.alt_segments) == len(w.alt_segments) == len(GRID)
        _same_as_jax(g.segments, w.segments)
        for a, b in zip(g.alt_segments, w.alt_segments):
            _same_as_jax(a, b)
        assert g.alt_segments[0] == g.segments
    assert len({json.dumps(segs) for r in got for segs in r.alt_segments}) > 2


@pytest.mark.parametrize("path", ["offline", "streaming", "host_fsm"])
def test_alt_segments_match_the_jax_runner(net, streams, jax_results, path):
    audio, lengths = streams
    kw = {"offline": {}, "streaming": {"use_offline": False}, "host_fsm": {"use_host_fsm": True}}[path]
    got = BatchRunner(net, _config(VADConfig, VADMachineConfig), **kw).run(audio, lengths)
    _check_results(got, jax_results)
    # Without alternatives the primary machine's segments are the same.
    alone = BatchRunner(net, VADConfig(vad_machine_config=VADMachineConfig(**BASE)), **kw).run(audio, lengths)
    assert [r.segments for r in alone] == [r.segments for r in got] and all(r.alt_segments == [] for r in alone)


def test_k_machines_are_rows_of_one_scan(net, streams, monkeypatch):
    """One front end and one FSM scan at [B * K, W], stream-major; a chunk
    step's windows come back [..., K, max_windows]."""
    audio, _ = streams
    cfg = _config(VADConfig, VADMachineConfig)
    st = vad.statics_from_config(cfg)
    stacked = vad.stack_machine_params(st, cfg.alt_vad_machine_configs)
    assert fsm.n_machines(stacked) == len(GRID) and stacked.max_gap_samples.dtype == np.int32
    rows = fsm.tile_rows(stacked, 2)
    assert rows.max_gap_samples.tolist() == stacked.max_gap_samples.tolist() * 2
    shapes = []
    plain = fsm_cuda.scan_windows_reference

    def counted(shape, params, mv, *args, **kw):
        shapes.append(tuple(mv.shape))
        return plain(shape, params, mv, *args, **kw)

    monkeypatch.setattr(fsm_cuda, "scan_windows_reference", counted)
    x = torch.from_numpy(audio)
    with torch.inference_mode():
        win_out, valid = offline.process_batch_offline(net, st, x, fsm_params=stacked)
        one, _ = offline.process_batch_offline(net, st, x[1:], fsm_params=stacked)
        _, out = vad.chunk_step(net, st, vad.init_carry(st, (2,)), x[..., :CHUNK], fsm_params=stacked)
    w = valid.shape[1]
    assert shapes == [(2 * len(GRID), w), (len(GRID), w), (2 * len(GRID), st.max_windows)]
    assert win_out.event.shape == (2, len(GRID), w) and out.windows.event.shape == (2, len(GRID), st.max_windows)
    for a, b in zip(one, win_out):  # a stream's rows do not depend on the others
        assert torch.equal(a[0], b[1])


def test_slab_runner_alt_rows_over_two_slabs(net, host_fsm_on_cpu):
    """Two slabs of 16 s, a burst across the edge: the alternative machines'
    carry chained over the slabs, on the card's path and in the host
    decoder, gives every machine the JAX BatchRunner's segments on the same
    audio; the two FSM backends agree bit for bit."""
    k = SLAB_ALIGN_CHUNKS
    audio = np.stack([speechy(k + 2, [(2.0, 1.5), (4.5, 1.0), (6.0, 0.8), (15.4, 1.2)], 3),
                      speechy(k + 2, [(1.0, 1.0), (4.0, 0.6), (5.0, 1.2)], 4)])
    lengths = [audio.shape[-1], 20 * CHUNK + 7]
    want = JBatchRunner(jnsnet2.load_npz(DEMO_WEIGHTS), _config(JVADConfig, JVADMachineConfig), use_mesh=False).run(
        audio, lengths)
    cfg = _config(VADConfig, VADMachineConfig)
    device, host = (SlabRunner(net, cfg, slab_chunks=k, use_host_fsm=h).run(audio, lengths) for h in (False, True))
    assert [(r.segments, r.alt_segments) for r in host] == [(r.segments, r.alt_segments) for r in device]
    _check_results(device, want)


def test_audio_pipeline_alt_segments_across_a_checkpoint(net, streams, jax_results, tmp_path, host_fsm_on_cpu):
    """The pipeline's alternative machines (segments only) as the JAX
    runner's streaming ones; saved after 3 s, loaded into a new pipeline
    and continued, the alternative carry resumes exactly."""
    audio, _ = streams
    config = PipelineConfig(vad_config=_config(VADConfig, VADMachineConfig))
    whole = AudioPipeline(config, net)
    whole.push_samples(audio[0])
    for got, want in zip(whole.alt_segments, jax_results[0].alt_segments):
        _same_as_jax(got, want)
    assert whole.alt_segments[0] == whole.segments
    first = AudioPipeline(config, net)
    first.push_samples(audio[0, :, : 6 * CHUNK])
    first.save_state(str(tmp_path / "ckpt.npz"))
    second = AudioPipeline(config, net)
    second.load_state(str(tmp_path / "ckpt.npz"))
    assert second._carry["fsm"]["ireg"].shape[0] == 1 + len(GRID) and not second._chained
    second.push_samples(audio[0, :, 6 * CHUNK :])
    assert [a + b for a, b in zip(first.alt_segments, second.alt_segments)] == whole.alt_segments
    assert first.segments + second.segments == whole.segments


def test_stack_machine_params_refuses_other_statics(net):
    st = vad.statics_from_config(VADConfig())
    with pytest.raises(ValueError, match="ring-buffer sizes"):
        vad.stack_machine_params(st, [VADMachineConfig(), VADMachineConfig(long_term_speech_avg_sec=60.0)])
    with pytest.raises(ValueError, match="speech band"):
        vad.stack_machine_params(st, [VADMachineConfig(speech_min_freq=300.0)])
    with pytest.raises(ValueError, match="one machine a stream"):
        OnlineBatchServer(PipelineConfig(vad_config=_config(VADConfig, VADMachineConfig)), 2, params=net)


@pytest.fixture(scope="module")
def hard_plan(tmp_path_factory):
    out = tmp_path_factory.mktemp("tune_corpus")
    make_synthetic_corpus.main(["--out", str(out), "--hard", "--denoiser", "demo", "--streams", "2", "--minutes", "0.25"])
    return os.path.join(str(out), "plan.json")


def _tune_both(capsys, tmp_path, args: list[str]) -> tuple:
    """Run the JAX and the port's tuner -> ((stdout, stderr, --out text) of each)."""
    runs = []
    for name, main, extra in (("jax", jtune.main, []), ("port", tune.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.json")
        assert main(args + ["--out", out] + extra) == 0
        text = capsys.readouterr()
        with open(out) as f:
            runs.append((text.out.replace(out, "BEST"), text.err, f.read()))
    return runs


def test_tune_matches_the_jax_tuner(hard_plan, tmp_path, capsys, host_fsm_on_cpu, monkeypatch):
    # The JAX tuner's runner without a mesh over the test session's eight
    # CPU devices: the same segments (the JAX package's mesh tests) at a
    # third of its CPU time, which keeps this file inside its budget.
    monkeypatch.setattr(jsimulator, "BatchRunner", functools.partial(JBatchRunner, use_mesh=False))
    jax_run, port_run = _tune_both(capsys, tmp_path, [
        "-i", hard_plan, "--grid", "speech_threshold_factor=3,10,40", "--grid", "channel_vol_ratio_threshold=0.3,0.5"])
    assert port_run == jax_run
    ranked = [ln for ln in port_run[0].splitlines() if ln.split() and ln.split()[0].isdigit()]
    assert len(ranked) == 6 and len({ln.split()[-2] for ln in ranked}) >= 2
    best = json.loads(port_run[2])["vad_config"]["vad_machine_config"]
    assert dataclasses.replace(VADMachineConfig(), **best) == VADMachineConfig(**best)


def test_tune_static_key_groups(tmp_path, capsys, host_fsm_on_cpu):
    """A static key splits the grid into two groups, one pass each; the
    candidate equal to the base config still reproduces the base row (as
    the JAX package's tests/test_tune.py::test_static_key_groups)."""
    synth.write_corpus(str(tmp_path), 1, 8.0, seed=3, plans={"tune": {}})
    rc = tune.main(["-i", str(tmp_path / "plan_tune.json"), "--device", "cpu",
                    "--grid", "short_term_speech_avg_sec=0.2,0.4", "--grid", "speech_threshold_factor=10,30"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "[group 1/2: " in captured.err and "[group 2/2: " in captured.err
    lines = [ln for ln in captured.out.splitlines() if ln.strip()]
    ranked = [ln for ln in lines if ln.split()[0].isdigit()]
    base = [ln for ln in lines if ln.startswith("base")]
    assert len(ranked) == 4 and len(base) == 1
    cand_base = next(ln for ln in ranked if ln.split()[1] == "0.2" and ln.split()[2] == "10")
    assert cand_base.split()[3:] == base[0].split()[3:]


def test_tune_defaults_to_the_card(hard_plan, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["-i", hard_plan, "--grid", "speech_threshold_factor=3,10"])
    with pytest.raises(SystemExit, match="not tunable"):
        tune.parse_grid(["fft_size=512,1024"])
