"""The streaming path against the JAX package, on the same inputs: the
per-chunk ops, ``denoiser.denoise_chunk``, ``vad.chunk_step`` and
``process_stream``, the host ``AudioPipeline`` with its rings and
recorders, ``BatchRunner(use_offline=False)``, the simulator's
``"batch_streams": false`` plans and the bf16 and int8 tiers stepped chunk
by chunk.

Bars: products and reductions at rtol = atol = 1e-5 (``TOL``, as
tests/test_torch_ops.py: XLA:CPU and torch sum in other orders); data
movement bit for bit; the chained denoiser at atol 3e-5, the JAX package's
own bar between its chunked and offline denoisers (tests/test_offline.py);
the FSM's window inputs at rtol 1e-5 and its events, indices and
validity identical; segments identical but for each one's channel-volume
ratio, held at rtol 1e-6 (the chunk RMS is accumulated in float64 here,
ROADMAP §3 fault 1). The tiers are not parity modes: their segments are
held to the JAX tier's run on count, with every boundary within one FSM
window. Streams are at most 16 chunks (8 s).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_nsnet2 import _flat

from formula_vad_tpu.apps import simulator as jsim
from formula_vad_tpu.config import PipelineConfig as JPipelineConfig
from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.config import VADMachineConfig as JVADMachineConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.ops import precision as jprecision
from formula_vad_tpu.ops import resample as jresample
from formula_vad_tpu.ops import stft as jstft
from formula_vad_tpu.ops import volume as jvolume
from formula_vad_tpu.pipeline import denoiser as jden
from formula_vad_tpu.pipeline import vad as jvad
from formula_vad_tpu.pipeline.pipeline import AudioPipeline as JAudioPipeline
from formula_vad_tpu.pipeline.pipeline import Callbacks as JCallbacks
from formula_vad_tpu.pipeline.pipeline import RingBuffer as JRingBuffer
from formula_vad_tpu_torch.apps import simulator as sim
from formula_vad_tpu_torch.config import PipelineConfig, VADConfig, VADMachineConfig
from formula_vad_tpu_torch.models import nsnet2, registry
from formula_vad_tpu_torch.ops import precision, resample, stft, volume, windows
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.pipeline import denoiser, offline, vad
from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline, Callbacks, RingBuffer
from formula_vad_tpu_torch.testing import synth

TOL = dict(rtol=1e-5, atol=1e-5)
DEN_ATOL = 3e-5
RATIO_RTOL = 1e-6
FFT = 1024
CHUNK = 24000
MACHINE = dict(long_term_speech_avg_sec=10.0)  # the JAX streaming tests' machine
DEN_WIN = windows.sqrt_hann_symmetric(320)
BAND_WIN = windows.hann_periodic(1024)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Hundreds of small tensor ops a chunk, for which torch's intra-op
    threads only add overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_tiers():
    yield
    jprecision.set_matmul_precision("highest")
    jprecision.set_quant("off")
    precision.set_matmul_precision("highest")
    precision.set_io_dtype("f32")
    precision.set_quant("off")


@pytest.fixture(scope="module")
def pair():
    """The JAX streaming tests' weights (``init_params(PRNGKey(7))``) in both packages."""
    jp = jnsnet2.init_params(jax.random.PRNGKey(7))
    return jp, nsnet2.from_numpy(_flat(jp))


def speechy_audio(n_chunks, bursts, seed=0, channels=2):
    """tests/test_offline.py's stream: noise with two-tone speech bursts,
    the second channel at 0.9 of the first."""
    rng = np.random.default_rng(seed)
    t_total = n_chunks * CHUNK
    t = np.arange(t_total) / 48000.0
    base = 0.003 * rng.standard_normal((2, t_total))
    env = np.zeros(t_total)
    for start_s, dur_s in bursts:
        i0, i1 = int(start_s * 48000), int((start_s + dur_s) * 48000)
        env[i0 : min(i1, t_total)] = 1.0
    speech = (0.25 * np.sin(2 * np.pi * 700 * t) + 0.15 * np.sin(2 * np.pi * 1300 * t)) * env
    return (base + np.stack([speech, 0.9 * speech])).astype(np.float32)[:channels]


def _statics(n_channels=2):
    jst = jvad.statics_from_config(JVADConfig(vad_machine_config=JVADMachineConfig(**MACHINE)), n_channels=n_channels)
    st = vad.statics_from_config(VADConfig(vad_machine_config=VADMachineConfig(**MACHINE)), n_channels=n_channels)
    return jst, st


def _same_segments(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("sample_from", "sample_to", "vad_met_sec")} == {
            k: w[k] for k in ("sample_from", "sample_to", "vad_met_sec")
        }
        assert g["avg_channel_vol_ratio"] == pytest.approx(w["avg_channel_vol_ratio"], rel=RATIO_RTOL)


def _within_a_window(got, want):
    assert want and len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert abs(g["sample_from"] - w["sample_from"]) <= FFT and abs(g["sample_to"] - w["sample_to"]) <= FFT


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def _op_case(name, rng):
    x = (0.1 * rng.standard_normal((2, 8160))).astype(np.float32)
    if name == "frame_signal":
        return stft.frame_signal(torch.from_numpy(x), 320, 160).numpy(), np.asarray(jstft.frame_signal(jnp.asarray(x), 320, 160)), None
    if name == "downsample":
        y = (0.1 * rng.standard_normal((2, 3, 24000))).astype(np.float32)
        return resample.downsample(torch.from_numpy(y), 3).numpy(), np.asarray(jresample.downsample(jnp.asarray(y), 3)), None
    if name == "stft":
        got = stft.stft(torch.from_numpy(x), DEN_WIN, 320, 160)
        want = jstft.stft(jnp.asarray(x), DEN_WIN, 320, 160)
        return torch.stack(got).numpy(), np.stack([np.asarray(w) for w in want]), TOL
    if name == "istft_overlap_add":
        re, im = (rng.standard_normal((2, 3, 50, 161)).astype(np.float32) for _ in range(2))
        got = stft.istft_overlap_add(torch.from_numpy(re), torch.from_numpy(im), DEN_WIN, 320, 160, 8160)
        return got.numpy(), np.asarray(jstft.istft_overlap_add(jnp.asarray(re), jnp.asarray(im), DEN_WIN, 320, 160, 8160)), TOL
    if name == "magnitude_windows":
        frames = (0.1 * rng.standard_normal((2, 24, 1024))).astype(np.float32)
        got = stft.magnitude_windows(torch.from_numpy(frames), BAND_WIN, 1024, 1 / 512)
        return got.numpy(), np.asarray(jstft.magnitude_windows(jnp.asarray(frames), BAND_WIN, 1024, 1 / 512)), TOL
    if name == "norm_to_dbfs":
        y = np.abs(x) + np.float32(1e-3)
        return volume.norm_to_dbfs(torch.from_numpy(y)).numpy(), np.asarray(jvolume.norm_to_dbfs(jnp.asarray(y))), TOL
    if name == "calc_downsample_rate":
        rates = [(48000, 16000), (16000, 16000), (96000, 16000)]
        got = np.array([resample.calc_downsample_rate(*r) for r in rates])
        with pytest.raises(ValueError):
            resample.calc_downsample_rate(44100, 16000)
        return got, np.array([jresample.calc_downsample_rate(*r) for r in rates]), None
    if name == "volume_analysis":
        y = (0.1 * rng.standard_normal((3, 2, 24000))).astype(np.float32)
        y[1, 1] = 0.0  # a silent channel: ratio 0
        got = volume.volume_analysis(torch.from_numpy(y))
        want = jvolume.volume_analysis(jnp.asarray(y))
        return torch.stack(got).numpy(), np.stack([np.asarray(w) for w in want]), dict(rtol=RATIO_RTOL, atol=0)
    raise AssertionError(name)


@pytest.mark.parametrize(
    "name",
    ["frame_signal", "downsample", "calc_downsample_rate", "stft", "istft_overlap_add", "magnitude_windows",
     "volume_analysis", "norm_to_dbfs"],
)
def test_ops_match_jax(name):
    got, want, tol = _op_case(name, np.random.default_rng(3))
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol is None:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("op", ["frame_signal", "stft", "istft_overlap_add"])
def test_other_hops_raise(op):
    """Only the half-overlap forms are ported (the denoiser's 320 / 160)."""
    x = torch.zeros((2, 1024))
    calls = {
        "frame_signal": lambda: stft.frame_signal(x, 128, 32),
        "stft": lambda: stft.stft(x, windows.hann_symmetric(128), 128, 32),
        "istft_overlap_add": lambda: stft.istft_overlap_add(
            torch.zeros((2, 7, 65)), torch.zeros((2, 7, 65)), windows.hann_symmetric(128), 128, 32, 320),
    }
    with pytest.raises(ValueError, match="half overlap"):
        calls[op]()


# ---------------------------------------------------------------------------
# The denoiser chunk by chunk
# ---------------------------------------------------------------------------


def test_denoise_chunk_chained_matches_jax(pair):
    jp, net = pair
    audio = (0.1 * np.random.default_rng(1).standard_normal((2, 4 * CHUNK))).astype(np.float32)
    jcarry, carry = jden.init_carry(2), denoiser.init_carry(2)
    for k in range(4):
        x = audio[:, k * CHUNK : (k + 1) * CHUNK]
        jcarry, want = jden.denoise_chunk(jp, jcarry, jnp.asarray(x))
        with torch.inference_mode():
            carry, got = denoiser.denoise_chunk(net, carry, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=DEN_ATOL)
        assert set(carry) == set(jcarry)
        for key in carry:
            assert carry[key].dtype == torch.float32, key
            np.testing.assert_allclose(carry[key].numpy(), np.asarray(jcarry[key]), rtol=0, atol=DEN_ATOL, err_msg=key)


def test_carries_hold_copies_not_views(pair):
    """A view would keep a chunk's audio and intermediates alive for as
    long as the carry lives."""
    _, net = pair
    _, st = _statics()
    x = torch.from_numpy(speechy_audio(1, [], seed=2))
    with torch.inference_mode():
        carry, _ = vad.chunk_step(net, st, vad.init_carry(st), x)
    leaves = [v for k, v in carry.items() if k not in ("denoiser", "fsm")] + list(carry["denoiser"].values())
    leaves += list(carry["fsm"].values())
    for leaf in leaves:
        assert leaf._base is None and leaf.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# chunk_step and process_stream
# ---------------------------------------------------------------------------

# name -> (chunks, bursts, seed, channels, chunk_valids or None)
STREAMS = {
    "burst": (16, [(2.0, 2.0)], 8, 2, None),
    "ragged": (16, [(2.0, 2.0)], 6, 2, [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0]),
    "mono": (16, [(2.0, 2.0)], 10, 1, None),
}


@pytest.fixture(scope="module")
def stream_runs(pair):
    """Each of STREAMS through the JAX and the port's ``process_stream``."""
    jp, net = pair
    runs = {}
    for name, (n, bursts, seed, channels, cv) in STREAMS.items():
        audio = speechy_audio(n, bursts, seed, channels)
        jst, st = _statics(channels)
        cv = None if cv is None else np.asarray(cv, bool)
        _, want = jax.jit(lambda a, v: jvad.process_stream(jp, jst, a, chunk_valids=v))(
            jnp.asarray(audio), jnp.ones((n,), bool) if cv is None else jnp.asarray(cv)
        )
        with torch.inference_mode():
            _, got = vad.process_stream(net, st, torch.from_numpy(audio), chunk_valids=cv)
        runs[name] = (jst, st, want, got, audio, cv)
    return runs


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_process_stream_matches_jax(stream_runs, name):
    jst, st, want, got, _, _ = stream_runs[name]
    # A padding chunk's masked slots are framed at the offset the valid
    # rows share (process_stream's shared_start), the JAX scan's at the
    # frozen carry's: the band volumes are held on the valid windows.
    valid = np.asarray(want.window_valid)
    np.testing.assert_allclose(got.min_vol.numpy()[valid], np.asarray(want.min_vol)[valid], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.ratios.numpy(), np.asarray(want.ratios), rtol=1e-5, atol=1e-7)
    for field, a, b in (
        ("window_valid", got.window_valid, want.window_valid),
        ("win_indices", got.win_indices, want.win_indices),
        ("event", got.windows.event, want.windows.event),
        ("event_win", got.windows.event_win, want.windows.event_win),
    ):
        assert np.array_equal(a.numpy(), np.asarray(b)), field
    expected = jvad.segments_from_outputs(jst, want)
    assert expected, "the stream must hold speech"
    _same_segments(vad.segments_from_outputs(st, got.windows), expected)


def test_ragged_chunks_freeze_the_carry(pair, stream_runs):
    """Padding chunks mask every window and freeze the carry: the stream
    with its invalid chunks cut out scores the same windows."""
    _, st, _, got, audio, cv = stream_runs["ragged"]
    kept = np.concatenate([audio[:, k * CHUNK : (k + 1) * CHUNK] for k in np.nonzero(cv)[0]], axis=1)
    with torch.inference_mode():
        _, cut = vad.process_stream(pair[1], st, torch.from_numpy(kept))
    valid = got.window_valid.numpy()
    assert not valid[~cv].any()
    for field in cut.windows._fields:
        a = getattr(got.windows, field).numpy()[valid]
        assert np.array_equal(a, getattr(cut.windows, field).numpy()[cut.window_valid.numpy()]), field


def test_batched_streams_match_each_stream_alone(pair):
    """B streams in one process_stream, each with its own padding (so the
    rows' framing offsets part and the per-row framing runs), against the
    JAX package's stream-by-stream runs."""
    jp, net = pair
    jst, st = _statics()
    audio = np.stack([speechy_audio(10, [(1.0, 2.0)], seed=s) for s in (11, 12)])
    cv = np.array([[1, 1, 0, 1, 1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1, 1, 0, 0, 0]], bool)
    with torch.inference_mode():
        _, got = vad.process_stream(net, st, torch.from_numpy(audio), chunk_valids=cv)
    run = jax.jit(jax.vmap(lambda a, v: jvad.process_stream(jp, jst, a, chunk_valids=v)[1]))
    want = run(jnp.asarray(audio), jnp.asarray(cv))
    valid = np.asarray(want.window_valid)
    np.testing.assert_allclose(got.min_vol.numpy()[valid], np.asarray(want.min_vol)[valid], rtol=1e-5, atol=1e-7)
    assert np.array_equal(got.win_indices.numpy(), np.asarray(want.win_indices))
    for i in range(2):
        expected = jvad.segments_from_outputs(jst, jax.tree_util.tree_map(lambda x: x[i], want))
        _same_segments(vad.segments_from_outputs(st, fsm_row(got.windows, i)), expected)


def fsm_row(windows_out, i):
    return type(windows_out)(*(x[i] for x in windows_out))


def test_chunk_step_framing_forms_agree(pair):
    """The per-row gather of the framing (no shared start) and the shared
    slice read the same samples."""
    _, net = pair
    _, st = _statics()
    audio = torch.from_numpy(speechy_audio(3, [(0.5, 0.7)], seed=3))
    outs = {}
    for shared in (True, False):
        carry = vad.init_carry(st)
        with torch.inference_mode():
            for k in range(3):
                start = FFT - (k * CHUNK) % FFT if shared else None
                carry, out = vad.chunk_step(net, st, carry, audio[:, k * CHUNK : (k + 1) * CHUNK], shared_start=start, chained=k > 0)
        outs[shared] = out
    assert torch.equal(outs[True].min_vol, outs[False].min_vol)
    assert outs[True].denoised.shape == (2, CHUNK)


@pytest.mark.parametrize(
    "n, bursts, seed, n_valid",
    [(16, [(2.0, 2.0)], 8, None), (7, [(0.7, 0.9), (3.1, 1.3)], 4, None), (7, [(0.7, 0.9), (3.1, 1.3)], 5, None),
     (10, [(2.0, 2.0)], 6, 7)],
    ids=["burst", "two_bursts_4", "two_bursts_5", "padding"],
)
def test_offline_matches_streaming(pair, n, bursts, seed, n_valid):
    """tests/test_offline.py's cases on the port: its offline path and its
    streaming path give the same segments."""
    _, net = pair
    _, st = _statics()
    audio = torch.from_numpy(speechy_audio(n, bursts, seed))
    cv = None if n_valid is None else np.arange(n) < n_valid
    with torch.inference_mode():
        _, outs = vad.process_stream(net, st, audio, chunk_valids=cv)
        win_out, valid = offline.process_stream_offline(net, st, audio, n_valid)
    expected = vad.segments_from_outputs(st, outs.windows)
    assert offline.segments_from_offline(st, win_out) == expected
    if n_valid is not None:
        assert int(valid.sum()) == int(outs.window_valid.sum()) == (n_valid * CHUNK) // FFT


def test_streaming_runner_equals_offline_runner():
    net = registry.load_denoiser("demo", device="cpu")
    rng = np.random.default_rng(5)
    audio = np.stack([synth.synth_stream(rng, 8.0)[0] for _ in range(2)])
    lengths = [audio.shape[-1], audio.shape[-1] - 70_000]
    stream = BatchRunner(net, use_offline=False).run(audio, lengths)
    assert [r.segments for r in stream] == [r.segments for r in BatchRunner(net).run(audio, lengths)]


# ---------------------------------------------------------------------------
# AudioPipeline
# ---------------------------------------------------------------------------


def _push_irregular(pipe, audio, seed=0):
    pos, rng = 0, np.random.default_rng(seed)
    while pos < audio.shape[1]:
        n = int(rng.integers(1000, 100000))
        pipe.push_samples(audio[:, pos : pos + n])
        pos += n


def _pipelines(pair, audio, buffer_length=None):
    """The JAX and the port's AudioPipeline over ``audio`` pushed in the
    same irregular sizes -> {pkg: (pipeline, {kind: recordings})}."""
    jp, net = pair
    out = {}
    for pkg in ("jax", "port"):
        recs = {"original": [], "denoised": []}
        kw = dict(on_original_recording=recs["original"].append, on_denoised_recording=recs["denoised"].append)
        if pkg == "jax":
            cfg = JPipelineConfig(buffer_length=buffer_length, vad_config=JVADConfig(vad_machine_config=JVADMachineConfig(**MACHINE)))
            pipe = JAudioPipeline(cfg, params=jp, callbacks=JCallbacks(**kw))
        else:
            cfg = PipelineConfig(buffer_length=buffer_length, vad_config=VADConfig(vad_machine_config=VADMachineConfig(**MACHINE)))
            pipe = AudioPipeline(cfg, net, Callbacks(**kw))
        _push_irregular(pipe, audio)
        out[pkg] = (pipe, recs)
    return out


PIPE_AUDIO = dict(n_chunks=16, bursts=[(1.0, 1.5), (4.0, 1.5)], seed=5)


@pytest.fixture(scope="module")
def pipelines(pair):
    return _pipelines(pair, speechy_audio(**PIPE_AUDIO))


def test_pipeline_matches_process_stream_and_jax(pair, pipelines):
    _, net = pair
    _, st = _statics()
    port, jaxp = pipelines["port"][0], pipelines["jax"][0]
    with torch.inference_mode():
        _, outs = vad.process_stream(net, st, torch.from_numpy(speechy_audio(**PIPE_AUDIO)))
    assert port.segments and port.segments == vad.segments_from_outputs(st, outs.windows)
    _same_segments(port.segments, jaxp.segments)
    assert port.total_write_count == jaxp.total_write_count
    assert np.array_equal(port.original_ring.data, jaxp.original_ring.data)
    np.testing.assert_allclose(port.denoised_ring.data, jaxp.denoised_ring.data, rtol=0, atol=DEN_ATOL)


def test_pipeline_recordings(pipelines):
    """One original and one denoised recording a segment, mono (the
    quietest channel), starting at its sample_from and ending at its
    sample_to, as the JAX pipeline's."""
    port, recs = pipelines["port"]
    _, jrecs = pipelines["jax"]
    for kind in ("original", "denoised"):
        assert len(recs[kind]) == len(port.segments) == len(jrecs[kind])
        for buf, jbuf, seg in zip(recs[kind], jrecs[kind], port.segments):
            assert buf.n_channels == 1 and buf.sample_rate == 48000
            assert buf.global_start_frame_number == jbuf.global_start_frame_number == seg["sample_from"]
            assert buf.length == jbuf.length == seg["sample_to"] - seg["sample_from"]
            if kind == "original":
                assert np.array_equal(buf.channel_pcm, jbuf.channel_pcm)
            else:
                np.testing.assert_allclose(buf.channel_pcm, jbuf.channel_pcm, rtol=0, atol=DEN_ATOL)


def test_pipeline_ring_wraps(pair):
    """A ring of 1.25 s (the least that holds a half-ring slab and a chunk)
    wraps many times and clips each recording's 2 s pre-roll to what it
    still holds, as the JAX pipeline does."""
    runs = _pipelines(pair, speechy_audio(16, [(2.0, 2.0)], seed=8), buffer_length=60_000)
    (port, recs), (jaxp, jrecs) = runs["port"], runs["jax"]
    assert port.original_ring.total_written > 6 * port.original_ring.capacity
    _same_segments(port.segments, jaxp.segments)
    assert port.segments
    for kind in ("original", "denoised"):
        got = [(b.global_start_frame_number, b.length) for b in recs[kind]]
        assert got and got == [(b.global_start_frame_number, b.length) for b in jrecs[kind]]
        assert got[0][0] > port.segments[0]["sample_from"]  # the pre-roll was clipped by the ring


@pytest.mark.parametrize("n", [100, 36_000, 50_000, 123_457])
def test_ring_buffer_matches_jax(n):
    rng = np.random.default_rng(n)
    ring, jring = RingBuffer(2, 36_000), JRingBuffer(2, 36_000)
    for _ in range(3):
        x = rng.standard_normal((2, n)).astype(np.float32)
        ring.write(x)
        jring.write(x)
    lo = max(0, ring.total_written - ring.capacity)
    assert np.array_equal(ring.read(lo, ring.total_written), jring.read(lo, jring.total_written))
    assert np.array_equal(ring.read(lo, ring.total_written)[:, -min(n, ring.capacity) :], x[:, -min(n, ring.capacity) :])
    with pytest.raises(IndexError):
        ring.read(lo, ring.total_written + 1)
    if lo > 0:
        with pytest.raises(IndexError):
            ring.read(lo - 1, ring.total_written)


def test_pipeline_skip_processing(pair):
    _, net = pair
    pipe = AudioPipeline(PipelineConfig(skip_processing=True), net)
    pipe.push_samples(np.zeros((2, 100_000), np.float32))
    assert pipe.total_write_count == 100_000 and pipe.segments == [] and pipe.pending_chunks == 0
    with pytest.raises(ValueError, match="channels"):
        pipe.push_samples(np.zeros((1, 10), np.float32))


def test_pipeline_server_mode_matches_push(pair, pipelines):
    """buffer_samples / peek_pending_chunk / complete_chunk, with the step
    run outside, leave the pipeline as push_samples does."""
    _, net = pair
    _, st = _statics()
    port = pipelines["port"][0]
    audio = speechy_audio(**PIPE_AUDIO)
    pipe = AudioPipeline(PipelineConfig(vad_config=VADConfig(vad_machine_config=VADMachineConfig(**MACHINE))), net,
                         server_managed=True)
    carry = vad.init_carry(st)
    for k in range(0, audio.shape[1], 30_000):
        pipe.buffer_samples(audio[:, k : k + 30_000])
        while pipe.pending_chunks:
            with torch.inference_mode():
                carry, out = vad.chunk_step(net, st, carry, torch.from_numpy(np.ascontiguousarray(pipe.peek_pending_chunk())))
            pipe.complete_chunk(out)
    assert pipe.segments == port.segments
    with pytest.raises(RuntimeError, match="server-managed"):
        pipe.push_samples(np.zeros((2, CHUNK), np.float32))


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_unported_streaming_parts_raise(pair):
    _, net = pair
    _, st = _statics()
    # K machines a stream are ported: the pipeline keeps a segment list an
    # alternative, a stacked config runs as rows of the one scan, and a
    # parameter leaf of another shape is refused.
    pipe = AudioPipeline(PipelineConfig(vad_config=VADConfig(alt_vad_machine_configs=[VADMachineConfig()])), net)
    assert pipe.alt_segments == [[]]
    stacked = vad.stack_machine_params(
        st, [VADMachineConfig(**MACHINE), VADMachineConfig(**MACHINE, speech_threshold_factor=5.0)])
    assert stacked.threshold_factor.tolist() == [10.0, 5.0]
    x = torch.zeros((2, CHUNK))
    with torch.inference_mode():
        _, out = vad.chunk_step(net, st, vad.init_carry(st), x, fsm_params=stacked)
    assert out.windows.event.shape == (2, st.max_windows)
    k_machines = st.fsm_params._replace(threshold_factor=np.array([5.0, 6.0], np.float32))
    with pytest.raises(ValueError, match="scalar or \\[K\\]"):
        vad.chunk_step(net, st, vad.init_carry(st), x, fsm_params=k_machines)
    with pytest.raises(ValueError, match="use_offline"):
        BatchRunner(net, use_host_fsm=True, use_offline=False)
    with pytest.raises(ValueError, match="24000"):
        denoiser.denoise_chunk(net, denoiser.init_carry(2), torch.zeros((2, 100)))


def test_pipeline_defaults_to_the_card(monkeypatch):
    """Without a net the pipeline loads one on the card, and raises where
    no GPU is visible rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioPipeline(PipelineConfig())
    assert AudioPipeline(PipelineConfig(), device="cpu").device == torch.device("cpu")


def test_collect_denoised_false_returns_zero_width(pair):
    _, net = pair
    _, st = _statics()
    with torch.inference_mode():
        _, out = vad.chunk_step(net, st, vad.init_carry(st), torch.zeros((2, CHUNK)), collect_denoised=False)
    assert out.denoised.shape == (2, 0)


# ---------------------------------------------------------------------------
# The simulator's batch_streams: false plans
# ---------------------------------------------------------------------------

SIM_STREAMS, SIM_SECONDS = 2, 14.0


@pytest.fixture(scope="module")
def sim_runs(tmp_path_factory):
    """The JAX and the port's simulator on a streaming plan, and the port's
    on a batched plan: {name: (out_dir, instances)}."""
    root = tmp_path_factory.mktemp("torch_stream_sim")
    streaming = {"batch_streams": False, "audio_read_frame_count": 30_000}
    synth.write_corpus(str(root), SIM_STREAMS, SIM_SECONDS, seed=3,
                       plans={"jax": streaming, "port": streaming, "batched": {}})
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, module, fn in (("jax", jsim, "run_streaming"), ("port", sim, "run_streaming"), ("batched", sim, "run_batched")):
            orig = getattr(module, fn)

            def wrapped(instances, *args, orig=orig, name=name):
                orig(instances, *args)
                seen[name] = instances

            mp.setattr(module, fn, wrapped)
        assert jsim.main(["-i", str(root / "plan_jax.json")]) == 0
        for name in ("port", "batched"):
            assert sim.main(["-i", str(root / f"plan_{name}.json"), "--device", "cpu"]) == 0
    out = {}
    for name in seen:
        (run_dir,) = os.listdir(root / f"out_{name}")
        out[name] = (root / f"out_{name}" / run_dir, seen[name])
    return out


@pytest.mark.parametrize("name", ["report.txt"] + [f"s{i}-audacity.txt" for i in range(SIM_STREAMS)])
def test_streaming_simulator_files_identical(sim_runs, name):
    assert (sim_runs["port"][0] / name).read_bytes() == (sim_runs["jax"][0] / name).read_bytes()


def _clips(run):
    from formula_vad_tpu_torch.io_ import AudioSource

    clips = {}
    for inst in run[1]:
        for f in sorted(os.listdir(inst.out_dir)):
            src = AudioSource.open_stream(os.path.join(inst.out_dir, f))
            clips[(inst.name, f)] = src.n_frames
            src.close()
    return clips


def test_streaming_simulator_clips(sim_runs):
    """The streaming plan's clips carry the names and sample counts of the
    JAX streaming run's and of the port's batched plan's."""
    got = _clips(sim_runs["port"])
    assert got and any(os.path.splitext(name)[0].endswith("-denoised") for _, name in got)
    assert got == _clips(sim_runs["jax"]) == _clips(sim_runs["batched"])
    for jinst, inst in zip(sim_runs["jax"][1], sim_runs["port"][1]):
        _same_segments(inst.vad_segments, jinst.vad_segments)


# ---------------------------------------------------------------------------
# The tiers, stepped chunk by chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_tier_streaming_segments_match_jax(tier):
    """The demo weights on the JAX tests' burst stream under each tier: the
    same segments as the JAX package's streaming run of the tier, each
    boundary within one window."""
    jp, net = jnsnet2.load_npz(DEMO_WEIGHTS), registry.load_denoiser("demo", device="cpu")
    jst, st = _statics()
    audio = speechy_audio(16, [(2.0, 2.0)], seed=8)
    if tier == "bf16":
        jprecision.set_matmul_precision("default")
        precision.set_matmul_precision("default")
    else:
        jprecision.set_quant("int8")
        precision.set_quant("int8")
    _, want = jax.jit(lambda a: jvad.process_stream(jp, jst, a))(jnp.asarray(audio))
    with torch.inference_mode():
        _, got = vad.process_stream(net, st, torch.from_numpy(audio))
    _within_a_window(vad.segments_from_outputs(st, got.windows), jvad.segments_from_outputs(jst, want))
