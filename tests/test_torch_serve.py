"""Serving on the CPU: the port's ``OnlineBatchServer`` against the JAX
package's on the same inputs and against its own variants, the
checkpoints it and ``AudioPipeline`` resume from (``utils/checkpoint.py``),
``chunk_step(run_fsm=False)`` and the copied ``utils`` modules.

Weights: the JAX server tests' ``init_params(PRNGKey(42))``, carried across
by ``from_numpy``. Streams: 4 of 8 chunks (4 s), on the int16 grid so that
an int16 push carries the same samples, with the JAX server tests'
machine (``long_term_speech_avg_sec=10``, and the default
``initial_long_term_avg``, so a machine with unseeded Kahan slots decides
otherwise). Bars: against the JAX server, segments identical but for each
one's channel-volume ratio, held at rtol 1e-6 (ROADMAP §3 fault 1). Port
against port: segments, original recordings, every decision and index bit
for bit; so the float outputs (denoised audio and recordings, window
volumes, the carry's float leaves) between runs whose batches have the same
row count. Between runs whose row counts differ (solo pipelines against the
fleet, microbatches, a reset slot against a fresh server) the float outputs
are held at ``BATCH_TOL``: on the CPU the plain versions' MKL GEMMs and
PyTorch's vectorised sigmoid round a row by the batch's row count (the
DFT's product at K = 1,024 takes another blocking; a tensor's last partial
vector another code path), so they differ there by 1e-10 to 1e-7.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch
from test_torch_nsnet2 import _flat

from formula_vad_tpu.config import PipelineConfig as JPipelineConfig
from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.config import VADMachineConfig as JVADMachineConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.parallel.online import OnlineBatchServer as JOnlineBatchServer
from formula_vad_tpu_torch.config import PipelineConfig, VADConfig, VADMachineConfig
from formula_vad_tpu_torch.models import nsnet2
from formula_vad_tpu_torch.parallel import mesh as mesh_lib
from formula_vad_tpu_torch.parallel.online import OnlineBatchServer
from formula_vad_tpu_torch.pipeline import fsm, fsm_cuda, fsm_host, vad
from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline, Callbacks
from formula_vad_tpu_torch.utils import checkpoint, profiling
from formula_vad_tpu_torch.utils import uuid as fvad_uuid

CHUNK = 24000
N_STREAMS, N_CHUNKS = 4, 8
RATIO_RTOL = 1e-6
BURSTS = ([(0.3, 1.0)], [(0.5, 1.0), (2.5, 1.0)], [], [(0.2, 0.8)])
MACHINE = dict(long_term_speech_avg_sec=10.0)
BATCH_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Hundreds of small tensor ops a tick, for which torch's intra-op
    threads only add overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jp = jnsnet2.init_params(jax.random.PRNGKey(42))
    return jp, nsnet2.from_numpy(_flat(jp))


def _cfg(**machine):
    return PipelineConfig(vad_config=VADConfig(vad_machine_config=VADMachineConfig(**{**MACHINE, **machine})))


def speechy(n_chunks, bursts, seed):
    """tests/test_online_server.py's stream, rounded to the int16 grid."""
    rng = np.random.default_rng(seed)
    t_total = n_chunks * CHUNK
    t = np.arange(t_total) / 48000.0
    base = 0.003 * rng.standard_normal((2, t_total))
    env = np.zeros(t_total)
    for s, d in bursts:
        env[int(s * 48000) : int((s + d) * 48000)] = 1.0
    sp = (0.25 * np.sin(2 * np.pi * 700 * t) + 0.15 * np.sin(2 * np.pi * 1300 * t)) * env
    pcm = np.clip(np.round((base + np.stack([sp, 0.9 * sp])) * 32768), -32768, 32767).astype(np.int16)
    return pcm


@pytest.fixture(scope="module")
def fleet():
    """4 streams as int16 PCM and float32, and a random valid pattern (tick 0
    all valid, so the shared-fill framing engages before the fills part)."""
    pcm = [speechy(N_CHUNKS, b, seed=40 + i) for i, b in enumerate(BURSTS)]
    audio = [(x.astype(np.float32) / np.float32(32768.0)) for x in pcm]
    rng = np.random.default_rng(0)
    masks, done = [np.ones(N_STREAMS, bool)], np.ones(N_STREAMS, int)
    while (done < N_CHUNKS).any():
        m = (rng.random(N_STREAMS) < 0.8) & (done < N_CHUNKS)
        masks.append(m)
        done += m
    return pcm, audio, masks


def _collectors(n):
    recs = {"original": [[] for _ in range(n)], "denoised": [[] for _ in range(n)]}
    cbs = [
        Callbacks(
            on_original_recording=lambda b, i=i: recs["original"][i].append(
                (b.global_start_frame_number, b.channel_pcm.tobytes())),
            on_denoised_recording=lambda b, i=i: recs["denoised"][i].append(
                (b.global_start_frame_number, b.channel_pcm.tobytes())),
        )
        for i in range(n)
    ]
    return recs, cbs


def _tick_chunks(streams, pos, mask):
    """One tick's batch: each valid stream's next chunk, zeros elsewhere."""
    zeros = np.zeros_like(streams[0][:, :CHUNK])
    return np.stack([s[:, p * CHUNK : (p + 1) * CHUNK] if v else zeros for s, p, v in zip(streams, pos, mask)])


def _feed(server, streams, masks, ticks=None):
    pos = np.zeros(len(streams), int)
    ticks = range(len(masks)) if ticks is None else ticks
    for k in ticks:
        server.push(_tick_chunks(streams, pos, masks[k]), valid=masks[k])
        pos += masks[k]


def _record_ticks(server):
    """Wrap ``server._run_step`` to keep a copy of each tick's host outputs
    and whether it took the shared-fill framing."""
    ticks, run = [], server._run_step

    def step(chunks, valid):
        live = server._fills[valid]
        shared = bool(live.size and (live == live[0]).all()) and server._use_shared_fill
        out = run(chunks, valid)
        ticks.append((valid.copy(), shared, copy.deepcopy(out)))
        return out

    server._run_step = step
    return ticks


def _serve(net, fleet, n_streams=N_STREAMS, push_int16=False, **kw):
    pcm, audio, masks = fleet
    recs, cbs = _collectors(n_streams)
    server = OnlineBatchServer(_cfg(), n_streams, params=net, callbacks=cbs, device="cpu", **kw)
    ticks = _record_ticks(server)
    _feed(server, pcm if push_int16 else audio, masks)
    return {"segments": server.segments, "recs": recs, "ticks": ticks, "carry": server._full_carries(),
            "server": server}


@pytest.fixture(scope="module")
def base(pair, fleet):
    return _serve(pair[1], fleet)


def _close(got, want, exact, what):
    """Bit for bit, or for float arrays with ``exact`` False within BATCH_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if exact or got.dtype.kind != "f":
        assert got.tobytes() == want.tobytes(), what
    else:
        np.testing.assert_allclose(got, want, err_msg=str(what), **BATCH_TOL)


def _same_carry(got, want, exact=True, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_carry(got[k], want[k], exact, f"{path}/{k}")
        return
    _close(got, want, exact, path)


def _same_ticks(got, want, fields, exact=True):
    assert len(got) == len(want)
    for k, ((va, _, g), (vb, _, w)) in enumerate(zip(got, want)):
        assert (va == vb).all()
        for f in fields:
            _close(g[f][va], w[f][va], exact, (k, f))


def _same_recs(got, want, exact=True):
    """Original recordings bit for bit; denoised ones by ``_close``."""
    assert got["original"] == want["original"]
    assert [[s for s, _ in r] for r in got["denoised"]] == [[s for s, _ in r] for r in want["denoised"]]
    for g, w in zip(got["denoised"], want["denoised"]):
        for (start, a), (_, b) in zip(g, w):
            _close(np.frombuffer(a, np.float32), np.frombuffer(b, np.float32), exact, ("denoised", start))


WINDOW_FIELDS = fsm.WindowOutput._fields
TICK_FIELDS = WINDOW_FIELDS + ("window_valid", "min_vol", "ratios", "win_indices", "denoised")


def test_base_run_exercises_both_framings_and_recordings(base):
    shared = [s for _, s, _ in base["ticks"]]
    assert shared[0] and not all(shared), shared
    assert base["segments"][0] and base["segments"][3] and not base["segments"][1] + base["segments"][2]
    assert base["server"].pipelines[1].original_recorder.recording  # in flight at the end
    assert any(base["recs"]["original"]) and any(base["recs"]["denoised"])


def test_server_matches_jax_server(pair, fleet, base):
    """The JAX OnlineBatchServer on the same weights, streams and valid
    pattern: the same segments (ratio at rtol 1e-6, ROADMAP §3 fault 1)."""
    jp, _ = pair
    _, audio, masks = fleet
    jcfg = JPipelineConfig(vad_config=JVADConfig(vad_machine_config=JVADMachineConfig(**MACHINE)))
    # One framing for the JAX server (one compile): its shared-fill path is
    # bit for bit its per-row one (tests/test_online_server.py).
    server = JOnlineBatchServer(jcfg, N_STREAMS, params=jp, use_shared_fill=False)
    _feed(server, audio, masks)
    want, got = server.segments, base["segments"]
    assert len(got) == len(want)
    for g_stream, w_stream in zip(got, want):
        assert len(g_stream) == len(w_stream)
        for g, w in zip(g_stream, w_stream):
            assert {k: g[k] for k in ("sample_from", "sample_to", "vad_met_sec")} == {
                k: w[k] for k in ("sample_from", "sample_to", "vad_met_sec")
            }
            assert g["avg_channel_vol_ratio"] == pytest.approx(w["avg_channel_vol_ratio"], rel=RATIO_RTOL)


@pytest.mark.parametrize("variant", ["per_row_gather", "int16_push", "microbatch_2", "host_fsm", "events_only"])
def test_server_variants_bit_for_bit(pair, fleet, base, variant):
    """Each serving variant against the default server (device FSM, shared
    fill, float32 push, microbatch 1, denoised collected): segments,
    recordings, every tick's outputs on its valid rows and the final carry,
    bit for bit."""
    kw = {
        "per_row_gather": dict(use_shared_fill=False),
        "int16_push": dict(push_int16=True),
        "microbatch_2": dict(microbatch=2),
        "host_fsm": dict(use_host_fsm=True),
        "events_only": dict(collect_denoised=False),
    }[variant]
    got = _serve(pair[1], fleet, **kw)
    exact = variant != "microbatch_2"  # half the rows a step
    assert got["segments"] == base["segments"]
    if variant == "events_only":
        assert got["recs"]["original"] == base["recs"]["original"]
        assert got["recs"]["denoised"] == [[]] * N_STREAMS
        assert all(p.denoised_ring.total_written == 0 for p in got["server"].pipelines)
        _same_ticks(got["ticks"], base["ticks"], TICK_FIELDS[:-1])
    else:
        _same_recs(got["recs"], base["recs"], exact)
        _same_ticks(got["ticks"], base["ticks"], TICK_FIELDS, exact)
    if variant == "per_row_gather":
        assert not any(s for _, s, _ in got["ticks"])
    _same_carry(got["carry"], base["carry"], exact)


def test_server_matches_solo_pipelines(pair, fleet, base):
    """Each stream alone through a solo AudioPipeline, its chunks
    contiguous: the server's segments and recordings, bit for bit."""
    _, audio, _ = fleet
    recs, cbs = _collectors(N_STREAMS)
    segments = []
    for a, cb in zip(audio, cbs):
        p = AudioPipeline(_cfg(), pair[1], cb, device="cpu")
        p.push_samples(a)
        segments.append(p.segments)
    assert segments == base["segments"]
    _same_recs(recs, base["recs"], exact=False)


def test_push_routes_buffered_tails_through_the_ring(pair, fleet):
    """A stream with a sub-chunk tail buffered before its pushes is served
    from its ring, in sample order: the segments of the same audio fed
    through buffer_samples and tick_pending alone."""
    audio = fleet[1][0]
    tail = 5000
    mixed = OnlineBatchServer(_cfg(), 1, params=pair[1], device="cpu")
    mixed.pipelines[0].buffer_samples(audio[:, :tail])
    for k in range(N_CHUNKS - 1):
        mixed.push(audio[None, :, tail + k * CHUNK : tail + (k + 1) * CHUNK])
    pure = OnlineBatchServer(_cfg(), 1, params=pair[1], device="cpu")
    pure.pipelines[0].buffer_samples(audio[:, : tail + (N_CHUNKS - 1) * CHUNK])
    while pure.tick_pending():
        pass
    assert mixed.segments == pure.segments and mixed.segments[0]


@pytest.mark.parametrize("host_fsm", [False, True], ids=["device_fsm", "host_fsm"])
def test_reset_stream_matches_a_fresh_server(pair, fleet, host_fsm):
    """Slot 1 reset mid-run and fed a new stream: its segments and
    recordings equal a fresh server's on that stream, and slot 0's equal
    its uninterrupted run. The machine has an initial long-term average,
    so a reset row whose Kahan slots were not seeded would decide
    otherwise."""
    _, audio, _ = fleet
    net = pair[1]
    old, new = audio[0], audio[3]
    recs, cbs = _collectors(2)
    server = OnlineBatchServer(_cfg(), 2, params=net, callbacks=cbs, use_host_fsm=host_fsm, device="cpu")
    k_reset = 3
    for k in range(k_reset):
        server.push(np.stack([audio[1][:, k * CHUNK : (k + 1) * CHUNK], old[:, k * CHUNK : (k + 1) * CHUNK]]))
    new_recs, new_cbs = _collectors(1)
    server.reset_stream(1, new_cbs[0])
    for k in range(N_CHUNKS):
        c0 = audio[1][:, (k_reset + k) * CHUNK : (k_reset + k + 1) * CHUNK] if k_reset + k < N_CHUNKS else None
        valid = np.array([c0 is not None, True])
        c0 = np.zeros((2, CHUNK), np.float32) if c0 is None else c0
        server.push(np.stack([c0, new[:, k * CHUNK : (k + 1) * CHUNK]]), valid=valid)
    fresh_recs, fresh_cbs = _collectors(1)
    fresh = OnlineBatchServer(_cfg(), 1, params=net, callbacks=fresh_cbs, use_host_fsm=host_fsm, device="cpu")
    uninterrupted = OnlineBatchServer(_cfg(), 1, params=net, device="cpu")
    for k in range(N_CHUNKS):
        fresh.push(new[None, :, k * CHUNK : (k + 1) * CHUNK])
        uninterrupted.push(audio[1][None, :, k * CHUNK : (k + 1) * CHUNK])
    assert server.segments[1] == fresh.segments[0] and fresh.segments[0]
    _same_recs(new_recs, fresh_recs, exact=False)
    assert any(fresh_recs["original"])
    assert server.segments[0] == uninterrupted.segments[0]


@pytest.mark.parametrize(
    "saved,loaded",
    [((False, 1), (False, 1)), ((False, 1), (True, 2)), ((True, 2), (False, 1))],
    ids=["device_m1-device_m1", "device_m1-host_m2", "host_m2-device_m1"],
)
def test_checkpoint_resumes_the_uninterrupted_run(pair, fleet, base, tmp_path, saved, loaded):
    """Save mid-stream (a recording in flight), load into a new server
    (the other FSM backend, another microbatch), continue: segments and
    recordings equal the uninterrupted run's, and the final carry too. The
    first tick after the load checks the loaded FSM carry."""
    pcm, audio, masks = fleet
    net = pair[1]
    half = len(masks) // 2
    r1, cb1 = _collectors(N_STREAMS)
    s1 = OnlineBatchServer(_cfg(), N_STREAMS, params=net, callbacks=cb1, use_host_fsm=saved[0],
                           microbatch=saved[1], device="cpu")
    _feed(s1, audio, masks, range(half))
    assert any(p.original_recorder.recording for p in s1.pipelines), "save while a recording is in flight"
    s1.save_state(str(tmp_path / "ckpt"))
    before = [list(s) for s in s1.segments]
    r2, cb2 = _collectors(N_STREAMS)
    s2 = OnlineBatchServer(_cfg(), N_STREAMS, params=net, callbacks=cb2, use_host_fsm=loaded[0],
                           microbatch=loaded[1], device="cpu")
    s2.load_state(str(tmp_path / "ckpt"))
    assert s2._chained == [False] * loaded[1]
    done = np.sum(masks[:half], axis=0)
    pos = done.copy()
    for k in range(half, len(masks)):
        s2.push(_tick_chunks(audio, pos, masks[k]), valid=masks[k])
        pos += masks[k]
    assert [a + b for a, b in zip(before, s2.segments)] == base["segments"]
    exact = saved[1] == loaded[1] == 1
    _same_recs({kind: [a + b for a, b in zip(r1[kind], r2[kind])] for kind in r1}, base["recs"], exact)
    _same_carry(s2._full_carries(), base["carry"], exact)


def test_server_refusals(pair):
    net = pair[1]
    # Serving over a mesh is ported (tests/test_torch_mesh.py); the server
    # refuses a shard its mesh's devices do not divide, and a mesh across processes.
    with pytest.raises(ValueError, match="divisible by the mesh's 2 devices"):
        OnlineBatchServer(_cfg(), 2, params=net, mesh=mesh_lib.data_mesh(["cpu"] * 2), microbatch=2, device="cpu")
    with pytest.raises(ValueError, match="one process"):
        OnlineBatchServer(_cfg(), 2, params=net, mesh=mesh_lib.DataMesh((torch.device("cpu"),), 2), device="cpu")
    with pytest.raises(ValueError, match="microbatch"):
        OnlineBatchServer(_cfg(), 3, params=net, microbatch=2, device="cpu")
    server = OnlineBatchServer(_cfg(), 2, params=net, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        server.push(np.zeros((2, 2, 100), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        server.reset_stream(2)
    # The training half of utils/checkpoint.py is ported (tests/test_torch_train.py):
    # a directory that holds no checkpoint has no latest step and none to load.
    assert checkpoint.latest_step("x") is None
    with pytest.raises(FileNotFoundError):
        checkpoint.load_train_state("x", net, torch.optim.Adam(net.parameters()), 0)


def test_tick_stats_counters(base):
    stats = base["server"].tick_stats()
    n = len(base["ticks"])
    assert stats["ticks"] == stats["window"] == n and stats["budget_ms"] == 500.0 and stats["streams"] == N_STREAMS
    assert 0 < stats["p50_ms"] <= stats["p95_ms"] <= stats["max_ms"] and stats["over_budget"] >= 0


# ---------------------------------------------------------------------------
# chunk_step(run_fsm=False) and AudioPipeline checkpoints
# ---------------------------------------------------------------------------


def test_chunk_step_without_fsm_feeds_the_host_decoder(pair, fleet):
    """run_fsm=False: no windows, the FSM carry untouched, and its window
    inputs decoded on the host equal the scan's own outputs bit for bit."""
    net = pair[1]
    st = vad.statics_from_config(_cfg().vad_config)
    x = torch.from_numpy(np.stack([a[:, :CHUNK] for a in fleet[1]]))
    carry = vad.init_carry(st, (N_STREAMS,))
    with torch.inference_mode():
        new, out = vad.chunk_step(net, st, carry, x, run_fsm=False)
        _, want = vad.chunk_step(net, st, carry, x)
    assert out.windows is None and new["fsm"] is None
    got, _ = fsm_host.scan_windows_host(st.fsm_shape, st.fsm_params, out.min_vol.numpy(), out.ratios.numpy(),
                                        out.window_valid.numpy(), win_base=out.win_indices[:, 0].numpy())
    for f, g, w in zip(WINDOW_FIELDS, got, want.windows):
        assert g.tobytes() == w.numpy().tobytes(), f


def test_seeded_fresh_carry_is_a_fresh_scan(fleet):
    """fsm_cuda.seeded_fresh_carry continues exactly as a fresh scan starts,
    and equals the host decoder's fresh carry."""
    st = vad.statics_from_config(_cfg().vad_config)
    seeded = fsm_cuda.seeded_fresh_carry(st.fsm_shape, st.fsm_params, 3, "cpu")
    host = fsm_host.fresh_host_carry(st.fsm_shape, st.fsm_params, 3)
    assert seeded["kahan"].abs().sum() > 0
    for k, v in host.items():
        assert seeded[k].numpy().tobytes() == v.tobytes(), k
    rng = np.random.default_rng(1)
    mv = torch.from_numpy(rng.random((3, 24), dtype=np.float32))
    va = torch.ones((3, 24), dtype=torch.bool)
    a = fsm_cuda.scan_windows_reference(st.fsm_shape, st.fsm_params, mv, mv, va)
    b = fsm_cuda.scan_windows_reference(st.fsm_shape, st.fsm_params, mv, mv, va, seeded)
    for x, y in zip(a[0], b[0]):
        assert x.numpy().tobytes() == y.numpy().tobytes()


@pytest.fixture(scope="module")
def solo_run(pair, fleet):
    """Stream 0 through one AudioPipeline, uninterrupted: its segments and recordings."""
    recs, cbs = _collectors(1)
    pipe = AudioPipeline(_cfg(), pair[1], cbs[0], device="cpu")
    pipe.push_samples(fleet[1][0])
    return pipe.segments, recs


@pytest.mark.parametrize("at", [0, 3], ids=["before_the_first_chunk", "mid_recording"])
def test_pipeline_checkpoint_resumes_the_uninterrupted_run(pair, fleet, solo_run, tmp_path, at):
    """AudioPipeline.save_state at a chunk edge (before any step: the fresh
    seeded FSM carry; or while a recording is in flight), loaded into a new
    pipeline and continued: segments and recordings equal the uninterrupted
    run's."""
    net = pair[1]
    audio = fleet[1][0]
    ref_segments, ref_recs = solo_run
    r1, cb1 = _collectors(1)
    p1 = AudioPipeline(_cfg(), net, cb1[0], device="cpu")
    p1.push_samples(audio[:, : at * CHUNK + 777])  # a sub-chunk tail rides in the ring
    if at:
        assert p1.original_recorder.recording
    p1.save_state(str(tmp_path / "p.npz"))
    r2, cb2 = _collectors(1)
    p2 = AudioPipeline(_cfg(), net, cb2[0], device="cpu")
    p2.load_state(str(tmp_path / "p.npz"))
    assert not p2._chained
    p2.push_samples(audio[:, at * CHUNK + 777 :])
    assert p1.segments + p2.segments == ref_segments and ref_segments
    for kind in ("original", "denoised"):
        assert r1[kind][0] + r2[kind][0] == ref_recs[kind][0]


def test_load_carry_checks_the_template(tmp_path):
    path = str(tmp_path / "c.npz")
    carry = {"a": torch.zeros((2, 3)), "n": np.int64(2**40), "sub": {"b": torch.ones(4, dtype=torch.int32), "none": None}}
    checkpoint.save_carry(path, carry)
    got = checkpoint.load_carry(path, carry)
    assert int(got["n"]) == 2**40 and got["n"].dtype == np.int64 and got["sub"]["none"] is None
    assert torch.equal(got["sub"]["b"], carry["sub"]["b"]) and got["a"].device == carry["a"].device
    for bad in (
        {**carry, "a": torch.zeros((2, 4))},
        {**carry, "a": torch.zeros((2, 3), dtype=torch.float64)},
        {**carry, "sub": {"b": torch.ones(4, dtype=torch.int32), "none": torch.zeros(1)}},
        {**carry, "extra": torch.zeros(1)},
    ):
        with pytest.raises(ValueError):
            checkpoint.load_carry(path, bad)
    np.savez(str(tmp_path / "plain.npz"), a=np.zeros(3))
    with pytest.raises(ValueError, match="not a carry"):
        checkpoint.load_carry(str(tmp_path / "plain.npz"), carry)
    (tmp_path / "junk.npz").write_bytes(b"not an npz checkpoint")
    with pytest.raises(ValueError):
        checkpoint.load_carry(str(tmp_path / "junk.npz"), carry)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------


UUID_VALID = [
    "d0cd8041-0504-40cb-ac8e-d05960d205ec",
    "3df6f0e4-f9b1-4e34-ad70-33206069b995",
    "f982cf56-c4ab-4229-b23c-d17377d000be",
    "6b9f53be-cf46-40e8-8627-6b60dc33def8",
    "c282ec76-ac18-4d4a-8a29-3b94f5c74813",
    "00000000-0000-0000-0000-000000000000",
]
UUID_INVALID = [
    "3df6f0e4-f9b1-4e34-ad70-33206069b99",  # too short
    "3df6f0e4-f9b1-4e34-ad70-33206069b9912",  # too long
    "3df6f0e4-f9b1-4e34-ad70_33206069b9912",  # bad separator
    "zdf6f0e4-f9b1-4e34-ad70-33206069b995",  # invalid character
    "{d0cd8041-0504-40cb-ac8e-d05960d205ec}",  # lenient forms stdlib uuid accepts
    "d0cd8041050440cbac8ed05960d205ec0000",
]


def test_uuid_reference_vectors():
    """The reference's parse/format vectors (tests/test_utils_and_lowlatency.py)."""
    for text in UUID_VALID:
        assert fvad_uuid.format(fvad_uuid.parse(text)) == text
    for text in UUID_INVALID:
        with pytest.raises(fvad_uuid.InvalidUUID):
            fvad_uuid.parse(text)
    u = fvad_uuid.new_v4()
    assert fvad_uuid.format(fvad_uuid.parse(u)) == u
    assert fvad_uuid.format(fvad_uuid.zero) == "0" * 8 + "-0000" * 3 + "-" + "0" * 12


def test_profiling_spans_and_trace(tmp_path):
    p = profiling.Profiler()
    for _ in range(2):
        with p.span("stage_a"):
            pass
    assert p.counts["stage_a"] == 2 and "stage_a" in p.report()
    assert profiling.realtime_factor(100.0, 0.01) == pytest.approx(10000.0)
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    (trace_file,) = (tmp_path / "trace").iterdir()
    assert "traceEvents" in json.loads(trace_file.read_text())
