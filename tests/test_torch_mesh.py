"""The data mesh on the CPU, in one process: ``parallel/mesh.py``'s helpers
against the JAX package's, and ``BatchRunner``, ``SlabRunner`` and
``OnlineBatchServer`` sharded over 2 and 4 CPU shards against the port's
unsharded runs and the JAX package's runs on conftest's 8 virtual CPU
devices (as the JAX mesh tests run them), on those tests' own corpora:
``tests/test_pod_scale.py``'s 16 streams, 3 ragged streams of
``tests/distributed_corpus.py`` (on 4 shards one shard is all padding),
``tests/test_flat_overlap.py::test_slab_runner_flat_mesh``'s 8 streams and
``tests/test_online_server.py``'s ``speechy`` fleet.

Bars: segments identical; against the JAX package each one's channel-volume
ratio at rtol 1e-6 (ROADMAP §3 fault 1: XLA:CPU picks the order of a
float32 reduction over a chunk, the port sums in float64). Between the
server's sharded and unsharded runs every decision and index bit for bit
and the float outputs within 1e-5: the plain versions' GEMMs round a row
by the batch's row count (ROADMAP §3 fault 7), and a shard has other row
counts than the fleet.
"""

import jax
import numpy as np
import pytest
import torch
from distributed_corpus import make_batch
from test_online_server import speechy
from test_torch_nsnet2 import _flat

from formula_vad_tpu.config import PipelineConfig as JPipelineConfig
from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.config import VADMachineConfig as JVADMachineConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.parallel import mesh as jmesh
from formula_vad_tpu.parallel.online import OnlineBatchServer as JOnlineBatchServer
from formula_vad_tpu.parallel.runner import BatchRunner as JBatchRunner
from formula_vad_tpu.parallel.slab_runner import SlabRunner as JSlabRunner
from formula_vad_tpu_torch.config import PipelineConfig, VADConfig, VADMachineConfig
from formula_vad_tpu_torch.models import nsnet2
from formula_vad_tpu_torch.parallel import mesh as mesh_lib
from formula_vad_tpu_torch.parallel.online import OnlineBatchServer
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.parallel.slab_runner import SlabRunner
from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline

CHUNK = 24000
MACHINE = dict(long_term_speech_avg_sec=10.0)
# K = 2 alternative machines beside the primary.
ALTS = (dict(MACHINE, speech_threshold_factor=6.0), dict(MACHINE, speech_threshold_factor=14.0, channel_vol_ratio_threshold=0.4))
FLOAT_TOL = 1e-5
RATIO_RTOL = 1e-6
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Many small tensor ops a shard, for which more intra-op threads only
    add overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(k: int) -> mesh_lib.DataMesh:
    return mesh_lib.data_mesh(["cpu"] * k)


# ---------------------------------------------------------------------------
# The helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pad_batch_matches_jax(k):
    want = jmesh.data_mesh(jax.devices()[:k])
    got = _cpu_mesh(k)
    assert got.size == k
    assert [mesh_lib.pad_batch(n, got) for n in range(20)] == [jmesh.pad_batch(n, want) for n in range(20)]


@pytest.mark.parametrize("k, n_processes", [(2, 1), (4, 1), (8, 1), (2, 2), (2, 4), (1, 8)])
def test_local_shards_match_batch_sharding(k, n_processes):
    """Each process's (device, rows) pairs are the rows JAX's batch
    sharding puts on that process's devices of a global mesh ordered
    process-major: the JAX mesh of k * n_processes devices, process p
    holding devices p*k .. p*k + k - 1."""
    n = k * n_processes
    jm = jmesh.data_mesh(jax.devices()[:n])
    for b_pad in (n, 3 * n):
        arr = jax.device_put(np.arange(b_pad), jmesh.batch_sharding(jm))
        rows_of = {s.device: s.index[0] for s in arr.addressable_shards}
        want = [(rows_of[d].start or 0, rows_of[d].stop or b_pad) for d in jm.devices.flat]
        got = []
        for rank in range(n_processes):
            mesh = mesh_lib.DataMesh((CPU,) * k, n_processes, rank)
            got += [(r.start, r.stop) for _, r in mesh_lib.local_shards(mesh, b_pad)]
        assert got == want
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.local_shards(mesh_lib.DataMesh((CPU,) * k, n_processes), n + 1)


@pytest.mark.parametrize("n_model", [1, 2, 3, 8])
def test_data_model_mesh_matches_jax(n_model):
    """The grid's shape, and the JAX function's ValueError where the device
    count does not divide by the model axis."""
    devices = ["cpu"] * 8
    if 8 % n_model:
        with pytest.raises(ValueError) as want:
            jmesh.data_model_mesh(n_model)
        with pytest.raises(ValueError, match=str(want.value)):
            mesh_lib.data_model_mesh(n_model, devices)
        return
    assert mesh_lib.data_model_mesh(n_model, devices).shape == dict(jmesh.data_model_mesh(n_model).shape)


def test_mesh_devices_and_copies():
    """data_mesh() shards over the visible cards and has no CPU fallback;
    the CPU only when asked for; one process's gather is the identity; a
    model's copy on another device leaves the kernels' caches behind."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is visible"):
            mesh_lib.data_mesh()
    mesh = _cpu_mesh(2)
    assert mesh.devices == (CPU, CPU) and (mesh.n_processes, mesh.rank) == (1, 0)
    assert mesh_lib.default_mesh(None, True, CPU) == mesh_lib.local_mesh(CPU) == _cpu_mesh(1)
    arrays = [np.arange(6).reshape(3, 2), np.ones(3, bool)]
    assert all(a is b for a, b in zip(mesh_lib.gather_rows([arrays], mesh), arrays))
    halves = mesh_lib.gather_rows([[a[:2] for a in arrays], [a[2:] for a in arrays]], mesh)
    assert all(np.array_equal(a, b) for a, b in zip(halves, arrays))

    net = nsnet2.from_numpy(_flat(jnsnet2.init_params(jax.random.PRNGKey(0))))
    net._gru_stack_cache = ("key", {"levels": torch.zeros(3)})
    net._gates_cache = {}
    assert mesh_lib.replicate(net, mesh) == {CPU: net}
    meta = torch.device("meta")
    copies = mesh_lib.replicate(net, mesh_lib.DataMesh((CPU, meta, meta)))
    assert list(copies) == [CPU, meta] and copies[CPU] is net
    twin = copies[meta]
    assert all(p.device == meta for p in twin.parameters())
    assert not any(k.endswith("_cache") for m in twin.modules() for k in vars(m))
    assert "_gru_stack_cache" in vars(net) and "_gates_cache" in vars(net)


# ---------------------------------------------------------------------------
# BatchRunner
# ---------------------------------------------------------------------------


def _pod16():
    """tests/test_pod_scale.py's 16 streams (half with a burst), its weights."""
    rng = np.random.default_rng(0)
    b, t = 16, 16 * CHUNK
    tt = np.arange(t) / 48000.0
    batch = (0.003 * rng.standard_normal((b, 2, t))).astype(np.float32)
    for i in range(0, b, 2):
        sl = slice(int(1.0 * 48000), int(2.5 * 48000))
        burst = (0.3 * np.sin(2 * np.pi * (700 + 10 * i) * tt[sl])).astype(np.float32)
        batch[i, 0, sl] += burst
        batch[i, 1, sl] += 0.9 * burst
    return jax.random.PRNGKey(0), batch, None


def _ragged3():
    """3 of tests/distributed_corpus.py's streams, the last one short, its weights."""
    batch, lengths = make_batch()
    return jax.random.PRNGKey(21), batch[[0, 2, 3]], [lengths[i] for i in (0, 2, 3)]


CORPORA = {"pod16": _pod16, "ragged3": _ragged3}


def _configs(alts: bool):
    alt = ALTS if alts else ()
    return (
        JVADConfig(vad_machine_config=JVADMachineConfig(**MACHINE),
                   alt_vad_machine_configs=[JVADMachineConfig(**a) for a in alt] or None),
        VADConfig(vad_machine_config=VADMachineConfig(**MACHINE),
                  alt_vad_machine_configs=[VADMachineConfig(**a) for a in alt] or None),
    )


def _segments(results):
    return [(r.segments, r.alt_segments) for r in results]


def _same_as_jax(got: list, want: list) -> None:
    """Segment lists (nested in lists and tuples) equal but for each
    segment's channel-volume ratio, held at RATIO_RTOL."""
    if isinstance(got, dict):
        exact = ("sample_from", "sample_to", "vad_met_sec")
        assert {k: got[k] for k in exact} == {k: want[k] for k in exact}
        assert got["avg_channel_vol_ratio"] == pytest.approx(want["avg_channel_vol_ratio"], rel=RATIO_RTOL)
        return
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        _same_as_jax(g, w)


@pytest.fixture(scope="module")
def corpus_runs():
    """(corpus, alternative machines) -> (the port's net, audio, lengths,
    the JAX BatchRunner's segments over its 8-device mesh), made once."""
    cache = {}

    def get(name: str, alts: bool):
        if (name, alts) not in cache:
            key, audio, lengths = CORPORA[name]()
            jp = jnsnet2.init_params(key)
            jcfg, _ = _configs(alts)
            want = _segments(JBatchRunner(jp, jcfg).run(audio, lengths))
            if not alts:
                want = [(s, []) for s, _ in want]
            cache[name, alts] = nsnet2.from_numpy(_flat(jp)), audio, lengths, want
        return cache[name, alts]

    return get


@pytest.fixture(scope="module")
def unsharded_runs(corpus_runs):
    """(corpus, path) -> the port's unsharded run's segments, made once."""
    cache = {}

    def get(name: str, path: str):
        if (name, path) not in cache:
            net, audio, lengths, _ = corpus_runs(name, path == "alt2")
            runner = BatchRunner(net, _configs(path == "alt2")[1], use_mesh=False, use_offline=path != "stream")
            assert runner.mesh == mesh_lib.local_mesh(CPU)
            cache[name, path] = _segments(runner.run(audio, lengths))
        return cache[name, path]

    return get


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name, path", [(n, p) for n in CORPORA for p in ("fsm", "stream", "alt2")])
def test_batch_runner_sharded(corpus_runs, unsharded_runs, name, path, k):
    """The device FSM, the streaming path and K = 2 alternative machines,
    sharded k ways: segments identical to the port's unsharded run and to
    the JAX BatchRunner's over its mesh."""
    net, audio, lengths, want = corpus_runs(name, path == "alt2")
    runner = BatchRunner(net, _configs(path == "alt2")[1], mesh=_cpu_mesh(k), use_offline=path != "stream")
    assert runner.nets == {CPU: net}
    got = _segments(runner.run(audio, lengths))
    assert len(got) == len(audio)
    assert got == unsharded_runs(name, path)
    _same_as_jax(got, want)
    assert any(s for s, _ in got)
    if path == "alt2":
        assert all(len(alt) == 2 for _, alt in got)


def test_batch_runner_host_decoder_sharded(corpus_runs):
    """The host decoder behind a sharded front end, in one process; across
    processes it raises, as the JAX runner does."""
    net, audio, lengths, want = corpus_runs("ragged3", False)
    cfg = _configs(False)[1]
    got = BatchRunner(net, cfg, mesh=_cpu_mesh(4), use_host_fsm=True).run(audio, lengths)
    _same_as_jax(_segments(got), want)
    two = BatchRunner(net, cfg, mesh=mesh_lib.DataMesh((CPU,), 2), use_host_fsm=True)
    with pytest.raises(ValueError, match="use_host_fsm requires a single process"):
        two.run(audio, lengths)


# ---------------------------------------------------------------------------
# SlabRunner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slab_case():
    """tests/test_flat_overlap.py::test_slab_runner_flat_mesh's 8 streams
    of 40 chunks (two 16 s slabs), the JAX SlabRunner's segments over its
    8-device mesh, and the port's unsharded run's."""
    rng = np.random.default_rng(7)
    b, t = 8, 40 * CHUNK
    tt = np.arange(t) / 48000.0
    batch = (0.003 * rng.standard_normal((b, 2, t))).astype(np.float32)
    for i in range(0, b, 2):
        sl = slice(int(1.0 * 48000), int(3.0 * 48000))
        burst = (0.3 * np.sin(2 * np.pi * (700 + 10 * i) * tt[sl])).astype(np.float32)
        batch[i, 0, sl] += burst
        batch[i, 1, sl] += 0.9 * burst
    jp = jnsnet2.init_params(jax.random.PRNGKey(0))
    jcfg, cfg = _configs(False)
    want = [r.segments for r in JSlabRunner(jp, jcfg, slab_chunks=32, use_pallas_fsm=False).run(batch)]
    net = nsnet2.from_numpy(_flat(jp))
    solo = [r.segments for r in SlabRunner(net, cfg, slab_chunks=32, use_mesh=False, use_host_fsm=True).run(batch)]
    return net, cfg, batch, want, solo


@pytest.mark.parametrize("fsm", ["device", "host"])
def test_slab_runner_sharded(slab_case, fsm):
    """Two shards, each with its own staging and carries: segments equal
    the unsharded run's and the JAX SlabRunner's over its mesh. With the
    host decoder also on ragged lengths, which end streams inside the
    second slab."""
    net, cfg, batch, want, solo = slab_case
    runner = SlabRunner(net, cfg, slab_chunks=32, mesh=_cpu_mesh(2), use_host_fsm=fsm == "host")
    got = [r.segments for r in runner.run(batch)]
    assert got == solo
    _same_as_jax(got, want)
    assert any(got)
    if fsm == "host":
        lengths = [batch.shape[-1] - (i * 37_123 if i % 3 else 0) for i in range(len(batch))]
        unsharded = SlabRunner(net, cfg, slab_chunks=32, use_mesh=False, use_host_fsm=True)
        assert [r.segments for r in runner.run(batch, lengths)] == [r.segments for r in unsharded.run(batch, lengths)]


# ---------------------------------------------------------------------------
# OnlineBatchServer
# ---------------------------------------------------------------------------


def _serve(server, audios, n_chunks):
    """Push every chunk; -> (segments, each tick's host outputs)."""
    ticks, run = [], server._run_step

    def step(c, v):
        out = run(c, v)
        ticks.append({k: x.copy() for k, x in out.items()})
        return out

    server._run_step = step
    for k in range(n_chunks):
        server.push(np.stack([a[:, k * CHUNK : (k + 1) * CHUNK] for a in audios]))
    return server.segments, ticks


def test_server_sharded_matches_solo():
    """tests/test_online_server.py::test_sharded_server_matches_solo on 2
    shards x microbatch 2: segments equal the solo pipelines' and the JAX
    sharded server's; every tick's decisions and indices bit for bit with
    the unsharded fleet's, its floats within 1e-5; a shard the mesh does
    not divide raises, as in the JAX server."""
    n_chunks = 12
    audios = [speechy(n_chunks, [(1.5, 1.5)], seed=10 + i) for i in range(8)]
    jp = jnsnet2.init_params(jax.random.PRNGKey(42))
    jcfg = JPipelineConfig(vad_config=JVADConfig(vad_machine_config=JVADMachineConfig(**MACHINE)))
    cfg = PipelineConfig(vad_config=VADConfig(vad_machine_config=VADMachineConfig(**MACHINE)))
    jserver = JOnlineBatchServer(jcfg, n_streams=8, params=jp, use_mesh=True)
    for k in range(n_chunks):
        jserver.push(np.stack([a[:, k * CHUNK : (k + 1) * CHUNK] for a in audios]))
    net = nsnet2.from_numpy(_flat(jp))
    solos = []
    for a in audios:
        p = AudioPipeline(cfg, net)
        p.push_samples(a)
        solos.append(p.segments)

    sharded = OnlineBatchServer(cfg, 8, params=net, use_mesh=True, mesh=_cpu_mesh(2), microbatch=2)
    assert sharded._devices == [CPU] * 4 and sharded._shard == 2
    got, got_ticks = _serve(sharded, audios, n_chunks)
    want, want_ticks = _serve(OnlineBatchServer(cfg, 8, params=net), audios, n_chunks)
    assert got == want == solos
    _same_as_jax(got, jserver.segments)
    assert any(solos)
    for g, w in zip(got_ticks, want_ticks):
        assert g.keys() == w.keys()
        for f, a in g.items():
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, w[f], rtol=0, atol=FLOAT_TOL, err_msg=f)
            else:
                assert a.tobytes() == w[f].tobytes(), f
    with pytest.raises(ValueError, match="divisible by the mesh's 2 devices"):
        OnlineBatchServer(cfg, 6, params=net, mesh=_cpu_mesh(2), microbatch=2)
    with pytest.raises(ValueError, match="divisible by the mesh's 8 devices") as jerr:
        JOnlineBatchServer(jcfg, n_streams=6, params=jp, use_mesh=True, microbatch=2)
    assert "microbatch shard 3" in str(jerr.value)
