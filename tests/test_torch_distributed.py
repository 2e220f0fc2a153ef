"""Real multi-process runs of the port's data mesh on the CPU (the
counterpart of ``tests/test_distributed.py``): 2 and 4 OS processes, each
with 2 CPU shards, join one gloo group through ``parallel.mesh.
maybe_init_distributed``'s environment, each running
``python -m formula_vad_tpu_torch.testing.distributed`` (``BatchRunner``
over the global mesh on ``tests/distributed_corpus.make_batch()``).
Each must report the mesh's size and segments identical to each other's, to
the port's one-process run and to the JAX ``BatchRunner``'s over its 8
virtual devices, computed here (each segment's channel-volume ratio held at
rtol 1e-6 against the JAX package, ROADMAP §3 fault 1). The host decoder
across processes raises in the workers, as the JAX runner's does.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from distributed_corpus import machine_config, make_batch
from test_torch_nsnet2 import _flat

from formula_vad_tpu.config import VADConfig as JVADConfig
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.parallel.runner import BatchRunner as JBatchRunner
from formula_vad_tpu_torch.config import VADConfig
from formula_vad_tpu_torch.models import nsnet2
from formula_vad_tpu_torch.parallel import mesh as mesh_lib
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.testing import distributed as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATIO_RTOL = 1e-6
# A worker takes ~10-20 s on a loaded CPU; one that hangs is killed well before the suite's limit.
WORKER_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX workers' weights (init_params(PRNGKey(21))) as the port's
    ``.npz``, and the JAX runner's and the port's one-process segments."""
    jp = jnsnet2.init_params(jax.random.PRNGKey(21))
    net = nsnet2.from_numpy(_flat(jp))
    path = str(tmp_path_factory.mktemp("weights") / "w.npz")
    nsnet2.save_npz(path, net)
    batch, lengths = make_batch()
    jax_segments = [r.segments for r in JBatchRunner(jp, JVADConfig(vad_machine_config=machine_config())).run(batch, lengths)]
    cfg = VADConfig(vad_machine_config=worker.machine_config())
    port_segments = [r.segments for r in BatchRunner(net, cfg, use_mesh=False).run(batch, lengths)]
    return path, jax_segments, port_segments


def _spawn(tmp_path, n_processes: int, extra: list[str]) -> tuple[list, list[str]]:
    """Run ``n_processes`` workers; -> (their exit codes, their logs).
    Every worker is killed if one outlives its time limit."""
    port = _free_port()
    procs = []
    for rank in range(n_processes):
        env = dict(
            os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(n_processes),
            PROCESS_ID=str(rank), LOCAL_DEVICES="2", OMP_NUM_THREADS="2", PYTHONPATH=REPO,
        )
        cmd = [sys.executable, "-m", "formula_vad_tpu_torch.testing.distributed", str(tmp_path / f"w{rank}.json")]
        procs.append(subprocess.Popen(cmd + extra, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def _same_as_jax(got, want):
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws), (gs, ws)
        for g, w in zip(gs, ws):
            exact = ("sample_from", "sample_to", "vad_met_sec")
            assert {k: g[k] for k in exact} == {k: w[k] for k in exact}
            assert g["avg_channel_vol_ratio"] == pytest.approx(w["avg_channel_vol_ratio"], rel=RATIO_RTOL)


def test_worker_corpus_is_the_tests_corpus():
    got, want = worker.make_batch(), make_batch()
    assert got[1] == want[1] and got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert worker.machine_config().long_term_speech_avg_sec == machine_config().long_term_speech_avg_sec


@pytest.mark.parametrize("n_processes", [2, 4])
def test_processes_match_one(tmp_path, weights, n_processes):
    path, jax_segments, port_segments = weights
    rcs, logs = _spawn(tmp_path, n_processes, ["--device", "cpu", "--weights", path])
    for rc, log in zip(rcs, logs):
        assert rc == 0, f"worker failed:\n{log[-4000:]}"
    payloads = [json.loads((tmp_path / f"w{rank}.json").read_text()) for rank in range(n_processes)]
    assert [p["rank"] for p in payloads] == list(range(n_processes))
    for p in payloads:
        assert p["n_processes"] == n_processes and p["mesh_size"] == 2 * n_processes
        assert p["devices"] == ["cpu", "cpu"]
        assert p["segments"] == payloads[0]["segments"]
    assert payloads[0]["segments"] == port_segments
    _same_as_jax(payloads[0]["segments"], jax_segments)
    assert any(port_segments), "the corpus must give segments"


def test_host_decoder_across_processes_raises(tmp_path, weights):
    rcs, logs = _spawn(tmp_path, 2, ["--device", "cpu", "--weights", weights[0], "--host-fsm"])
    for rc, log in zip(rcs, logs):
        assert rc != 0
        assert "ValueError: use_host_fsm requires a single process" in log, log[-4000:]


def test_worker_defaults_to_the_card(tmp_path, monkeypatch):
    # Without --device the worker runs on the card, and without one it raises
    # before it joins a group, as every entry point of the port does.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        worker.main([str(tmp_path / "w.json")])
    assert not (tmp_path / "w.json").exists()


@pytest.mark.parametrize("addr, ifname", [("127.0.0.1:29500", "lo"), ("localhost:29500", "lo"), ("10.1.2.3:29500", None)])
def test_maybe_init_distributed_reads_the_jax_variables(monkeypatch, addr, ifname):
    # The JAX package's three variables name the gloo group; a coordinator on
    # the loopback keeps gloo's connections on the loopback interface.
    calls = []
    monkeypatch.setattr(mesh_lib.dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.delenv("GLOO_SOCKET_IFNAME", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert not mesh_lib.maybe_init_distributed() and not calls
    monkeypatch.setenv("COORDINATOR_ADDRESS", addr)
    monkeypatch.setenv("NUM_PROCESSES", "3")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert mesh_lib.maybe_init_distributed()
    assert calls == [(("gloo",), dict(init_method=f"tcp://{addr}", world_size=3, rank=2, timeout=mesh_lib.TIMEOUT))]
    assert os.environ.get("GLOO_SOCKET_IFNAME") == ifname
