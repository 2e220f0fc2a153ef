"""The worker of the multi-process checks (the counterpart of
``tests/distributed_worker.py``).

Start one copy a process, each with the JAX package's variables set:

    COORDINATOR_ADDRESS=127.0.0.1:PORT NUM_PROCESSES=N PROCESS_ID=i \\
        python -m formula_vad_tpu_torch.testing.distributed OUT.json \\
        [--device cuda|cpu] [--weights demo|random|W.npz] [--corpus batch|slice] [--host-fsm]

Each process joins the group through ``parallel.mesh.maybe_init_distributed``
(gloo), shards itself ``LOCAL_DEVICES`` times (default 2) on ``--device``
(default the card, raising without one; on ``cuda`` the shards go round the
visible cards, ``cpu`` only when asked for), scores the corpus with ``BatchRunner``
over the resulting data mesh and writes ``{rank, n_processes, mesh_size,
segments, launches, wall_s}`` to OUT.json: ``launches`` are kernels 1 and
2's launches in the timed run, ``wall_s`` that run's wall (on the card a
first, untimed run builds what a run needs). ``--corpus batch`` is
``tests/distributed_corpus.py``'s 4 ragged streams (its numpy copy: that
file imports the JAX package's config), ``slice`` the smoke script's 21
streams x 20 s (``slice_batch``, which ``chip_smoke.py`` also scores). ``--host-fsm`` asks for the host decoder, which the runner
refuses across processes: the worker then exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch import distributed as dist

from .. import device as device_mod
from ..config import VADConfig, VADMachineConfig
from ..models import nsnet2_cuda
from ..models.registry import load_denoiser
from ..parallel import mesh as mesh_lib
from ..parallel.runner import BatchRunner
from ..pipeline import fsm_cuda
from .synth import synth_stream

CHUNK = 24000
SLICE_STREAMS, SLICE_SECONDS = 21, 20.0


def machine_config() -> VADMachineConfig:
    return VADMachineConfig(long_term_speech_avg_sec=10.0)


def make_batch() -> tuple[np.ndarray, list[int]]:
    """4 ragged streams (one with no speech, one short) -> padded [4, 2, T]
    float32 + true lengths (``tests/distributed_corpus.py::make_batch``)."""
    rng = np.random.default_rng(424242)
    n_chunks = 12
    t_total = n_chunks * CHUNK
    t = np.arange(t_total) / 48000.0
    streams = []
    lengths = []
    burst_plans = [
        [(1.0, 2.0)],
        [],
        [(0.5, 1.5), (2.6, 0.9)],
        [(0.8, 1.2)],
    ]
    for i, bursts in enumerate(burst_plans):
        audio = (0.003 * rng.standard_normal((2, t_total))).astype(np.float32)
        env = np.zeros(t_total)
        for a, d in bursts:
            env[int(a * 48000) : int((a + d) * 48000)] = 1.0
        speech = (
            0.25 * np.sin(2 * np.pi * (700 + 50 * i) * t)
            + 0.15 * np.sin(2 * np.pi * 1300 * t)
        ) * env
        audio += np.stack([speech, 0.9 * speech]).astype(np.float32)
        streams.append(audio)
        lengths.append(t_total if i != 3 else 9 * CHUNK + 1234)
    return np.stack(streams), lengths


def slice_batch() -> tuple[np.ndarray, list[int]]:
    """The slice: 21 streams x 20 s of ``synth_stream`` (numpy seed 1). ``chip_smoke.py``
    scores this same corpus in its phases 4 and 18, and holds the workers' segments to it."""
    rng = np.random.default_rng(1)
    audio = np.stack([synth_stream(rng, SLICE_SECONDS)[0] for _ in range(SLICE_STREAMS)])
    return audio, [audio.shape[-1]] * SLICE_STREAMS


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--device", choices=device_mod.DEVICES, default="cuda",
                    help="Where each shard runs (default: the card; raises without one)")
    ap.add_argument("--weights", default="demo")
    ap.add_argument("--corpus", choices=("batch", "slice"), default="batch")
    ap.add_argument("--host-fsm", action="store_true")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)  # raises without a card before joining; float32 products in full float32
    if not mesh_lib.maybe_init_distributed():
        raise SystemExit("COORDINATOR_ADDRESS must be set for this worker")
    try:
        n_local = int(os.environ.get("LOCAL_DEVICES", "2"))
        rank = dist.get_rank()
        if args.device == "cuda":
            n_cards = torch.cuda.device_count()
            devices = [f"cuda:{(rank * n_local + i) % n_cards}" for i in range(n_local)]
        else:
            devices = ["cpu"] * n_local
        mesh = mesh_lib.data_mesh(devices)
        net = load_denoiser(args.weights, device=mesh.devices[0])
        vad_config = VADConfig(vad_machine_config=machine_config()) if args.corpus == "batch" else VADConfig()
        runner = BatchRunner(net, vad_config, mesh=mesh, use_host_fsm=args.host_fsm)
        audio, lengths = make_batch() if args.corpus == "batch" else slice_batch()
        if args.device == "cuda":
            runner.run(audio, lengths)  # builds and caches what a run needs
        counters = {"gru_stack": nsnet2_cuda.gru_stack, "scan_windows": fsm_cuda.scan_windows}
        for fn in counters.values():
            fn.launches = 0
        dist.barrier()
        t0 = time.perf_counter()
        results = runner.run(audio, lengths)
        if args.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        payload = {
            "rank": rank,
            "n_processes": dist.get_world_size(),
            "mesh_size": mesh.size,
            "devices": [str(d) for d in mesh.devices],
            "segments": [r.segments for r in results],
            "launches": {name: fn.launches for name, fn in counters.items()},
            "wall_s": wall,
        }
        with open(args.out, "w") as f:
            json.dump(payload, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
