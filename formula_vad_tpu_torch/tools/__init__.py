"""Measurement drivers for the port on one GPU (``python -m
formula_vad_tpu_torch.tools.<name> --help``), and the timing helpers they
share with ``chip_smoke.py``."""

from __future__ import annotations

import statistics
import subprocess


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them: every
    time taken on the card is kept beside this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` CUDA-event-timed calls of ``fn``, after one
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in one
    CUDA graph, whose replay is timed as ``cuda_ms`` times a call, divided by
    ``launches``. The host's cost of each launch stays out of the number."""
    import torch

    fn()  # outside the capture: builds, allocator pools, library handles
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches
