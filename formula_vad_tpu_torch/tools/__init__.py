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


def cudnn_gru(net, dev, dtype=None):
    """The library yardstick for the GRU kernels: a two-layer torch.nn.GRU
    run by cuDNN on the same weights, permuted from ONNX z|r|n to PyTorch's
    r|z|n gate order (both are the linear-before-reset form), in float32 or
    ``dtype``. It also computes layer 1's input projection, so it takes the
    fc_in output. Only the measurement scripts call it."""
    import torch

    from ..models.nsnet2 import HIDDEN

    gru = torch.nn.GRU(HIDDEN, HIDDEN, num_layers=2, batch_first=True, device=dev, dtype=dtype)
    h = torch.arange(HIDDEN, device=dev)
    perm = torch.cat([h + HIDDEN, h, h + 2 * HIDDEN])
    with torch.no_grad():
        for layer, g in enumerate((net.gru1, net.gru2)):
            getattr(gru, f"weight_ih_l{layer}").copy_(g.wi.t()[perm])
            getattr(gru, f"weight_hh_l{layer}").copy_(g.wh.t()[perm])
            getattr(gru, f"bias_ih_l{layer}").copy_(g.bi[perm])
            getattr(gru, f"bias_hh_l{layer}").copy_(g.bh[perm])
    gru.flatten_parameters()
    return gru


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


def queued_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls queued back to
    back between two CUDA events, divided by ``calls``. Where the host's
    work per call is shorter than the kernel, the queue stays full and the
    host's cost stays out (but for the first call's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


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



def host_us(fns, calls: int = 20, rounds: int = 7) -> list[float]:
    """Host time of one call of each of ``fns`` in µs: after one warm-up
    call each, ``rounds`` rounds of ``calls`` calls on the host clock, with
    no synchronisation inside a round (the device works through the queue
    meanwhile), the functions in turns (the order reversed every other
    round); the median round over ``calls``."""
    import time

    import torch

    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for rep in range(rounds):
        for i in range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[i]()
            times[i].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return [statistics.median(t) for t in times]


def busy_ms(events) -> tuple[float, float, float]:
    """The union of the device intervals of profiler ``events`` (those with
    ``device_type`` CUDA), of the kernels only (copies and memsets left
    out), and of the copies only, in ms."""

    def union(spans):
        total, end = 0.0, -float("inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3

    def spans(keep):
        return [(e.time_range.start, e.time_range.end) for e in events if keep(e.name.lower())]

    return (
        union(spans(lambda name: True)),
        union(spans(lambda name: not name.startswith(("memcpy", "memset")))),
        union(spans(lambda name: name.startswith("memcpy"))),
    )
