"""The low-latency mode's scale curve on one GPU: per-hop latency against the
number of streams (port of ``benchmarks/lowlatency_scale.py``).

    python -m formula_vad_tpu_torch.tools.lowlatency_scale
    LL_BS=64,256,1024,4096 LL_ITERS=60, FVAD_PRECISION=default for the bf16 tier

``pipeline/lowlatency.py`` denoises 10 ms hops with a carried GRU state
(algorithmic latency one hop plus one hop of overlap-add lookahead, against
the chunk path's 500 ms). For B streams x 2 channels this times chained
``step`` calls, each consuming the state the previous one returned, so no
two steps overlap: CUDA events around n_short and n_long steps, and the
slope between the two is the per-hop latency, the fixed cost of the first
launch and the final synchronisation cancelling. A hop fits the real-time
budget when it takes under 10 ms; ``streams_ceiling`` is B x 10 ms over
the per-hop latency. Random-init weights (seed 0), 0.02 N(0, 1) audio, two
hops alternating. It needs the card.
"""

from __future__ import annotations

import os

import torch

from .. import device as device_mod
from ..models.registry import load_denoiser
from ..ops import precision
from ..pipeline import lowlatency
from . import card

N_CH = 2
HOP48 = 480
BUDGET_MS = 10.0


def slope_ms(run, n_long: int, n_short: int | None = None) -> float:
    """Per-step ms from ``run(n) -> ms for n chained steps``, as the JAX
    benchmark's ``slope_from_run``: the slope between n_short (default
    n_long / 4) and n_long steps, retried up to three times while it lies
    outside 0.3 to 3 times the long run's mean, then that mean."""
    if n_short is None:
        n_short = max(1, n_long // 4)
    mean = None
    for _ in range(3):
        t_short, t_long = run(n_short), run(n_long)
        slope = (t_long - t_short) / (n_long - n_short)
        mean = t_long / n_long
        if 0.3 * mean <= slope <= 3.0 * mean:
            return slope
    return mean


def measure(net, b: int, iters: int = 60) -> dict:
    """Per-hop latency of chained ``lowlatency.step`` at ``b`` streams x 2
    channels on the net's card -> {"b", "ms_per_hop", "fits_10ms",
    "streams_ceiling"}."""
    dev = device_mod.model_device(net)
    gen = torch.Generator(device=dev).manual_seed(b)
    hops = [0.02 * torch.randn((b, N_CH, HOP48), generator=gen, device=dev) for _ in range(2)]
    with torch.inference_mode():
        state0, _ = lowlatency.step(net, lowlatency.init_state((b, N_CH), dev), hops[0])  # builds, warms up
        torch.cuda.synchronize(dev)

        def run(n: int) -> float:
            state = state0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                state, out = lowlatency.step(net, state, hops[i % 2])
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end)

        ms = slope_ms(run, iters)
    return {"b": b, "ms_per_hop": ms, "fits_10ms": ms < BUDGET_MS, "streams_ceiling": int(b * BUDGET_MS / ms)}


def main() -> int:
    dev = device_mod.resolve("cuda")
    bs = tuple(int(x) for x in os.environ.get("LL_BS", "64,256,1024,4096").split(","))
    iters = int(os.environ.get("LL_ITERS", "60"))
    net = load_denoiser("random", device=dev)
    print(f"lowlatency_scale on {card()}; precision={precision.matmul_precision('gru_h')}", flush=True)
    print(f"{'B':>6} {'ms/hop':>8} {'<10ms':>6} {'ceiling':>8}", flush=True)
    for b in bs:
        try:
            r = measure(net, b, iters)
        except torch.cuda.OutOfMemoryError:
            print(f"{b:>6}  memory ceiling", flush=True)
            break
        print(f"{r['b']:>6} {r['ms_per_hop']:>8.3f} {str(r['fits_10ms']):>6} {r['streams_ceiling']:>8}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
