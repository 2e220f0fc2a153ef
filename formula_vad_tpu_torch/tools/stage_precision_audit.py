"""Per-stage precision audit (port of ``benchmarks/stage_precision_audit.py``).

For each named product stage of the scoring path (``ops/precision.STAGES``)
it runs the FSM's inputs (``offline.window_inputs_batch``: min volume,
ratios, valid) at 'highest' with that stage alone at 'high' (bf16_3x) and
compares them with the all-'highest' baseline: bitwise equal, and the
largest relative deviation of the window volume. The stages that stay
bitwise form the composite ('parity_fast'), which is checked as a whole.
Then it times 'highest', the composite (if any) and all-'high',
interleaved. Under a ``gru_i`` or ``gru_h`` row the recurrence's two
product classes run at different levels: ``gru_stack_mixed`` (kernel B:
kernel 1's tiles, the class at 'high' on the tensor cores), and all-'high'
runs kernel A (``gru_gates_3x``); each row prints the recurrence's levels and, on the
card, the launches of each recurrence kernel.

    python -m formula_vad_tpu_torch.tools.stage_precision_audit [--device cpu]

Env: SPA_STREAMS (default 8), SPA_CHUNKS (default 20), SPA_REPS (default
3), SPA_WEIGHTS (default demo; random for the random-init weights). The
audio is 0.02 N(0, 1) from numpy seed 3 (the JAX tool draws it with
``jax.random``). Times are the slope between 3 and 12 calls, a median of
SPA_REPS rounds.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

from .. import device as device_mod
from ..config import VADConfig
from ..models import nsnet2_cuda, nsnet2_gates_cuda
from ..models.registry import load_denoiser
from ..ops import precision
from ..pipeline import offline, vad
from .lowlatency_scale import slope_ms

RECURRENCES = {
    "gru_stack": nsnet2_cuda.gru_stack,
    "gru_stack_mixed": nsnet2_cuda.gru_stack_mixed,
    "gru_gates_p": nsnet2_gates_cuda.gru_gates_p,
    "gru_gates_3x": nsnet2_gates_cuda.gru_gates_3x,
}


def _run(net, st, audio, level: str, overrides: dict):
    """window_inputs_batch at ``level`` with ``overrides`` -> (numpy outputs,
    {recurrence: launches}); the switches are restored."""
    before = {k: fn.launches for k, fn in RECURRENCES.items()}
    precision.set_matmul_precision(level)
    precision.set_stage_overrides(overrides)
    try:
        with torch.inference_mode():
            out = offline.window_inputs_batch(net, st, audio)
        got = tuple(x.cpu().numpy() for x in out)
        levels = precision.gru_levels()
    finally:
        precision.set_matmul_precision("highest")
        precision.set_stage_overrides(None)
    launched = {k: fn.launches - before[k] for k, fn in RECURRENCES.items() if fn.launches != before[k]}
    return got, levels, launched


def _timer(net, st, audio, level: str, overrides: dict):
    """run(n) -> ms of n calls of window_inputs_batch under the tier, the
    last output fetched."""

    def run(n: int) -> float:
        precision.set_matmul_precision(level)
        precision.set_stage_overrides(overrides)
        try:
            with torch.inference_mode():
                t0 = time.perf_counter()
                for _ in range(n):
                    out = offline.window_inputs_batch(net, st, audio)
                float(out[0].abs().max())
                return (time.perf_counter() - t0) * 1e3
        finally:
            precision.set_matmul_precision("highest")
            precision.set_stage_overrides(None)

    run(1)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    b = int(os.environ.get("SPA_STREAMS", "8"))
    n_chunks = int(os.environ.get("SPA_CHUNKS", "20"))
    reps = int(os.environ.get("SPA_REPS", "3"))
    weights = os.environ.get("SPA_WEIGHTS", "demo")
    net = load_denoiser("random" if weights == "random" else "demo", device=dev)
    st = vad.statics_from_config(VADConfig())
    audio = 0.02 * np.random.default_rng(3).standard_normal((b, 2, n_chunks * st.chunk_size))
    audio = torch.from_numpy(audio.astype(np.float32)).to(dev)

    print(f"platform={dev.type} B={b} chunks={n_chunks} weights={weights}")
    base, _, _ = _run(net, st, audio, "highest", {})
    bitwise = []
    for stage in precision.STAGES:
        got, levels, launched = _run(net, st, audio, "highest", {stage: "high"})
        eq = all(np.array_equal(g, w) for g, w in zip(got, base))
        rel = float(np.max(np.abs(got[0] - base[0]) / np.maximum(np.abs(base[0]), 1e-12)))
        if eq:
            bitwise.append(stage)
        print(f"stage {stage:6s}: bitwise={eq}  max_rel_mv={rel:.3e}  gru_i/gru_h={levels[0]}/{levels[1]}  "
              f"launches={launched}")

    variants = {"highest": ("highest", {})}
    if bitwise:
        composite = dict.fromkeys(bitwise, "high")
        got, _, _ = _run(net, st, audio, "highest", composite)
        eq = all(np.array_equal(g, w) for g, w in zip(got, base))
        print(f"composite parity-fast {bitwise}: bitwise={eq}")
        if eq:
            variants["parity_fast"] = ("highest", composite)
    _, levels, launched = _run(net, st, audio, "high", {})
    print(f"tier high: gru_i/gru_h={levels[0]}/{levels[1]}  launches={launched}")
    variants["high"] = ("high", {})

    timers = {k: _timer(net, st, audio, *v) for k, v in variants.items()}
    samples = {k: [] for k in variants}
    for _ in range(reps):
        for k, run in timers.items():
            samples[k].append(slope_ms(run, 12, 3))
    for k, xs in samples.items():
        print(f"timing {k:12s}: median {statistics.median(xs):7.2f} ms  (min {min(xs):.2f}, max {max(xs):.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
