"""Two checkouts' serving fleet side by side, in one process on one card:
the tick and push times of ``OnlineBatchServer`` at each microbatch.

    python3 scripts/serve_tick_ab.py --root PARENT_CHECKOUT --root . [--rounds 3] [--microbatch 1 3]

Each ``--root`` names a checkout whose ``formula_vad_tpu_torch`` is loaded
under a name of its own, with its own ``demo`` network and its own build of
the kernels. The input is ``chip_smoke.py``'s slice: 21 ``synth_stream``
streams of 20 s (numpy seed 1), served as 40 ticks of [21, 2, 24000]
float32, every stream valid every tick, float tier, device FSM, no
callbacks. Each fleet shape gets one warm-up run of 2 ticks first. Each
round runs A B B A at each microbatch; every run's segments must equal the
first run's at that microbatch. A run's tick time is ``tick_stats``'s (the
upload, every shard's step, its fetch); its push time adds the host
pipelines' ingest. Prints one line per run, with the ticks that took over
1.5x its p50, and, last, one JSON line with each checkout's median over
its runs of the tick p50, tick p95 and push p50.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np

STREAMS, SECONDS, CHUNK = 21, 20.0, 24000


def _package(root: str, alias: str):
    """The ``formula_vad_tpu_torch`` of the checkout at ``root``, loaded as ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "formula_vad_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def _chunks(pkg) -> np.ndarray:
    """chip_smoke's slice as [ticks, B, 2, CHUNK] float32."""
    synth = importlib.import_module(f"{pkg.__name__}.testing.synth")
    rng = np.random.default_rng(1)
    audio = np.stack([synth.synth_stream(rng, SECONDS)[0] for _ in range(STREAMS)])
    n = audio.shape[-1] // CHUNK
    return np.ascontiguousarray(audio[..., : n * CHUNK].reshape(STREAMS, 2, n, CHUNK).transpose(2, 0, 1, 3))


class _Checkout:
    def __init__(self, root: str, alias: str, dev):
        self.root = root
        self.pkg = _package(root, alias)
        registry = importlib.import_module(f"{alias}.models.registry")
        self.online = importlib.import_module(f"{alias}.parallel.online")
        self.config = importlib.import_module(f"{alias}.config")
        self.net = registry.load_denoiser("demo", device=dev)

    def run(self, chunks: np.ndarray, microbatch: int) -> dict:
        import torch

        server = self.online.OnlineBatchServer(self.config.PipelineConfig(), chunks.shape[1], params=self.net,
                                               microbatch=microbatch)
        push_ms = []
        for tick in chunks:
            t0 = time.perf_counter()
            server.push(tick)
            push_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        st = server.tick_stats()
        ticks = [t * 1e3 for t in server._tick_times]
        return {"segments": server.segments, "tick_p50_ms": st["p50_ms"], "tick_p95_ms": st["p95_ms"],
                "push_p50_ms": statistics.median(push_ms),
                "slow": [(i, round(t, 3)) for i, t in enumerate(ticks) if t > 1.5 * st["p50_ms"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True, help="a checkout (give two: A then B)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--microbatch", type=int, nargs="+", default=[1, 3])
    args = ap.parse_args(argv)
    if len(args.root) != 2:
        ap.error("give --root twice")
    import torch

    if not torch.cuda.is_available():
        print("serve_tick_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    a, b = (_Checkout(root, f"fvt_ab_{i}", dev) for i, root in enumerate(args.root))
    chunks = _chunks(b.pkg)
    times = {mb: {"A": [], "B": []} for mb in args.microbatch}
    for mb in args.microbatch:
        for side in (a, b):
            side.run(chunks[:2], mb)  # warm-up: kernel builds, caches, pinned buffers
        want = None
        for r in range(args.rounds):
            for name, side in (("A", a), ("B", b), ("B", b), ("A", a)):
                run = side.run(chunks, mb)
                if want is None:
                    want = run["segments"]
                elif run["segments"] != want:
                    raise AssertionError(f"{side.root} at microbatch={mb} gives other segments")
                times[mb][name].append(run)
                print(f"round {r} microbatch={mb} {name} ({side.root}): tick p50 {run['tick_p50_ms']:.3f} ms, "
                      f"p95 {run['tick_p95_ms']:.3f} ms, push p50 {run['push_p50_ms']:.3f} ms; ticks over 1.5x the p50 "
                      f"(index, ms): {run['slow']}", flush=True)
    summary = {
        f"microbatch_{mb}": {
            name: {k: statistics.median(run[k] for run in runs) for k in ("tick_p50_ms", "tick_p95_ms", "push_p50_ms")}
            for name, runs in sides.items()
        }
        for mb, sides in times.items()
    }
    summary["roots"] = args.root
    summary["segments"] = sum(map(len, want))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
