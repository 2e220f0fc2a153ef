"""Two checkouts' 'high' tier end to end side by side, in one process on one
card: the three paths that run kernel A (``gru_gates_3x``), each once a
call of the path's recurrence, at matmul precision 'high'.

    python3 scripts/high_paths_ab.py --root PARENT_CHECKOUT --root . [--rounds 3] [--phase17]

Each ``--root`` names a checkout whose ``formula_vad_tpu_torch`` is loaded
under a name of its own, with its own ``demo`` network and its own build of
the kernels. The input is ``chip_smoke.py``'s slice (the checkout's
``testing.distributed.slice_batch``: 21 streams x 20 s, numpy seed 1).
Each round runs A B B A on each path:

- offline: ``BatchRunner(net).run`` of the slice, wall to the card's end
  (kernel A once a run at [1,680, 54]);
- streaming: ``BatchRunner(net, use_offline=False).run`` of the slice, wall
  (kernel A once a chunk step at [42, 54], 40 a run);
- low latency: ``lowlatency.step`` on the slice's first 10 ms hop at 21
  streams x 2 channels, chained from a fresh state, the median CUDA-event
  time of 50 steps after 5 (kernel A once a step at [42, 1] from a state).

Each path is warmed up once per checkout first. Every run's kernel-A
launches are counted and must be the path's; the two checkouts' segments
must be equal on both runner paths (their 'high' recurrences are bit for
bit). ``--phase17`` also runs, for each checkout in a process of its own
(its own ``chip_smoke.py`` imports the package by name), that file's phase
17 (a) and (b) (``kernel_a_rows``, ``kernel_b_rows``) after its kernels
are built, in the order A B, and prints each one's wall. Prints one line
per run and, last, one JSON line with each checkout's medians.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HOP, STEPS, WARM_STEPS = 480, 50, 5
PATHS = ("offline", "streaming", "lowlatency")
LAUNCHES = {"offline": 1, "streaming": 40, "lowlatency": STEPS}


def _package(root: str, alias: str):
    """The ``formula_vad_tpu_torch`` of the checkout at ``root``, loaded as ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "formula_vad_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


class _Checkout:
    def __init__(self, root: str, alias: str, dev):
        self.pkg = _package(root, alias)
        mod = lambda name: importlib.import_module(f"{alias}.{name}")  # noqa: E731
        self.precision = mod("ops.precision")
        self.gates = mod("models.nsnet2_gates_cuda")
        self.lowlatency = mod("pipeline.lowlatency")
        runner = mod("parallel.runner")
        self.net = mod("models.registry").load_denoiser("demo", device=dev)
        self.audio = mod("testing.distributed").slice_batch()[0]
        self.runners = {"offline": runner.BatchRunner(self.net),
                        "streaming": runner.BatchRunner(self.net, use_offline=False)}
        self.dev = dev

    def run(self, path: str) -> dict:
        """One run of ``path`` at 'high': its time in ms, kernel A's launches, the segments."""
        import torch

        self.precision.set_matmul_precision("high")
        before = self.gates.gru_gates_3x.launches
        try:
            if path == "lowlatency":
                x = torch.from_numpy(self.audio[..., :HOP]).to(self.dev)
                times = []
                with torch.inference_mode():
                    state = self.lowlatency.init_state(x.shape[:2], self.dev)
                    for _ in range(WARM_STEPS):
                        state, _ = self.lowlatency.step(self.net, state, x)
                    torch.cuda.synchronize()
                    before = self.gates.gru_gates_3x.launches
                    for _ in range(STEPS):
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        state, out = self.lowlatency.step(self.net, state, x)
                        end.record()
                        end.synchronize()
                        times.append(start.elapsed_time(end))
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError("high_paths_ab: a low-latency step gave non-finite values")
                ms, segments = statistics.median(times), None
            else:
                t0 = time.perf_counter()
                results = self.runners[path].run(self.audio)
                torch.cuda.synchronize()
                ms, segments = (time.perf_counter() - t0) * 1e3, [r.segments for r in results]
        finally:
            self.precision.set_matmul_precision("highest")
        return {"ms": ms, "launches": self.gates.gru_gates_3x.launches - before, "segments": segments}


def _phase17(root: str) -> int:
    """``--phase17-of ROOT``: that checkout's phase 17 (a) and (b) walls, after its kernels are built."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from formula_vad_tpu_torch.models.registry import load_denoiser

    dev = torch.device("cuda")
    smi = smoke.phase_device()  # builds every kernel, as chip_smoke does before its phases
    net = load_denoiser("demo", device=dev)
    walls = {}
    for label, fn in (("a", smoke.kernel_a_rows), ("b", smoke.kernel_b_rows)):
        t0 = time.perf_counter()
        fn(net, dev, smi)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
    print(json.dumps({"root": root, "phase17_s": walls}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", help="a checkout (give two)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--phase17", action="store_true", help="also time each checkout's phase 17 (a) and (b)")
    ap.add_argument("--phase17-of", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("high_paths_ab: needs a CUDA device", file=sys.stderr)
        return 2
    if args.phase17_of:
        return _phase17(args.phase17_of)
    if not args.root or len(args.root) != 2:
        ap.error("give two --root")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {"card": card, "roots": [os.path.abspath(r) for r in args.root], "rounds": args.rounds}
    if args.phase17:
        result["phase17_s"] = []
        for root in args.root:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--phase17-of", root],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise AssertionError(f"high_paths_ab: phase 17 of {root} exited {proc.returncode}")
            walls = json.loads(proc.stdout.strip().splitlines()[-1])["phase17_s"]
            result["phase17_s"].append(walls)
            print(f"{root}: phase 17 (a) {walls['a']:.1f} s, (b) {walls['b']:.1f} s", flush=True)

    checkouts = [_Checkout(root, f"_high_paths_ab_checkout_{i}", dev) for i, root in enumerate(args.root)]
    segments = {}
    for path in PATHS:
        for c in checkouts:
            c.run(path)  # warm-up: builds, packed weights, cached bases
    times = {path: [[], []] for path in PATHS}
    for r in range(args.rounds):
        for path in PATHS:
            for j in (0, 1, 1, 0):
                got = checkouts[j].run(path)
                if got["launches"] != LAUNCHES[path]:
                    raise AssertionError(f"high_paths_ab: {args.root[j]} {path} launched kernel A {got['launches']} "
                                         f"times, not {LAUNCHES[path]}")
                if got["segments"] is not None and segments.setdefault(path, got["segments"]) != got["segments"]:
                    raise AssertionError(f"high_paths_ab: {args.root[j]} {path} segments differ from the first run's")
                times[path][j].append(got["ms"])
                print(f"round {r} {path} {args.root[j]}: {got['ms']:.3f} ms, kernel A {got['launches']}", flush=True)
    result["ms"] = times
    result["median_ms"] = {path: [statistics.median(t) for t in times[path]] for path in PATHS}
    print(card + ": medians (ms), " + "; ".join(
        f"{path} {m[0]:.3f} / {m[1]:.3f}" for path, m in result["median_ms"].items()) + f" ({' / '.join(args.root)})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
