"""Where the batched scoring slice spends its time on one GPU.

    python -m formula_vad_tpu_torch.tools.profile_slice [--quant off|int8] [--precision highest|high|default]
        [--io-dtype f32|bf16] [--out FILE]

On one synthetic batch (21 streams x 20 s of stereo 48 kHz audio, the
batched scoring shape; the packaged demo weights), in one process:

1. FSM mode A/B: the wall time of ``BatchRunner.run`` with the device FSM
   (D) and with the native host decoder (H), host audio in and segments
   out, in interleaved DHHD / HDDH pairs after one warm-up run of each;
   medians, quartiles, and the pairs each mode won.
2. The batch's host-to-device copy from pageable and from pinned memory
   (median of 5 CUDA-event-timed copies each).
3. One device-FSM run under ``torch.profiler``: the wall, the device's busy
   time (the union of its kernel and copy intervals) and the share of the
   wall it covers, and the ops with the most device time. ``--out`` gets
   the whole op table.

``--quant int8`` runs all of it under the int8 denoiser tier
(``ops/precision.set_quant``), ``--precision default`` under the bf16 tier
and ``--precision high`` under bf16_3x (``ops/precision.set_matmul_precision``),
``--io-dtype bf16`` under bf16 activation storage (``set_io_dtype``). The
bf16 tier (with float32 storage) adds, after step 1:

- a tier A/B: device-FSM walls of the float (F) and bf16 (B) tiers in
  interleaved FBBF / BFFB pairs after one warm-up run of each; medians,
  the ratio of the float median to the bf16 one, and the pairs each won;
- the tier's plain large product, a float32 GEMM of bf16-rounded operands
  (``ops/precision.matmul``), at gi1's shape against a bf16 GEMM with
  float32 output (``torch.mm(..., out_dtype=torch.float32)``) where the
  installed torch offers one. The port does not use the latter.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from .. import device as device_mod
from ..models.registry import load_denoiser
from ..ops import precision
from ..parallel.runner import BatchRunner
from ..testing.synth import synth_stream
from . import busy_ms, card, cuda_ms

STREAMS, SECONDS, PAIRS = 21, 20.0, 6


def _quartiles(xs: list[float]) -> str:
    q = statistics.quantiles(xs, n=4)
    return f"median {statistics.median(xs):.2f} ms (quartiles {q[0]:.2f}-{q[2]:.2f}, {len(xs)} runs)"


def _tier_ab(run, audio_sec: float) -> None:
    """Float (F) against bf16 (B) tier, device FSM, interleaved pairs."""

    def run_at(tier):
        precision.set_matmul_precision("highest" if tier == "F" else "default")
        try:
            return run("D")[0] * 1e3
        finally:
            precision.set_matmul_precision("default")

    run_at("F")
    run_at("B")
    walls: dict[str, list[float]] = {"F": [], "B": []}
    for p in range(PAIRS):
        for tier in ("FBBF" if p % 2 == 0 else "BFFB"):
            walls[tier].append(run_at(tier))
    for tier, name in (("F", "float tier"), ("B", "bf16 tier")):
        med = statistics.median(walls[tier])
        print(f"{name}: {_quartiles(walls[tier])}, real-time factor {audio_sec / (med / 1e3):.1f}")
    f, b = walls["F"], walls["B"]
    print(f"bf16 tier real-time factor / float tier's: {statistics.median(f) / statistics.median(b):.3f}; "
          f"bf16 faster in {sum(b[i] < f[i] for i in range(len(b)))} of {len(b)} interleaved pairs")


def _gemm_probe(dev, rows: int) -> None:
    """The tier's float32 GEMM of bf16-rounded operands at gi1's shape
    against a bf16 GEMM with float32 output, where torch offers one."""
    a = torch.randn((rows, 400), device=dev)
    b = torch.randn((400, 1200), device=dev)
    with torch.inference_mode():
        want = precision.bf16_round(a) @ precision.bf16_round(b)
        upcast_ms = cuda_ms(lambda: precision.bf16_round(a) @ precision.bf16_round(b))
        shape = f"[{rows}, 400] x [400, 1200]"
        try:
            direct = torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            print(f"bf16 GEMM with float32 output: not offered by torch {torch.__version__} ({type(e).__name__}); "
                  f"the tier's float32 GEMM of rounded operands at {shape}: {upcast_ms:.3f} ms")
            return
        direct_ms = cuda_ms(lambda: torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32))
    print(f"bf16 GEMM with float32 output (torch.mm out_dtype): {direct_ms:.3f} ms against {upcast_ms:.3f} ms for "
          f"the tier's float32 GEMM of rounded operands at {shape}, max |d| {float((direct - want).abs().max()):.3e}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the profiler's op table here")
    ap.add_argument("--quant", choices=("off", "int8"), default="off", help="the denoiser model's quantization tier")
    ap.add_argument("--precision", choices=("highest", "high", "default"), default=None,
                    help="the matmul precision (default: FVAD_PRECISION, else highest)")
    ap.add_argument("--io-dtype", choices=("f32", "bf16"), default=None,
                    help="the activation-storage dtype (default: FVAD_IO_DTYPE, else f32)")
    args = ap.parse_args(argv)

    dev = device_mod.resolve("cuda")
    precision.set_quant(args.quant)
    if args.precision:
        precision.set_matmul_precision(args.precision)
    if args.io_dtype:
        precision.set_io_dtype(args.io_dtype)
    print(f"profile_slice (quant {args.quant}, precision {precision.matmul_precision()}, storage "
          f"{precision.io_dtype() or torch.float32}) on {card()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    rng = np.random.default_rng(1)
    audio = np.stack([synth_stream(rng, SECONDS)[0] for _ in range(STREAMS)])
    audio_sec = STREAMS * SECONDS
    print(f"batch {audio.shape} float32, {audio.nbytes / 1e6:.0f} MB, {audio_sec:.0f} audio-seconds")
    net = load_denoiser("demo", device=dev)
    runners = {"D": BatchRunner(net), "H": BatchRunner(net, use_host_fsm=True)}

    def run(mode):
        t0 = time.perf_counter()
        res = runners[mode].run(audio)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    _, want = run("D")
    _, got = run("H")
    if [r.segments for r in want] != [r.segments for r in got]:
        raise AssertionError("device-FSM and host-decoder segments differ")

    walls: dict[str, list[float]] = {"D": [], "H": []}
    for p in range(PAIRS):
        for mode in ("DHHD" if p % 2 == 0 else "HDDH"):
            walls[mode].append(run(mode)[0] * 1e3)
    for mode, name in (("D", "device FSM"), ("H", "host decoder")):
        med = statistics.median(walls[mode])
        print(f"{name}: {_quartiles(walls[mode])}, real-time factor {audio_sec / (med / 1e3):.1f}")
    # Each pair is DH HD or HD DH: compare the two runs of a mode inside one pair.
    d, h = walls["D"], walls["H"]
    d_wins = sum(d[i] < h[i] for i in range(len(d)))
    print(f"device FSM faster in {d_wins} of {len(d)} interleaved pairs")
    if precision.matmul_precision() == "default" and precision.io_dtype() is None:
        _tier_ab(run, audio_sec)
        _gemm_probe(dev, 1680 * 54)  # gi1: 21 streams x 2 channels x 40 chunks, 54 frames

    host = torch.from_numpy(audio)
    pinned = host.pin_memory()
    pageable_ms = cuda_ms(lambda: host.to(dev))
    pinned_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True))
    gb = audio.nbytes / 1e9
    print(f"H2D of the batch: pageable {pageable_ms:.2f} ms ({gb / pageable_ms * 1e3:.1f} GB/s), "
          f"pinned {pinned_ms:.2f} ms ({gb / pinned_ms * 1e3:.1f} GB/s)")

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall_ms = run("D")[0] * 1e3
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device_events:
        print("profiler: the trace holds no device events; use the CUDA-event split of chip_smoke.py")
    else:
        busy, kernels, _ = busy_ms(device_events)
        n_kernels = sum(not e.name.lower().startswith(("memcpy", "memset")) for e in device_events)
        print(f"profiled device-FSM run: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall_ms:.1f}% of the wall; kernels alone {kernels:.2f} ms in {n_kernels} launches, "
              f"{100 * kernels / wall_ms:.1f}%), idle {wall_ms - busy:.2f} ms")
        by_name: dict[str, list[float]] = {}
        for e in device_events:
            by_name.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
        for name, ds in top:
            print(f"  {sum(ds):8.3f} ms  {len(ds):4d}x  {name[:100]}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
