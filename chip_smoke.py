#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (formula_vad_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (all nvcc runs at once) and
runs seven phases; any failed check raises and the script exits non-zero.

1. Device report: nvidia-smi name and power limit, torch/CUDA versions,
   kernel build times and ptxas resource lines.
2. GRU kernel vs its plain PyTorch version at the scoring shape
   (gi1 [1680, 54, 1200], packaged demo weights): max |dh2| <= 1e-4; and
   the cuDNN two-layer GRU on the same weights as the library yardstick.
3. FSM kernel vs the native host decoder and vs its plain version on the
   card, [21, 937] windows that visit every state: bit for bit.
4. The batched scoring slice, 21 streams x 20 s of stereo 48 kHz audio,
   through BatchRunner on the card: real-time factor, a per-stage time
   split, and proof that both kernels ran (launch counters).
5. The simulator entry point on a 3-stream corpus, once with
   --device cuda and once with --device cpu: identical report.txt and
   Audacity segment files.
6. The int8 matmul kernel vs its plain version at the six product shapes
   of the int8 tier on that slice: bit for bit, for both epilogue orders
   and float32 and bfloat16 output; one small case against int64 numpy;
   device times (CUDA-graph replays) beside the bound and torch._int_mm
   (cuBLASLt) plus the epilogue, and the host time of a wrapper call.
7. The int8 tier end to end: BatchRunner on the same slice under
   set_quant("int8") (real-time factor; exactly 167 int8 matmul launches
   and no GRU-kernel launch per run; segments against the float tier's),
   then the simulator with FVAD_QUANT=int8 on cuda and on cpu: the same
   segment count, every boundary within one FSM window.

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
card's peak for their type (67 TFLOP/s float32 without tensor cores,
1,979 TOP/s int8), the H100 SXM data-sheet rates.

The last two lines of stdout are a JSON line describing each kernel and
the final {"ok": true, "device": ...} line. Exits non-zero, printing no
result, when no CUDA device is visible or the package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GRU_ROWS, GRU_STEPS = 1680, 54  # 21 streams x 2 channels x 40 chunks, 54 frames
FSM_ROWS, FSM_WINDOWS = 21, 937  # 21 streams x 20 s of 1024-sample windows
SLICE_STREAMS, SLICE_SECONDS = 21, 20.0
CORPUS_STREAMS = 3  # the simulator runs' corpus: 3 streams x 20 s
GRU_TOL = 1e-4
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9  # float32 outside the tensor cores: 67 TFLOP/s
INT8_OPS_PER_MS = 1979e9  # int8 tensor cores, dense: 1,979 TOP/s
Q8_STEPS = 54  # GRU steps per chunk: 3 in-scan int8 products each
# The int8 tier's products on the slice: (name, R, K, N, launches per
# forward, epilogue order, with a per-row scale). 1,680 rows x 54 frames;
# the head runs on the last 50 frames only.
Q8_SHAPES = (
    ("fc_in", GRU_ROWS * GRU_STEPS, 161, 400, 1, "row_col", True),
    ("gi1", GRU_ROWS * GRU_STEPS, 400, 1200, 1, "row_col", True),
    ("in_scan", GRU_ROWS, 400, 1200, 3 * Q8_STEPS, "col_row", False),
    ("ff1", GRU_ROWS * 50, 400, 600, 1, "col_row", False),
    ("ff2", GRU_ROWS * 50, 600, 600, 1, "row_col", True),
    ("out", GRU_ROWS * 50, 600, 161, 1, "row_col", True),
)
Q8_LAUNCHES = sum(shape[4] for shape in Q8_SHAPES)  # 167
WINDOW_SEC = 1024 / 48000  # one FSM window


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, ops_per_ms: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes and the
    operations over their peak rates, and which of the two it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / ops_per_ms
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_device() -> str:
    import torch

    from formula_vad_tpu_torch import _build
    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.ops import matmul_q8
    from formula_vad_tpu_torch.pipeline import fsm_cuda
    from formula_vad_tpu_torch.tools import card

    smi = card()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one nvcc per source, all at once
        for build in [pool.submit(mod._lib) for mod in (nsnet2_cuda, fsm_cuda, matmul_q8)]:
            build.result()
    log(f"kernel build + load (parallel): {time.perf_counter() - t0:.2f} s")
    for name, (secs, report) in _build.build_info.items():
        lines = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: nvcc {secs:.2f} s; " + " | ".join(lines))
    return smi


def cudnn_gru(net, dev):
    """The library yardstick for the GRU kernel: a two-layer torch.nn.GRU run
    by cuDNN on the same weights, permuted from ONNX z|r|n to PyTorch's
    r|z|n gate order (both are the linear-before-reset form). It also
    computes layer 1's input projection. Only this script calls it."""
    import torch

    from formula_vad_tpu_torch.models.nsnet2 import HIDDEN

    gru = torch.nn.GRU(HIDDEN, HIDDEN, num_layers=2, batch_first=True).to(dev)
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


def phase_gru(net, dev) -> dict:
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.tools import cuda_ms

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(-3.0, 1.5, (GRU_ROWS, GRU_STEPS, 161)).astype(np.float32)).to(dev)
    gru = cudnn_gru(net, dev)
    with torch.inference_mode():
        x = net.fc_in(feats)
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
        got = nsnet2_cuda.gru_stack(net, gi1)
        want = nsnet2_cuda.gru_stack_reference(net, gi1)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("GRU kernel produced non-finite values")
        err = float((got - want).abs().max())
        log(f"GRU kernel vs plain on the card: max |dh2| = {err:.3e} (tolerance {GRU_TOL})")
        if not err <= GRU_TOL:
            raise AssertionError(f"GRU kernel disagrees with its plain version: {err} > {GRU_TOL}")
        ms = cuda_ms(lambda: nsnet2_cuda.gru_stack(net, gi1))
        plain_ms = cuda_ms(lambda: nsnet2_cuda.gru_stack_reference(net, gi1))
        lib_err = float((gru(x)[0] - got).abs().max())
        log(f"cuDNN GRU vs the kernel: max |dh2| = {lib_err:.3e}")
        if not lib_err <= GRU_TOL:
            raise AssertionError(f"the cuDNN yardstick computes another function: {lib_err} > {GRU_TOL}")
        library_ms = cuda_ms(lambda: gru(x))
    ops = 3 * 2 * GRU_ROWS * 400 * 1200 * GRU_STEPS
    weights = (net.gru1.wh, net.gru1.bh, net.gru2.wi, net.gru2.bi, net.gru2.wh, net.gru2.bh)
    nbytes = gi1.nbytes + got.nbytes + sum(w.nbytes for w in weights)
    bound_ms, bound_by = bound(nbytes, ops, F32_OPS_PER_MS)
    log(f"GRU [{GRU_ROWS}, {GRU_STEPS}]: kernel {ms:.3f} ms ({ops / 1e9 / ms:.2f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"cuDNN GRU {library_ms:.3f} ms; bound {bound_ms:.3f} ms by {bound_by} "
        f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return {
        "name": "gru_stack", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/gru_stack.cu",
        "replaces": "formula_vad_tpu/models/nsnet2_pallas.py:88", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def phase_fsm(st, dev) -> dict:
    import torch

    from formula_vad_tpu_torch.pipeline import fsm_cuda, fsm_host
    from formula_vad_tpu_torch.testing.synth import fsm_inputs
    from formula_vad_tpu_torch.tools import cuda_ms

    mv, vr, valid = fsm_inputs(FSM_ROWS, FSM_WINDOWS, seed=0)
    args = [torch.from_numpy(x).to(dev) for x in (mv, vr, valid)]
    shape, params = st.fsm_shape, st.fsm_params
    got, got_carry = fsm_cuda.scan_windows(shape, params, *args)
    plain, plain_carry = fsm_cuda.scan_windows_reference(shape, params, *args)
    fsm_host.scan_windows_host(shape, params, mv, vr, valid)  # builds and loads the library
    t0 = time.perf_counter()
    host, host_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    events = np.bincount(host.event.reshape(-1), minlength=4)
    log(f"FSM events none/started/completed/aborted: {events.tolist()}")
    if not (events[1:] > 0).all():
        raise AssertionError("FSM inputs did not visit every transition")
    err = 0.0
    for other_name, out, carry in (("host decoder", host, host_carry), ("plain version", plain, plain_carry)):
        for field, a, b in zip(got._fields, got, out):
            a, b = a.cpu().numpy(), np.asarray(b.cpu().numpy() if torch.is_tensor(b) else b)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"FSM kernel != {other_name} on output {field}")
            if a.dtype.kind == "f":
                err = max(err, float(np.max(np.abs(a - b))))
        for key in got_carry:
            a = got_carry[key].cpu().numpy()
            b = carry[key].cpu().numpy() if torch.is_tensor(carry[key]) else carry[key]
            if a.tobytes() != np.ascontiguousarray(b).tobytes():
                raise AssertionError(f"FSM kernel != {other_name} on carry {key}")
        log(f"FSM kernel == {other_name}: all 7 outputs and the carry, bit for bit")
    ms = cuda_ms(lambda: fsm_cuda.scan_windows(shape, params, *args))
    plain_ms = cuda_ms(lambda: fsm_cuda.scan_windows_reference(shape, params, *args), reps=3)
    # Inputs read once, outputs written once; the carry the kernel seeds is
    # read and written. Its real limit is the serial chain of windows.
    nbytes = sum(x.nbytes for x in args) + sum(x.nbytes for x in got) + 2 * sum(x.nbytes for x in got_carry.values())
    bound_ms, bound_by = bound(nbytes, 0, F32_OPS_PER_MS)
    log(f"FSM [{FSM_ROWS}, {FSM_WINDOWS}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, host decoder {host_ms:.3f} ms; "
        f"bytes bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB); serial chain: {FSM_WINDOWS} dependent "
        f"windows per row, {ms / FSM_WINDOWS * 1e3:.2f} us per window in the kernel")
    return {
        "name": "scan_windows", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/fsm_scan.cu",
        "replaces": "formula_vad_tpu/pipeline/fsm_pallas.py:339", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def slice_audio() -> np.ndarray:
    from formula_vad_tpu_torch.testing.synth import synth_stream

    rng = np.random.default_rng(1)
    return np.stack([synth_stream(rng, SLICE_SECONDS)[0] for _ in range(SLICE_STREAMS)])


def timed_runs(runner, audio, counters) -> tuple[list, list[float], dict]:
    """One warm-up run, then the counters set to 0 and three timed runs:
    (results, walls in s, launches counted over the three)."""
    import torch

    def run():
        res = runner.run(audio)
        torch.cuda.synchronize()
        return res

    run()  # warm-up
    for fn in counters.values():
        fn.launches = 0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        results = run()
        walls.append(time.perf_counter() - t0)
    return results, walls, {name: fn.launches for name, fn in counters.items()}


def phase_slice(runner, audio, smi: str) -> tuple[dict, list, float]:
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.parallel.runner import BatchRunner
    from formula_vad_tpu_torch.pipeline import fsm_cuda, offline
    from formula_vad_tpu_torch.tools import cuda_ms

    audio_sec = SLICE_STREAMS * SLICE_SECONDS
    log(f"slice input: {audio.shape} float32, {audio.nbytes / 1e6:.0f} MB, {audio_sec:.0f} audio-seconds")
    net = runner.net
    host_runner = BatchRunner(net, use_host_fsm=True)
    counters = {"gru_stack": nsnet2_cuda.gru_stack, "scan_windows": fsm_cuda.scan_windows}
    results, walls, launches = timed_runs(runner, audio, counters)
    log(f"slice launches over 3 runs: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    wall = statistics.median(walls)
    log(f"slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s: wall {wall * 1e3:.1f} ms (median of 3, "
        f"runs {[round(w * 1e3, 1) for w in walls]}), real-time factor {audio_sec / wall:.1f} on {smi}")

    n_seg = sum(len(r.segments) for r in results)
    host_results = host_runner.run(audio)
    if [r.segments for r in results] != [r.segments for r in host_results]:
        raise AssertionError("device-FSM and host-FSM segments differ on the slice")
    log(f"slice segments: {n_seg}, identical between the device FSM and the host decoder")
    if n_seg == 0:
        raise AssertionError("the slice found no speech segment in 21 streams of synthetic speech")

    # Per-stage split on the card (one extra pass, CUDA events).
    x = torch.from_numpy(audio).to(runner.device)
    st = runner.st
    with torch.inference_mode():
        fe_ms = cuda_ms(lambda: offline.window_inputs_batch(net, st, x), reps=3)
        mv, rt, va = offline.window_inputs_batch(net, st, x)
        if not all(bool(torch.isfinite(t).all()) for t in (mv, rt)):
            raise AssertionError("non-finite window inputs")
        fsm_ms = cuda_ms(lambda: fsm_cuda.scan_windows(st.fsm_shape, st.fsm_params, mv, rt, va), reps=3)
    log(f"slice split: front end (incl. GRU kernel) {fe_ms:.1f} ms, FSM kernel {fsm_ms:.2f} ms, "
        f"host rest {wall * 1e3 - fe_ms - fsm_ms:.1f} ms")
    return launches, results, wall


def run_simulators(corpus: str, plans: dict[str, tuple[str, dict]]) -> dict[str, str]:
    """Run the simulator entry point once per plan name -> (device, extra
    environment); returns each run's output directory."""
    outs = {}
    for name, (dev, extra_env) in plans.items():
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **extra_env)
        cmd = [sys.executable, "-m", "formula_vad_tpu_torch.apps.simulator", "-i", os.path.join(corpus, f"plan_{name}.json")]
        if dev == "cpu":
            cmd += ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"simulator plan {name} (--device {dev}, {extra_env}) failed:\n{proc.stderr[-4000:]}")
        (run_dir,) = os.listdir(os.path.join(corpus, f"out_{name}"))
        outs[name] = os.path.join(corpus, f"out_{name}", run_dir)
        log(f"simulator plan {name} (--device {dev}, {extra_env or 'default tier'}): {time.perf_counter() - t0:.1f} s")
    return outs


def read_text(run_dir: str, name: str) -> str:
    with open(os.path.join(run_dir, name)) as f:
        return f.read()


def phase_entry_point(corpus: str) -> None:
    outs = run_simulators(corpus, {"cuda": ("cuda", {}), "cpu": ("cpu", {})})
    for name in ["report.txt"] + [f"s{i}-audacity.txt" for i in range(CORPUS_STREAMS)]:
        texts = {dev: read_text(outs[dev], name) for dev in outs}
        if texts["cuda"] != texts["cpu"]:
            log(f"--- {name} differs between --device cuda and --device cpu:")
            log(f"cuda:\n{texts['cuda']}\ncpu:\n{texts['cpu']}")
            raise AssertionError(f"{name} differs between the cuda and cpu simulator runs")
    log("simulator segments identical on cuda and cpu; s0: "
        + read_text(outs["cuda"], "s0-audacity.txt").strip().replace("\n", " | "))


def phase_q8_kernel(dev) -> dict:
    import torch

    from formula_vad_tpu_torch.ops import matmul_q8 as mq
    from formula_vad_tpu_torch.tools import graph_ms

    # One small ragged case against exact int64 arithmetic on the host.
    rng = np.random.default_rng(5)
    a, b = rng.integers(-127, 128, (100, 161)).astype(np.int8), rng.integers(-127, 128, (161, 161)).astype(np.int8)
    got = mq.matmul_q8(torch.from_numpy(a).to(dev), mq.Q8Weight.pack(torch.from_numpy(b).to(dev), torch.ones(161, device=dev)))
    if got.cpu().numpy().tobytes() != (a.astype(np.int64) @ b.astype(np.int64)).astype(np.float32).tobytes():
        raise AssertionError("int8 matmul kernel != int64 numpy on [100, 161] x [161, 161]")
    log("int8 matmul kernel == int64 numpy on [100, 161] x [161, 161]")

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    shapes, err, bound_kinds = [], 0.0, set()
    for i, (name, r, k, n, per_forward, order, with_row) in enumerate(Q8_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(i)
        a8 = torch.randint(-127, 128, (r, k), dtype=torch.int8, device=dev, generator=gen)
        b8 = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
        scale = torch.rand(n, device=dev, generator=gen) * 1e-3
        bias = torch.randn(n, device=dev, generator=gen)
        row = torch.rand((r, 1), device=dev, generator=gen) * 2.0
        w = mq.Q8Weight.pack(b8, scale, bias)
        with torch.inference_mode():
            for check_order in mq.ORDERS:
                for dtype in mq.OUT_DTYPES:
                    got = mq.matmul_q8(a8, w, row, order=check_order, out_dtype=dtype)
                    want = mq.matmul_q8_reference(a8, w, row, order=check_order, out_dtype=dtype)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"int8 matmul kernel != plain at {name} {check_order} {dtype}")
                    err = max(err, float((got.float() - want.float()).abs().max()))
            rs = row if with_row else None
            # The library yardstick: cuBLASLt's int8 GEMM (K and N padded to
            # multiples of 8), then the same epilogue as torch ops.
            k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
            a_pad = torch.zeros((r, k8), dtype=torch.int8, device=dev)
            a_pad[:, :k] = a8
            bt_pad = torch.zeros((n8, k8), dtype=torch.int8, device=dev)
            bt_pad[:n, :k] = w.qt[:, :k]

            def library():
                out = torch._int_mm(a_pad, bt_pad.t())[:, :n].to(torch.float32)
                return (out * row if with_row else out) * w.scale + w.bias

            def kernel():
                return mq.matmul_q8(a8, w, rs, order=order)

            if not torch.equal(library(), kernel()):
                raise AssertionError(f"the library yardstick computes another function at {name}")
            # Device times from CUDA-graph replays (several launches per
            # replay where the output is small), so the host's launch cost
            # stays out; that cost is timed apart, on the host clock.
            per_replay = 20 if per_forward > 1 else 2
            ms = graph_ms(kernel, per_replay)
            plain_ms = graph_ms(lambda: mq.matmul_q8_reference(a8, w, rs, order=order), per_replay)
            library_ms = graph_ms(library, per_replay)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per_replay):
                kernel()
            host_us = (time.perf_counter() - t0) / per_replay * 1e6
            torch.cuda.synchronize()
        nbytes = r * k + k * n + 4 * r * n + 8 * n + (4 * r if with_row else 0)
        bound_ms, bound_by = bound(nbytes, 2 * r * k * n, INT8_OPS_PER_MS)
        bound_kinds.add(bound_by)
        log(f"int8 matmul {name} [{r}, {k}] x [{k}, {n}] ({order}{', row scale' if with_row else ''}, x{per_forward} "
            f"per forward): kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, torch._int_mm + epilogue "
            f"{library_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.1f} us by {bound_by} ({nbytes / 1e6:.1f} MB); "
            f"host time of a wrapper call {host_us:.1f} us")
        shapes.append({"name": name, "rkn": [r, k, n], "per_forward": per_forward, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by, "host_us": host_us})
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms), ("bound_ms", bound_ms)):
            total[key] += per_forward * value
    log("int8 matmul kernel == plain bit for bit at all six shapes, both orders, f32 and bf16 output")
    log(f"int8 matmul per forward ({Q8_LAUNCHES} launches): kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"torch._int_mm + epilogue {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    return {
        "name": "matmul_q8", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/matmul_q8.cu",
        "replaces": "formula_vad_tpu/ops/matmul_q8.py:69", "max_abs_err": err,
        **total, "bound_by": "bytes" if bound_kinds == {"bytes"} else "operations", "shapes": shapes,
    }


def segment_spans(run_dir: str, stream: int) -> list[tuple[float, float]]:
    """The VAD segments (seconds) of one stream's Audacity file; reference
    segments the run missed are marked as such and left out."""
    spans = []
    for line in read_text(run_dir, f"s{stream}-audacity.txt").splitlines():
        start, end, note = line.split("\t", 2)
        if note != "missed":
            spans.append((float(start), float(end)))
    return spans


def phase_q8_slice(runner, audio, float_results, float_wall: float, corpus: str, smi: str) -> dict:
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.ops import matmul_q8, precision
    from formula_vad_tpu_torch.pipeline import fsm_cuda, offline
    from formula_vad_tpu_torch.tools import cuda_ms

    audio_sec = SLICE_STREAMS * SLICE_SECONDS
    net, st = runner.net, runner.st
    counters = {"matmul_q8": matmul_q8.matmul_q8, "gru_stack": nsnet2_cuda.gru_stack, "scan_windows": fsm_cuda.scan_windows}
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(-3.0, 1.5, (GRU_ROWS, GRU_STEPS, 161)).astype(np.float32)
    ).to(runner.device)
    with torch.inference_mode():
        float_model_ms = cuda_ms(lambda: net(feats, out_frames=50), reps=3)
    precision.set_quant("int8")
    try:
        results, walls, launches = timed_runs(runner, audio, counters)
        log(f"int8 slice launches over 3 runs: {launches}")
        if launches != {"matmul_q8": 3 * Q8_LAUNCHES, "gru_stack": 0, "scan_windows": 3}:
            raise AssertionError(f"the int8 slice launched {launches}, not {Q8_LAUNCHES} int8 matmuls per run and no GRU kernel")
        x = torch.from_numpy(audio).to(runner.device)
        with torch.inference_mode():
            fe_ms = cuda_ms(lambda: offline.window_inputs_batch(net, st, x), reps=3)
            model_ms = cuda_ms(lambda: net(feats, out_frames=50), reps=3)
    finally:
        precision.set_quant("off")
    wall = statistics.median(walls)
    log(f"int8 slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s: wall {wall * 1e3:.1f} ms (median of 3, runs "
        f"{[round(w * 1e3, 1) for w in walls]}), real-time factor {audio_sec / wall:.1f}; float tier in this call "
        f"{float_wall * 1e3:.1f} ms, real-time factor {audio_sec / float_wall:.1f}; on {smi}")
    log(f"int8 slice split: front end (incl. int8 model) {fe_ms:.1f} ms, host and FSM rest {wall * 1e3 - fe_ms:.1f} ms; "
        f"model forward at [{GRU_ROWS}, {GRU_STEPS}, 161]: int8 {model_ms:.2f} ms, float {float_model_ms:.2f} ms")
    n_seg = sum(len(r.segments) for r in results)
    if n_seg == 0:
        raise AssertionError("the int8 slice found no speech segment")
    def spans(res):
        return {(seg["sample_from"], seg["sample_to"]) for seg in res.segments}

    differ = sum(len(spans(q) ^ spans(f)) for q, f in zip(results, float_results))
    log(f"int8 slice segments: {n_seg} (float tier {sum(len(r.segments) for r in float_results)}); "
        f"segments found by one tier only: {differ}")

    outs = run_simulators(corpus, {"int8_cuda": ("cuda", {"FVAD_QUANT": "int8"}), "int8_cpu": ("cpu", {"FVAD_QUANT": "int8"})})
    for i in range(CORPUS_STREAMS):
        gpu, cpu = segment_spans(outs["int8_cuda"], i), segment_spans(outs["int8_cpu"], i)
        if len(gpu) != len(cpu) or not gpu:
            raise AssertionError(f"int8 simulator s{i}: {len(gpu)} segments on cuda, {len(cpu)} on cpu")
        worst = max(abs(a - b) for g, c in zip(gpu, cpu) for a, b in zip(g, c))
        if worst > WINDOW_SEC + 1e-4:  # the files round to 0.1 ms
            raise AssertionError(f"int8 simulator s{i}: a boundary moved {worst:.4f} s between cuda and cpu")
        log(f"int8 simulator s{i}: {len(gpu)} segments on cuda and cpu, boundaries within {worst:.4f} s")
    same = read_text(outs["int8_cuda"], "report.txt") == read_text(outs["int8_cpu"], "report.txt")
    log(f"int8 simulator report.txt identical on cuda and cpu: {same}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import formula_vad_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a formula-vad-tpu checkout", file=sys.stderr)
        return 2

    from formula_vad_tpu_torch import device as device_mod
    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.parallel.runner import BatchRunner
    from formula_vad_tpu_torch.testing.synth import write_corpus

    dev = device_mod.resolve("cuda")
    smi = phase_device()
    net = load_denoiser("demo", device=dev)
    runner = BatchRunner(net)  # the default VAD config, device FSM
    kernels = [phase_gru(net, dev), phase_fsm(runner.st, dev)]
    audio = slice_audio()
    launches, float_results, float_wall = phase_slice(runner, audio, smi)
    with tempfile.TemporaryDirectory() as corpus:
        write_corpus(corpus, CORPUS_STREAMS, 20.0, seed=2, plans=("cuda", "cpu", "int8_cuda", "int8_cpu"))
        phase_entry_point(corpus)
        kernels.append(phase_q8_kernel(dev))
        launches["matmul_q8"] = phase_q8_slice(runner, audio, float_results, float_wall, corpus, smi)["matmul_q8"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
