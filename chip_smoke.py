#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (formula_vad_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (all nvcc runs at once) and
runs nineteen phases; any failed check raises and the script exits non-zero.

1. Device report: nvidia-smi name and power limit, torch/CUDA versions,
   kernel build times and ptxas resource lines.
2. GRU kernel vs its plain PyTorch version at the scoring shape
   (gi1 [1680, 54, 1200]) and at ragged and multi-wave row counts (1, 37,
   1,690, 4,000 rows at 1 and 54 steps), on the packaged demo weights and
   on random weights with large GRU biases: max |dh2| <= 1e-4 each; its
   launch plan (tiles, tile sizes, grid: one wave of at least 120 CTAs);
   and the cuDNN two-layer GRU on the same weights as the library
   yardstick. Then linear_before_reset = 0 weights, which have no kernel,
   scored on the card (the plain loop) against the CPU: 1e-4, no launch.
3. FSM kernel (its shared-memory body) vs the native host decoder at
   [21, 937], [21, 56,250] (20-minute streams: the long ring wraps, many
   tiles) and [660, 937] (five rows an SM, two waves), and vs its plain
   version at [21, 937], on windows that visit every state: all seven outputs and the
   carry bit for bit. For each shape its launch plan (body, CTAs, tile,
   shared memory a CTA), its time per single call, queued back to back and
   continuing a carry, ns a window, the host time of a fresh wrapper call,
   the bytes bound and, in the log only, the chain bound (the decision
   chain's loop-carried cycles a window, a fixed count from the SASS,
   times the windows, over the card's top SM clock). Then a long ring
   above the shared-memory budget, which takes the global body, counted
   apart, against the host decoder.
4. The batched scoring slice, 21 streams x 20 s of stereo 48 kHz audio,
   through BatchRunner on the card: real-time factor, a per-stage time
   split, and proof that both kernels ran (launch counters).
5. The simulator entry point on a 3-stream corpus, once with
   --device cuda and once with --device cpu: identical report.txt and
   Audacity segment files.
6. The int8 matmul kernel vs its plain version at the six product shapes
   of the int8 tier on that slice: bit for bit, for both epilogue orders
   and float32 and bfloat16 output, on the path the wrapper picks (the
   wgmma body at every slice shape); one small case against int64 numpy;
   each shape's path and tile plan; device times (CUDA-graph replays)
   beside the bound and torch._int_mm (cuBLASLt) plus the epilogue, and
   the host time of a wrapper call (tools.host_us: the median of 7 rounds
   of 20 calls).
7. The int8 tier end to end: BatchRunner on the same slice under
   set_quant("int8") (real-time factor; exactly 167 int8 matmul launches
   and no GRU-kernel launch per run; segments against the float tier's),
   then the simulator with FVAD_QUANT=int8 on cuda and on cpu: the same
   segment count, every boundary within one FSM window.
8. The per-gate GRU kernels 4, 5 and 6 (models/nsnet2_gates_cuda.py). First
   their own path, the experiment tool tools/gru_kernel_exp.py, once over
   all its variants (launch counters from that run). Then each kernel
   against its plain version at [1680, 54], on random weights with random
   GRU biases so that every bias term counts, in float32 (max |dh2| <= 1e-4,
   kernel 1's bar; the float32 forms run on kernel 1's kernel, so also at
   phase 2's ragged and multi-wave shapes, with its launch plan) and bf16
   (mean |dh2| <= 3e-5: another float32 summation order now and then moves
   an h value across a bf16 rounding step, ~4e-6 on the mean; the bar must
   sit 10x below the plain bf16 form's mean distance from the plain float32
   form, measured here, so that the check shows the bf16 rounding points
   are reproduced; and max |dh2| <= 6e-3, one bf16 step below 1 plus
   float32 drift, against a single wild value); in both forms kernel 6 with
   tile = all rows, 840 and 416 bit for bit equal, and its bf16 out equal to
   its float32 out rounded. The bf16 forms of all three run on one body,
   csrc/gru_gates_p.cu: for each, its launch plan (unit groups, row groups,
   grid, shared bytes), the bf16 bars at 1, 17, 337 and 4,000 rows (two
   launches, each counted), a repeated call and 17 rows of 1,680 against a
   17-row call bit for bit. Each form's single and queued times, plain and
   bound times; the library yardstick is cuDNN's two-layer torch.nn.GRU, in
   float32 for the float32 forms and in float16 for the bf16 forms (the
   nearest call whose weights cuDNN compacts once; it stores h in 16 bits,
   another function). cuDNN's bf16 GRU, which compacts its weights on every
   call, is timed beside it. Then each bf16 body on random gi (N(0, 0.8),
   numpy seed 100, 8 rows x 54 steps, the random-init weights) against
   its plain version under the CPU tests' pre-flip bar (ROADMAP §3 fault
   3): mean |dh2| <= 1e-5 over each row's steps before its first bf16
   rounding flip of h2, over at least 16 such row-steps.
9. The bf16 tier end to end: BatchRunner on the slice under
   set_matmul_precision("default") (real-time factor; exactly 1 kernel-5
   launch and no gru_stack launch per run; segments against the float
   tier's), then the simulator with --precision default on cuda and on
   cpu: the same segment count, every boundary within one FSM window.
10. The slab path (parallel/slab_runner.py) on a race-length corpus: 21
   PCM16 streams of ~320 s (5 slabs of 64 s, ragged ends), scored through
   SlabRunner.run_readers with raw int16 readers, the float tier and the
   device FSM: wall, real-time factor, exactly 1 gru_stack and 1 smem-body
   scan_windows launch a slab, peak device memory within 5% of the same
   run over the first 2 slabs, the host's part alone (the prefetcher
   reading every slab; one slab's copy into pinned memory), and the
   device's busy share and the part of the host-to-device copy hidden under
   compute (one torch.profiler pass).
   Its chained FSM outputs over all 5 slabs equal the host decoder's single
   call over all windows bit for bit, and its segments equal the host-FSM
   slab run's, the float32-reader run's and a one-shot BatchRunner's over
   the first 4 streams. Kernels 1, 5 (bf16) and 3 (in-scan product) at the
   slab's shapes against their plain versions (1e-4; phase 8's bars over
   kernel 5's 3 launches; bit for bit). One slab run each in the bf16 tier
   (3 kernel-5 launches a slab) and the int8 tier (167 kernel-3 launches
   and no gru_stack a slab), each against the same tier's one-shot run on
   the first 4 streams (the same segment count, every boundary within one
   FSM window). Then the simulator on a 3-stream x 40 s PCM16 corpus:
   use_slabs plans on cuda and on cpu and a one-shot plan on cuda write
   identical report.txt and Audacity files.
11. The precision tiers and the tier-fuzz campaign (testing/tier_fuzz.py).
   The slice through BatchRunner in the float, high (bf16_3x), bf16 and
   bf16_io (bf16 activation storage) tiers, one after the other, each a
   median of 3 after a warm-up, with every kernel's launches counted:
   exactly 1 kernel-A launch (gru_gates_3x) a run under high, 1 kernel-6 launch (bf16,
   bf16 out) under bf16_io, 1 scan_windows in each, and nothing else;
   high's segments identical to the float tier's, bf16_io's the same count
   with every boundary within one FSM window. Kernel 6 in bf16 with a bf16
   out on the gi the bf16_io tier hands it, at [1,680, 54] and [32, 54]
   (the campaign's rows), against its plain version (phase 8's bars), with
   its times, bound and cuDNN's fp16 GRU. Then the campaign on the demo
   weights, 240 cases of 16 chunks: its table, every kernel's launches over
   it, a non-vacuous baseline, and at high no segment-count change and no
   deviated case but the known near-ties (HIGH_KNOWN_TIES, each run alone
   again), each boundary within one window (the bf16 and bf16_io
   envelopes are recorded, not gated).
12. The streaming path. The slice through BatchRunner(use_offline=False),
   one chunk step a 0.5 s chunk for all 21 streams (40 steps), in each of
   the float, bf16, bf16_io and int8 tiers: real-time factor (median of 3
   after a warm-up; the float tier's beside phase 4's offline one), exactly
   40 launches of the tier's recurrence a run (gru_stack at 42 rows,
   kernel 5, kernel 6, or 40 x 167 kernel-3 and no gru_stack) and 40
   scan_windows ([21, 24]) and nothing else, a chunk step's CUDA-event time
   and the host time of its Python call, and the device's busy share (one
   torch.profiler pass). The float tier's segments are identical to phase
   4's; each other tier's are held to the same tier's offline run (the same
   segment count, every boundary within one FSM window). Every kernel of
   the path at a chunk step's shapes, for the slice's 21 streams and for
   AudioPipeline's one stereo stream, against its plain version with its
   launch plan, times and bound: the FSM's chained calls of a streaming run
   at [21, 24] and [1, 24] against the host decoder and the plain version
   chained over the same chunks, and against the host decoder in one call
   over each stream's valid windows joined (all seven outputs and the final
   carry, bit for bit); kernel 1 at 2 and 42 rows x 54 steps (1e-4) with
   cuDNN's GRU; kernels 5 and 6 at 2 and 42 rows on the gi their tiers hand
   them (phase 8's bars) with cuDNN's fp16 GRU; kernel 3 at the six products
   of a 2- and a 42-row forward (bit for bit, both orders and output types)
   with torch._int_mm. The host AudioPipeline on one 60 s stereo stream
   pushed in irregular sizes: its segments equal the streaming runner's,
   one original and one denoised recording a segment at its sample_from,
   and the latency of each chunk (PCM in, events out) beside the 500 ms
   cadence. Then the simulator on phase 5's corpus with "batch_streams":
   false on cuda and on cpu: the same report.txt and Audacity files as each
   other and as phase 5's batched cuda plan, and the batched plan's clip
   names and sample counts.
13. Serving (parallel/online.py, apps/daemon.py, apps/multidaemon.py).
   (a) OnlineBatchServer with the slice's 21 streams, one tick a 0.5 s
   chunk (40), float tier, device FSM: segments identical to phase 4's
   offline and phase 12's streaming runs, exactly 40 gru_stack (42 rows)
   and 40 scan_windows ([21, 24]) launches and nothing else, tick_stats
   p50/p95/max against the 500 ms budget, the host time a tick spends
   waiting for its fetch and its ingest. Then the same fleet with the host
   FSM (40 gru_stack, no scan_windows), with microbatch=3 and with
   collect_denoised=False, and an int16 push against a float32 push of the
   same PCM16 samples: segments, original recordings and every decision and
   index bit for bit; the float outputs (denoised audio, window volumes)
   bit for bit at the same row count, and at microbatch=3 (14 rows a step)
   within 1e-5, their bit-exactness logged. (b) A fleet of 256 streams (512
   GRU rows, ~2 GB of host rings) over 8 ticks: tick p50/p95, launches, and
   kernel 1 at [512, 54] (1e-4) and kernel 2 chained at [256, 24] (bit for
   bit with the host decoder) as in phase 12 ("serve_shapes"). (c) Ragged
   serving: 4 streams on a random valid pattern with one reset_stream,
   against solo AudioPipelines on the card (segments and original
   recordings identical, denoised ones within 1e-5); then a save_state at
   tick 20 and a new server's load_state: segments and recordings equal to
   the uninterrupted run bit for bit, and the first tick after the load on
   the checked FSM path (one carry index check, then none). (d) The daemons
   as processes on the card over phase 5's corpus: apps.multidaemon with
   --state and --checkpoint-every 1, SIGKILLed after its second checkpoint
   ack, restarted and fed stdin again from commands_processed: its events
   and WAVs equal an uninterrupted run's byte for byte; apps.daemon on one
   of the streams: its original WAVs equal the multidaemon's byte for byte,
   its denoised ones within 1e-5.
14. The low-latency mode (pipeline/lowlatency.py) and the sweep. (a) The
   slice's 21 streams x 2 channels in one lowlatency.run (2,000 hops of 10
   ms: wall, real-time factor, 1 gru_stack launch) and in 200 chained
   steps (per-hop p50/p95 on CUDA events and the host clock, 1 launch a
   hop), the chain against the run within 1e-5, 50 chained steps under
   torch.profiler (the device's busy share, launches and synchronising
   calls a step), kernel 1 as a run from a nonzero state launches it at
   [42, 2,000] caught at its wrapper and held against its plain version,
   an impulse that reaches no output hop before its own, the scale curve
   at 64 to 4,096 streams as tools/lowlatency_scale.py prints it, each
   tier's step launching its recurrence (int8: its 8 products) and nothing
   else, and kernels 1 (at 42 and 8,192 rows, beside cuDNN's GRU from the
   same h0), 5, 6 (42 rows) and 3 (a hop's 8 products at 42 rows)
   continuing a nonzero state against their plain versions. (b) The slice with K = 8 alternative
   machines (a 4 x 2 grid of speech_threshold_factor x
   channel_vol_ratio_threshold, the base config among them): one kernel-2
   launch a run at [189, 937], the primary's and the base machine's
   segments equal phase 4's, every (stream, config) row's outputs bit for
   bit with the host decoder, the wall beside the plain slice's, kernel 2
   at the sweep's rows, and apps.tune on phase 5's corpus with the same
   leaderboard on cuda and on cpu.
15. The rest of the denoiser registry. (a) The demo weights through the
   port's ONNX writer and importer, loaded on the card bit for bit with the
   .npz model; the slice through BatchRunner with them (one gru_stack and
   one scan_windows a run, segments identical to phase 4's); the simulator
   on phase 5's corpus with a plan naming the .onnx file, its files
   identical to phase 5's cuda run. (b) The spectral gate: the slice
   offline (one scan_windows a run and nothing else; wall and real-time
   factor beside phase 4's float tier; one torch.profiler split; the
   offline run's stages timed apart on the host clock) and
   streaming (40 scan_windows a run), segments equal to each other and to
   the CPU gate run's; OnlineBatchServer with the gate for 8 ticks at 21
   streams, decisions bit for bit with the CPU fleet's. (c)
   eval/denoise_quality.evaluate (2 held-out pairs x 16 s) of the demo
   weights, the imported model and the gate on the card, each within
   0.05 dB of the CPU's, above the JAX package's floors (demo 15 dB mean
   and 10 a pair, gate 3), the imported model's numbers equal to the
   demo's.
16. Training (train/nsnet2_train.py, apps/train.py). (a) One batch at the
   CLI's default shape [8, 100, 161] through the differentiable forward on
   the card and on the CPU, TF32 off: the loss within 1e-5 and every
   gradient within 1e-4 of its array's largest element (float32 sums in
   other orders through 100 steps of the recurrence), no kernel launched;
   the scoring forward called with gradients on raises (autograd cannot
   see a kernel launch). (b) apps.train.main at --batch 8 and at --batch
   64 (--frames 100 --synthetic 256 --device-data, 30 steps each): the
   loss falls, no kernel launches; the median step time on CUDA events and
   on the host clock, the kernels a step and the card's busy share from
   torch.profiler over 3 more steps, the peak memory. (c) A run resumed
   from a checkpoint at step 15 writes the straight run's weights bit for
   bit. (d) The trained weights written as .onnx, loaded through
   load_denoiser: their scoring forward against the trainer's forward
   (GRU_TOL), the slice through BatchRunner (one gru_stack and one
   scan_windows a run), and an eval-only --eval run from the checkpoint
   (kernel 1 a chunk) within 0.05 dB of the CPU's evaluate.
17. The remaining precision tiers. (a) Kernel A (gru_gates_3x, the bf16_3x
   recurrence on the tensor cores: csrc/gru_gates_p.cu with a bf16 pass
   count a product class, 1 at 'default' and 3 at 'high') at (gru_i, gru_h)
   levels (high, high), (default, high) and (high, default) against its
   plain version at [1,680, 54], [42, 54], [37, 54] and [4,000, 54] (one
   launch each) and at [42, 1] from a nonzero state, and all-high on N(0,
   0.8) gi: max |d| <= A_HIGH_TOL, or phase 8's bf16 bars where a class is
   'default' (h rounded to bf16 where it enters those products), and over
   54 steps nearer its plain version (mean |d|) than the plain versions at
   all-'highest' and at the two classes swapped; each instantiation's plan
   (clusters of 5 CTAs), exchange L2 bytes, single and queued time, plain
   time and bound at [1,680, 54], beside kernel 1's float32 time and
   cuDNN's float32 GRU (TF32 off: another function) in the same process,
   and its single and queued times, bounds and L2 bytes at [42, 54], [42, 1]
   from a state and [4,000, 54]. (b) Kernel B (gru_stack_mixed,
   csrc/gru_mixed.cu: kernel 1's tiles with the class at 'high' or
   'default' on mma.sync): the stage audit's two mixes (one class at
   'high') at the same shapes, bar B_HIGH_TOL and control, the two with
   'default' at [1,680, 54]; times and bounds (a 'highest' class at the
   float32 rate, a 'high' or 'default' one as its bf16 passes at the
   tensor cores') of all four at [1,680, 54], [42, 54] and [42, 1] from a
   state, each instantiation's registers and local (spill) bytes, and with
   CHIP_SMOKE_PARENT the parent's kernel B beside this one. (c)
   Kernel 1 and kernel 5 in bf16 on fixed inputs give the parent tree's
   bits (PARENT_DIGESTS, for the nvcc release that recorded them; with
   CHIP_SMOKE_PARENT the parent's package built beside this one); it fails
   where it can compare with neither. (d)
   The high slice through BatchRunner: 1 kernel-A launch a run, no
   gru_stack, segments within one FSM window of the float tier's, its wall
   beside phase 11's. (e) The int8 slice under bf16 storage: 167 kernel-3
   launches a run, segments within one window. (f) lbr = 0 weights at
   'default' and under bf16 storage on the card against the CPU, no kernel
   launch, over LBR0_SEEDS, twice each (bit for bit): the demo weights
   within the CPU tests' bars, the biased weights within the max bar and
   their mean (ROADMAP fault 3's rounding cascade) within LBR0_WITNESS_X
   times that of the CPU's forward with float64 sums. (g) The stage audit (tools/stage_precision_audit.py's main, in
   this process so that its launches count): 7 stage rows, kernel B under
   the gru_i and gru_h rows, kernel A under all-high.
18. The data mesh on the card (parallel/mesh.py), its shards repeating
   cuda:0. (a) BatchRunner on the slice over 2 and 4 shards (padded to 22
   and 24 streams): segments identical to phase 4's, one gru_stack and one
   scan_windows launch a shard a run, every shard's model, inputs and FSM
   outputs on its shard's device, the wall beside phase 4's. (b) SlabRunner
   on phase 10's race corpus over 2 shards: segments identical to phase
   10's, no synchronising call from the first dispatch to the fetches,
   one fetch a shard after the last slab. (c) OnlineBatchServer on phase
   13's 256-stream fleet over 2 shards x microbatch 2 against the
   unsharded fleet: segments, recordings, decisions and indices bit for
   bit, float outputs within SERVE_ROWS_TOL; tick p50 beside phase 13's.
   (d) Two processes on the card, joined by gloo
   (formula_vad_tpu_torch.testing.distributed, LOCAL_DEVICES=2: a mesh of
   4) on the slice: segments equal to each other's and (a)'s, kernels 1
   and 2 launched twice in each; their wall beside (a)'s.
19. The trainer's ("data", "model") grid (train/nsnet2_train.py's
   Megatron layout, apps/train.py --tp), its devices repeating cuda:0.
   (a) From the same weights, on phase 16's pool and batch draws at
   [8, 100] and [64, 100], GRID_STEPS (20) steps of the unsharded train
   step and of the sharded one on the (1, 2), (2, 1), (2, 2) and (1, 4)
   grids: the first step's gradients within 1e-4 of each array's largest
   element, the losses at rtol 1e-4 and falling, no kernel launched; each
   one's median step on CUDA events and the host clock, peak memory, and
   from one step under torch.profiler (the card's activity only) the
   device's busy share and kernels a step, beside phase 16's step.
   (b) apps.train --tp 2 on a 2 x 2 grid (its grid_devices patched): a
   run resumed from a checkpoint writes the straight run's weights bit for
   bit, and the checkpoint loads into an unsharded run with identical
   parameters. (c) That run's --eval within QUALITY_TOL_DB of the CPU's
   evaluate (kernel 1 a chunk), and the weights through load_denoiser on
   the slice: one launch of kernels 1 and 2, segments identical with the
   host decoder.

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
card's peak for their type (67 TFLOP/s float32 without tensor cores,
989 TFLOP/s bf16 and 1,979 TOP/s int8 tensor cores), the H100 SXM
data-sheet rates.

The last two lines of stdout are a JSON line describing each kernel and
the final {"ok": true, "device": ...} line. Exits non-zero, printing no
result, when no CUDA device is visible or the package is missing.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
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
# Phase 3's shapes: the slice's; 20-minute streams (the long ring wraps,
# many tiles); five rows an SM (two waves of at most four).
FSM_SHAPES = ((FSM_ROWS, FSM_WINDOWS), (FSM_ROWS, 56_250), (660, FSM_WINDOWS))
FSM_BIG_LONG_WINDOW = 60_000  # a long ring above the shared-memory budget: the global body
# Loop-carried cycles a window of the smem body's long-ring chain, counted
# once by hand in the SASS of csrc/fsm_scan.cu (cuobjdump -sass, the met
# lane's loop): 13 dependent ALU instructions over two windows (q(w-1) ->
# FSEL long_last, FSEL base, FMUL, FSETP, FSETP, ISETP push(w) -> FSEL old,
# FADD v, y, t, FFMA x 3 -> q(w)), at an assumed 4 cycles each. A fixed
# count, not read from the build: phase 3 logs the chain bound from it and
# prints it in no JSON line. Recount it after any edit of that loop.
FSM_CHAIN_CYCLES = 26
SLICE_STREAMS, SLICE_SECONDS = 21, 20.0
CORPUS_STREAMS = 3  # the simulator runs' corpus: 3 streams x 20 s
GRU_TOL = 1e-4
RAGGED = [(n, t) for n in (1, 37, 1690, 4000) for t in (1, 54)]  # ragged and multi-wave GRU shapes
GRU_EARLIER_MS = 13.48  # the GRU kernel's earlier design (one block per 16 rows) at [1680, 54], 700 W H100; log only
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9  # float32 outside the tensor cores: 67 TFLOP/s
INT8_OPS_PER_MS = 1979e9  # int8 tensor cores, dense: 1,979 TOP/s
BF16_OPS_PER_MS = 989e9  # bf16 tensor cores, dense: 989 TFLOP/s
BF16_MEAN, BF16_MAX = 3e-5, 6e-3  # the bf16 forms' bars against their plain versions (phase 8)
Q8_STEPS = 54  # GRU steps per chunk: 3 in-scan int8 products each


def q8_shapes(rows: int, steps: int = Q8_STEPS, head_frames: int = 50) -> tuple:
    """The int8 tier's products in a forward of ``rows`` GRU rows x ``steps``
    frames: (name, R, K, N, launches per forward, epilogue order, with a
    per-row scale). The head runs on the last ``head_frames`` frames only
    (a chunk's 50; a low-latency hop's 1)."""
    frames, head = rows * steps, rows * head_frames
    return (
        ("fc_in", frames, 161, 400, 1, "row_col", True),
        ("gi1", frames, 400, 1200, 1, "row_col", True),
        ("in_scan", rows, 400, 1200, 3 * steps, "col_row", False),
        ("ff1", head, 400, 600, 1, "col_row", False),
        ("ff2", head, 600, 600, 1, "row_col", True),
        ("out", head, 600, 161, 1, "row_col", True),
    )


Q8_SHAPES = q8_shapes(GRU_ROWS)  # the slice's: 1,680 rows
Q8_LAUNCHES = sum(shape[4] for shape in Q8_SHAPES)  # 167
WINDOW_SEC = 1024 / 48000  # one FSM window
# Phase 10, the slab path: 21 streams a little short of 5 slabs of 64 s
# (320 s) as PCM16 WAV, ragged: no stream ends on a slab edge, each inside
# a chunk. The device-side slab is a 90-minute race's; the slab count is cut.
SLAB_STREAMS, SLAB_COUNT, SLAB_CHUNKS = 21, 5, 128
SLAB_LENGTHS = [SLAB_COUNT * SLAB_CHUNKS * 24000 - 4_801 - 37_017 * i for i in range(SLAB_STREAMS)]
SLAB_ROWS = SLAB_STREAMS * 2 * SLAB_CHUNKS  # GRU rows a slab: 5,376
ONE_SHOT_STREAMS = 4  # the one-shot runs that hold phase 10's first streams whole
PEAK_TOL = 0.05  # peak device memory: 5 slabs within 5% of 2 slabs
SLAB_CORPUS_SECONDS = 40.0  # phase 10's simulator corpus: 3 streams, 16 s slabs
# Phase 11: (tier, matmul level, io dtype, the wrapper of its recurrence).
TIER_RUNS = (
    ("float", "highest", "f32", "gru_stack"),
    ("high", "high", "f32", "gru_gates_3x"),
    ("bf16", "default", "f32", "gru_gates_p"),
    ("bf16_io", "default", "bf16", "gru_gates_f"),
)
CAMPAIGN_CASES, CAMPAIGN_CHUNKS = 240, 16  # the JAX package's chip-table size (benchmarks/tier_fuzz.py)
CAMPAIGN_ROWS = 2 * CAMPAIGN_CHUNKS  # one stereo stream of 16 chunks: GRU rows a forward
# Campaign cases in which `high` is known to move a boundary (ROADMAP §3
# item 6): near-ties whose decision margin, 3e-6 to 1e-5 of the window
# volume, lies within bf16_3x's ~16 bits a product (found on the CPU).
HIGH_KNOWN_TIES = (104,)
# Phase 8, ROADMAP §3 fault 3 step 3: tests/test_torch_gru_gates.py's random
# gi (N(0, 0.8), numpy seed 100, 8 rows x 54 steps) and its pre-flip bar.
PRE_FLIP_ROWS, PRE_FLIP_STEPS, PRE_FLIP_MEAN = 8, 16, 1e-5
# Phase 12: chunk steps a streaming run of the slice (20 s / 0.5 s); GRU
# rows a chunk step of one stereo stream (AudioPipeline) and of the slice.
STREAM_CHUNKS = int(SLICE_SECONDS / 0.5)
STREAM_ROWS = (2, 2 * SLICE_STREAMS)
PIPELINE_SECONDS = 60.0
# (tier, matmul level, io dtype, quant, the wrapper of its recurrence, its launches a chunk step)
STREAM_TIERS = (
    ("float", "highest", "f32", "off", "gru_stack", 1),
    ("bf16", "default", "f32", "off", "gru_gates_p", 1),
    ("bf16_io", "default", "bf16", "off", "gru_gates_f", 1),
    ("int8", "highest", "f32", "int8", "matmul_q8", Q8_LAUNCHES),
)
# Phase 13, serving: the large fleet (512 GRU rows a tick), the ragged
# fleet with its reset and checkpoint ticks, and the bar for float outputs
# between runs whose steps have other row counts (cuBLAS picks its GEMM
# kernels by shape, so their sums may round otherwise).
SERVE_BIG_STREAMS, SERVE_BIG_TICKS = 256, 8
SERVE_RAGGED_STREAMS, SERVE_RESET_TICK, SERVE_SAVE_TICK = 4, 10, 20
SERVE_ROWS_TOL = 1e-5
# Phase 14: the low-latency mode on the slice's 21 streams x 2 channels
# (2,000 hops of 10 ms in one run; LL_STEPS chained steps), the GRU rows of a
# hop of the slice and of 4,096 streams, the scale curve's stream counts;
# the sweep's 4 x 2 grid of alternative machines, the base config (10, 0.5)
# among them, and the tuner's grid on phase 5's corpus.
LL_HOP, LL_STEPS, LL_TOL = 480, 200, 1e-5
# Phase 18: the shard counts of the slice's mesh runs, and how long the
# two-process run may take (both processes start, build nothing, score).
MESH_SHARDS = (2, 4)
MESH_PROCESS_TIMEOUT = 300
LL_ROWS = (2 * SLICE_STREAMS, 8192)
LL_SCALE = (64, 256, 1024, 4096)
# (tier, matmul level, io dtype, quant, the wrapper of its recurrence, its launches a step)
LL_TIERS = (
    ("float", "highest", "f32", "off", "gru_stack", 1),
    ("high", "high", "f32", "off", "gru_gates_3x", 1),
    ("bf16", "default", "f32", "off", "gru_gates_p", 1),
    ("bf16_io", "default", "bf16", "off", "gru_gates_f", 1),
    ("int8", "highest", "f32", "int8", "matmul_q8", 8),
)
SWEEP_FACTORS, SWEEP_RATIOS = (6.0, 10.0, 14.0, 20.0), (0.3, 0.5)
SWEEP_BASE = SWEEP_FACTORS.index(10.0) * len(SWEEP_RATIOS) + SWEEP_RATIOS.index(0.5)
TUNE_GRID = "speech_threshold_factor=3,10,40"
# Phase 17: the remaining precision tiers. Kernel A's and kernel B's
# (gru_i, gru_h) levels, the shapes both are held at beside a hop with a
# carried state, and the first 16 hex digits of the SHA-256 of the
# unchanged instantiations' outputs on fixed inputs (``unchanged_outputs``),
# recorded from the parent tree's build on an H100 80GB HBM3 with the nvcc
# release PARENT_DIGESTS_NVCC (the call that set them built both trees in
# one process: CHIP_SMOKE_PARENT names a checkout, whose package is then
# loaded beside this one and compared directly). Another compiler may
# schedule the float operations otherwise, so the digests bind that
# release only: under another, phase 17 (c) fails unless CHIP_SMOKE_PARENT
# names a parent checkout to build beside this one.
A_LEVELS = (("high", "high"), ("default", "high"), ("high", "default"))
B_LEVELS = (("high", "highest"), ("highest", "high"), ("default", "highest"), ("highest", "default"))
P17_SHAPES = ((GRU_ROWS, GRU_STEPS), (2 * SLICE_STREAMS, GRU_STEPS), (37, GRU_STEPS), (4000, GRU_STEPS))
PARENT_DIGESTS = {"gru_stack": "143c13b930fcb4e9", "gru_gates_p": "a2fb60ac32cc8cb0"}
PARENT_DIGESTS_NVCC = "Build cuda_12.9.r12.9/compiler.36037853_0"
# Kernel A's and kernel B's bars against their plain versions where no
# class is 'default', from their readings on an H100 (A at all-'high' max
# 2.9e-6, B at a 'high' mix 1.2e-6, over P17_SHAPES): a 'high' and a
# 'highest' product differ by only ~2^-16, so the plain versions at other
# levels lie within 3e-6 to 6e-6 of each other; ``nearer_own_levels``
# tells them apart.
A_HIGH_TOL, B_HIGH_TOL = 5e-6, 2e-6
# Phase 17 (f): the feature seeds that lbr = 0 weights run on, twice each
# on the card; the biased weights' card-against-CPU mean |d| is held to
# LBR0_WITNESS_X times the largest that float64 sums of the same products
# (``f64_sums``, another summation order on the CPU) stand from the CPU.
LBR0_SEEDS, LBR0_WITNESS_X = (7, 8, 9, 10), 2.0
# Phase 15: the gate's fleet (ticks of the slice's 21 streams), and
# denoise_quality.evaluate's held-out pairs with the JAX package's floors
# (demo: mean and each pair; the gate: mean) and the card-against-CPU bar.
GATE_TICKS = 8
QUALITY_PAIRS, QUALITY_SECONDS = 2, 16.0
DEMO_FLOOR_DB, DEMO_PAIR_FLOOR_DB, GATE_FLOOR_DB, QUALITY_TOL_DB = 15.0, 10.0, 3.0, 0.05


# Phase 16: training. Batches of the two runs (the CLI's default and 64),
# the frames a window and the synthetic pool; steps a run, steps profiled,
# the step a resumed run restarts from; the card-against-CPU gradient bar.
TRAIN_BATCHES, TRAIN_FRAMES, TRAIN_POOL = (8, 64), 100, 256
TRAIN_STEPS, TRAIN_PROFILED, TRAIN_RESUME_AT = 30, 3, 15
TRAIN_GRAD_TOL = 1e-4
# Phase 19: the trainer's grid. Grids (data rows, model columns) of cuda:0
# repeated; steps a run (on phase 16's pool and batch draws, at each of
# TRAIN_BATCHES; a run then takes one step under torch.profiler); the loss
# bar against the unsharded step; the resume run's steps and its
# checkpoint step.
GRID_SHAPES = ((1, 2), (2, 1), (2, 2), (1, 4))
GRID_STEPS, GRID_LOSS_RTOL = 20, 1e-4
GRID_RESUME_STEPS, GRID_RESUME_AT = 4, 2


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
    from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_gates_cuda
    from formula_vad_tpu_torch.ops import matmul_q8
    from formula_vad_tpu_torch.pipeline import fsm_cuda
    from formula_vad_tpu_torch.tools import card

    smi = card()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one nvcc per source, all at once
        libs = (nsnet2_cuda._lib, nsnet2_cuda._mixed_lib, fsm_cuda._lib, matmul_q8._lib, nsnet2_gates_cuda._lib)
        for build in [pool.submit(lib) for lib in libs]:
            build.result()
    log(f"kernel build + load (parallel): {time.perf_counter() - t0:.2f} s")
    for name, (secs, report) in _build.build_info.items():
        lines = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: nvcc {secs:.2f} s; " + " | ".join(lines))
    return smi


def biased_net(dev):
    """The random-init network with random GRU biases (N(0, 0.3), numpy seed
    3): the packaged and the random weights have biases of ~0.005 and 0, too
    small for the checks to see a kernel that drops or misplaces one (for
    instance one that indexes a bias by the column within its tile). Each
    such fault moves the plain bf16 kernel-5 output's mean |dh2| by 8e-3 or
    more at 64 rows, 280x the BF16_MEAN bar."""
    import torch

    from formula_vad_tpu_torch.models.registry import load_denoiser

    net = load_denoiser("random", device=dev)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for g in (net.gru1, net.gru2):
            for b in (g.bi, g.bh):
                b.copy_(torch.from_numpy(rng.normal(0.0, 0.3, tuple(b.shape)).astype(np.float32)))
    return net


def phase_gru(net, dev) -> dict:
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms

    plan = nsnet2_cuda.device_plan(GRU_ROWS, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"GRU launch plan at {GRU_ROWS} rows on {sms} SMs: {plan.tiles} tiles of {plan.row_tile} rows x "
        f"{plan.unit_tile} units ({plan.row_groups} x {plan.unit_groups} groups), grid {plan.grid}")
    last_wave = plan.tiles - (-(-plan.tiles // plan.grid) - 1) * plan.grid
    if last_wave < 0.9 * sms:
        raise AssertionError(f"the GRU plan's last wave leaves SMs idle: {last_wave} CTAs on {sms} SMs, {plan}")
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(-3.0, 1.5, (GRU_ROWS, GRU_STEPS, 161)).astype(np.float32)).to(dev)
    gru = cudnn_gru(net, dev)
    err = 0.0
    with torch.inference_mode():
        x = net.fc_in(feats)
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
        got = nsnet2_cuda.gru_stack(net, gi1)
        # The scoring shape on both weight sets, then ragged and multi-wave
        # row counts (a partial last row group; one tile of one row; 3
        # waves) at 1 and 54 steps.
        for label, weights in (("demo", net), ("biased", biased_net(dev))):
            for n, t in [(GRU_ROWS, GRU_STEPS)] + RAGGED:
                g = gi1 if (n, t) == (GRU_ROWS, GRU_STEPS) else torch.from_numpy(
                    (rng.standard_normal((n, t, 1200)) * 0.8).astype(np.float32)).to(dev)
                out = nsnet2_cuda.gru_stack(weights, g)
                want = nsnet2_cuda.gru_stack_reference(weights, g)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"GRU kernel produced non-finite values at [{n}, {t}], {label} weights")
                e = float((out - want).abs().max())
                log(f"GRU kernel vs plain at [{n}, {t}], {label} weights: max |dh2| = {e:.3e} (tolerance {GRU_TOL})")
                if not e <= GRU_TOL:
                    raise AssertionError(f"GRU kernel disagrees with its plain version at [{n}, {t}], {label}: {e}")
                err = max(err, e)
        ms = cuda_ms(lambda: nsnet2_cuda.gru_stack(net, gi1))
        plain_ms = cuda_ms(lambda: nsnet2_cuda.gru_stack_reference(net, gi1))
        lib_err = float((gru(x)[0] - got).abs().max())
        log(f"cuDNN GRU vs the kernel: max |dh2| = {lib_err:.3e}")
        if not lib_err <= GRU_TOL:
            raise AssertionError(f"the cuDNN yardstick computes another function: {lib_err} > {GRU_TOL}")
        library_ms = cuda_ms(lambda: gru(x))
        # Single calls (above) also time the host's work before the launch;
        # calls queued back to back time the device alone.
        queued = {name: queued_ms(fn) for name, fn in (("kernel", lambda: nsnet2_cuda.gru_stack(net, gi1)),
                                                       ("cuDNN", lambda: gru(x)))}
    ops = 3 * 2 * GRU_ROWS * 400 * 1200 * GRU_STEPS
    weights = (net.gru1.wh, net.gru1.bh, net.gru2.wi, net.gru2.bi, net.gru2.wh, net.gru2.bh)
    nbytes = gi1.nbytes + got.nbytes + sum(w.nbytes for w in weights)
    bound_ms, bound_by = bound(nbytes, ops, F32_OPS_PER_MS)
    log(f"GRU [{GRU_ROWS}, {GRU_STEPS}]: kernel {ms:.3f} ms ({ops / 1e9 / ms:.2f} TFLOP/s; the earlier design "
        f"{GRU_EARLIER_MS} ms), plain {plain_ms:.3f} ms, cuDNN GRU {library_ms:.3f} ms; bound {bound_ms:.3f} ms "
        f"by {bound_by} ({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"GRU [{GRU_ROWS}, {GRU_STEPS}] queued back to back: kernel {queued['kernel']:.3f} ms "
        f"({ops / 1e9 / queued['kernel']:.2f} TFLOP/s), cuDNN GRU {queued['cuDNN']:.3f} ms")
    return {
        "name": "gru_stack", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/gru_stack.cu",
        "replaces": "formula_vad_tpu/models/nsnet2_pallas.py:88", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "grid": plan.grid, "tiles": plan.tiles, "row_tile": plan.row_tile, "unit_tile": plan.unit_tile,
        "queued_ms": queued["kernel"], "library_queued_ms": queued["cuDNN"],
    }


def check_lbr0(dev) -> None:
    """Weights with linear_before_reset = 0 score on the card through the
    plain per-step loop (the GRU kernel takes lbr = 1 only, as the JAX
    package's Pallas kernel does): gains within GRU_TOL of the CPU's, and
    no GRU-kernel launch."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda

    cpu = torch.device("cpu")
    nets = {d: biased_net(d) for d in (dev, cpu)}
    for net in nets.values():
        net.gru1.linear_before_reset = net.gru2.linear_before_reset = 0
    feats = torch.from_numpy(np.random.default_rng(7).normal(-3.0, 1.5, (42, GRU_STEPS, 161)).astype(np.float32))
    before = nsnet2_cuda.gru_stack.launches
    with torch.inference_mode():
        got = nets[dev](feats.to(dev), out_frames=50).cpu()
        want = nets[cpu](feats, out_frames=50)
    launched = nsnet2_cuda.gru_stack.launches - before
    e = float((got - want).abs().max()) if bool(torch.isfinite(got).all()) else float("inf")
    log(f"lbr = 0 weights on the card (plain per-step loop): gains {list(got.shape)} vs the CPU's max |d| = {e:.3e} "
        f"(tolerance {GRU_TOL}), gru_stack launches {launched}")
    if not (e <= GRU_TOL and launched == 0):
        raise AssertionError(f"lbr = 0 weights on the card: max |d| {e}, {launched} gru_stack launches")


def _fsm_equal(got, got_carry, out, carry) -> float:
    """Raise unless the kernel's seven outputs and carry equal ``out`` and
    ``carry`` (numpy or tensors) bit for bit; the largest float difference."""
    import torch

    err = 0.0
    for field, a, b in zip(got._fields, got, out):
        a, b = a.cpu().numpy(), np.asarray(b.cpu().numpy() if torch.is_tensor(b) else b)
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"output {field}")
        if a.dtype.kind == "f":
            err = max(err, float(np.max(np.abs(a - b))))
    for key in got_carry:
        a = got_carry[key].cpu().numpy()
        b = carry[key].cpu().numpy() if torch.is_tensor(carry[key]) else carry[key]
        if a.tobytes() != np.ascontiguousarray(b).tobytes():
            raise AssertionError(f"carry {key}")
    return err


def sm_clock_mhz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm), for the chain bound."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.split()[0])


def phase_fsm(st, dev) -> dict:
    import torch

    from formula_vad_tpu_torch.pipeline import fsm_cuda, fsm_host
    from formula_vad_tpu_torch.testing.synth import fsm_inputs
    from formula_vad_tpu_torch.tools import cuda_ms, host_us, queued_ms

    shape, params = st.fsm_shape, st.fsm_params
    mhz = sm_clock_mhz()
    rows_out, entry = [], None
    for rows, windows in FSM_SHAPES:
        mv, vr, valid = fsm_inputs(rows, windows, seed=0)
        args = [torch.from_numpy(x).to(dev) for x in (mv, vr, valid)]
        got, got_carry = fsm_cuda.scan_windows(shape, params, *args)
        plan = fsm_cuda.scan_windows.last_plan
        fsm_host.scan_windows_host(shape, params, mv[:1, :8], vr[:1, :8], valid[:1, :8])  # builds the library
        t0 = time.perf_counter()
        host, host_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        events = np.bincount(host.event.reshape(-1), minlength=4)
        log(f"FSM [{rows}, {windows}] events none/started/completed/aborted: {events.tolist()}")
        if not (events[1:] > 0).all():
            raise AssertionError("FSM inputs did not visit every transition")
        others = [("host decoder", host, host_carry)]
        if (rows, windows) == (FSM_ROWS, FSM_WINDOWS):  # the plain version's loop is too slow beyond
            others.append(("plain version", *fsm_cuda.scan_windows_reference(shape, params, *args)))
        err = 0.0
        for other_name, out, carry in others:
            try:
                err = max(err, _fsm_equal(got, got_carry, out, carry))
            except AssertionError as e:
                raise AssertionError(f"FSM kernel != {other_name} at [{rows}, {windows}] on {e}") from None
            log(f"FSM kernel == {other_name} at [{rows}, {windows}]: all 7 outputs and the carry, bit for bit")

        def fresh():
            return fsm_cuda.scan_windows(shape, params, *args)

        ms = cuda_ms(fresh)
        # The split of a single call: calls queued back to back; calls that
        # continue a carry (rings loaded instead of filled); and the host's
        # time per wrapper call, launches not waited for.
        queued = queued_ms(fresh)
        chained_ms = cuda_ms(lambda: fsm_cuda.scan_windows(shape, params, *args, carry=got_carry))
        host_call_us = host_us([fresh])[0]
        # Inputs read once, outputs written once, the carry read and written.
        nbytes = sum(x.nbytes for x in args) + sum(x.nbytes for x in got) + 2 * sum(x.nbytes for x in got_carry.values())
        bound_ms, bound_by = bound(nbytes, 0, F32_OPS_PER_MS)
        chain_ms = FSM_CHAIN_CYCLES * windows / (mhz * 1e3)
        row = {"rows": rows, "windows": windows, "body": plan.body, "ctas": plan.ctas, "tile": plan.tile,
               "tiles": plan.tiles, "smem_bytes": plan.smem_bytes,
               "ms": ms, "queued_ms": queued, "chained_ms": chained_ms, "host_call_ms": host_call_us / 1e3,
               "ns_per_window": queued / windows * 1e6, "host_decoder_ms": host_ms, "bound_ms": bound_ms}
        rows_out.append(row)
        log(f"FSM [{rows}, {windows}] plan: {plan.body} body, {plan.ctas} CTAs of {plan.threads} threads, "
            f"tile {plan.tile} windows ({plan.tiles} a row), {plan.smem_bytes} B shared a CTA")
        log(f"FSM [{rows}, {windows}]: single call {ms:.4f} ms, queued back to back {queued:.4f} ms "
            f"({row['ns_per_window']:.1f} ns a window), continuing a carry {chained_ms:.4f} ms; host time of a "
            f"wrapper call {host_call_us:.1f} us; host decoder {host_ms:.3f} ms; bytes bound {bound_ms * 1e3:.2f} us "
            f"({nbytes / 1e6:.2f} MB); chain bound {chain_ms * 1e3:.2f} us ({FSM_CHAIN_CYCLES} cycles a window, a "
            f"fixed count from the SASS, at {mhz:.0f} MHz)")
        if entry is None:
            plain_ms = cuda_ms(lambda: fsm_cuda.scan_windows_reference(shape, params, *args), reps=3)
            log(f"FSM [{rows}, {windows}]: plain version {plain_ms:.3f} ms")
            entry = {
                "name": "scan_windows", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/fsm_scan.cu",
                "replaces": "formula_vad_tpu/pipeline/fsm_pallas.py:339", "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "queued_ms": queued, "chained_ms": chained_ms, "host_call_ms": host_call_us / 1e3,
                "body": plan.body,
                "plan": {"ctas": plan.ctas, "threads": plan.threads, "tile": plan.tile, "tiles": plan.tiles,
                         "smem_bytes": plan.smem_bytes},
            }
    # Rings above the shared-memory budget take the global body (counted apart).
    big_shape, big_params = st.fsm_shape._replace(long_window=FSM_BIG_LONG_WINDOW), params
    mv, vr, valid = fsm_inputs(4, 600, seed=1)
    before = fsm_cuda.scan_windows.launches_by_body["global"]
    got, got_carry = fsm_cuda.scan_windows(big_shape, big_params, *(torch.from_numpy(x).to(dev) for x in (mv, vr, valid)))
    host, host_carry = fsm_host.scan_windows_host(big_shape, big_params, mv, vr, valid)
    if fsm_cuda.scan_windows.launches_by_body["global"] != before + 1:
        raise AssertionError("a long ring above the shared-memory budget did not take the global body")
    _fsm_equal(got, got_carry, host, host_carry)
    log(f"FSM global body (long ring of {FSM_BIG_LONG_WINDOW} slots) at [4, 600] == host decoder, bit for bit")
    entry["shapes"] = rows_out
    return entry


def slice_audio() -> np.ndarray:
    """The slice, from the one definition that phase 18(d)'s workers score too."""
    from formula_vad_tpu_torch.testing import distributed

    if (distributed.SLICE_STREAMS, distributed.SLICE_SECONDS) != (SLICE_STREAMS, SLICE_SECONDS):
        raise AssertionError("the worker's slice is not the one this script sizes its phases by")
    return distributed.slice_batch()[0]


def reset_counts(counters) -> None:
    """Set each kernel wrapper's launch counters to 0."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_body"):
            fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)


def timed_runs(runner, audio, counters) -> tuple[list, list[float], dict]:
    """One warm-up run, then the counters set to 0 and three timed runs:
    (results, walls in s, launches counted over the three)."""
    import torch

    def run():
        res = runner.run(audio)
        torch.cuda.synchronize()
        return res

    run()  # warm-up
    reset_counts(counters)
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
    log(f"slice launches over 3 runs: {launches}; scan_windows by body {fsm_cuda.scan_windows.launches_by_body}")
    if fsm_cuda.scan_windows.launches_by_body["smem"] != launches["scan_windows"]:
        raise AssertionError("the slice's FSM did not run the shared-memory body")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    launches["scan_windows_by_body"] = dict(fsm_cuda.scan_windows.launches_by_body)
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


def run_simulators(corpus: str, plans: dict[str, tuple]) -> dict[str, str]:
    """Run the simulator entry point once per plan name -> (device, extra
    environment[, extra arguments]); returns each run's output directory."""
    outs = {}
    for name, (dev, extra_env, *extra_args) in plans.items():
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **extra_env)
        cmd = [sys.executable, "-m", "formula_vad_tpu_torch.apps.simulator", "-i", os.path.join(corpus, f"plan_{name}.json")]
        cmd += [arg for args in extra_args for arg in args]
        if dev == "cpu":
            cmd += ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"simulator plan {name} (--device {dev}, {extra_env}) failed:\n{proc.stderr[-4000:]}")
        (run_dir,) = os.listdir(os.path.join(corpus, f"out_{name}"))
        outs[name] = os.path.join(corpus, f"out_{name}", run_dir)
        tier = " ".join([*(f"{k}={v}" for k, v in extra_env.items()), *(a for args in extra_args for a in args)])
        log(f"simulator plan {name} (--device {dev}, {tier or 'default tier'}): {time.perf_counter() - t0:.1f} s")
    return outs


def read_text(run_dir: str, name: str) -> str:
    with open(os.path.join(run_dir, name)) as f:
        return f.read()


def phase_entry_point(corpus: str) -> str:
    """-> the cuda run's output directory."""
    outs = run_simulators(corpus, {"cuda": ("cuda", {}), "cpu": ("cpu", {})})
    for name in ["report.txt"] + [f"s{i}-audacity.txt" for i in range(CORPUS_STREAMS)]:
        texts = {dev: read_text(outs[dev], name) for dev in outs}
        if texts["cuda"] != texts["cpu"]:
            log(f"--- {name} differs between --device cuda and --device cpu:")
            log(f"cuda:\n{texts['cuda']}\ncpu:\n{texts['cpu']}")
            raise AssertionError(f"{name} differs between the cuda and cpu simulator runs")
    log("simulator segments identical on cuda and cpu; s0: "
        + read_text(outs["cuda"], "s0-audacity.txt").strip().replace("\n", " | "))
    return outs["cuda"]


def q8_product(dev, seed: int, name: str, r: int, k: int, n: int, per_forward: int, order: str,
               with_row: bool) -> dict:
    """The int8 matmul kernel against its plain version at one product's
    shape (random operands, generator ``seed``): bit for bit, for both
    epilogue orders and float32 and bfloat16 output; the path and tile plan
    the wrapper picks; device times (CUDA-graph replays) beside the bound and
    torch._int_mm (cuBLASLt) plus the epilogue, which needs more than 16
    rows (else null), and the host time of a wrapper call."""
    import torch

    from formula_vad_tpu_torch import tools
    from formula_vad_tpu_torch.ops import matmul_q8 as mq
    from formula_vad_tpu_torch.tools import graph_ms

    gen = torch.Generator(device=dev).manual_seed(seed)
    a8 = torch.randint(-127, 128, (r, k), dtype=torch.int8, device=dev, generator=gen)
    b8 = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
    scale = torch.rand(n, device=dev, generator=gen) * 1e-3
    bias = torch.randn(n, device=dev, generator=gen)
    row = torch.rand((r, 1), device=dev, generator=gen) * 2.0
    w = mq.Q8Weight.pack(b8, scale, bias)
    rs = row if with_row else None
    err = 0.0
    with torch.inference_mode():
        for check_order in mq.ORDERS:
            for dtype in mq.OUT_DTYPES:
                got = mq.matmul_q8(a8, w, row, order=check_order, out_dtype=dtype)
                want = mq.matmul_q8_reference(a8, w, row, order=check_order, out_dtype=dtype)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"int8 matmul kernel != plain at {name} [{r}, {k}] x [{k}, {n}] "
                                         f"{check_order} {dtype}")
                err = max(err, float((got.float() - want.float()).abs().max()))

        def kernel():
            return mq.matmul_q8(a8, w, rs, order=order)

        kernel()
        path = mq.matmul_q8.last_path  # the path the wrapper picks for the path's call
        library = None
        if r > 16:  # torch._int_mm takes more than 16 rows
            # cuBLASLt's int8 GEMM (K and N padded to multiples of 8), then
            # the same epilogue as torch ops.
            k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
            a_pad = torch.zeros((r, k8), dtype=torch.int8, device=dev)
            a_pad[:, :k] = a8
            bt_pad = torch.zeros((n8, k8), dtype=torch.int8, device=dev)
            bt_pad[:n, :k] = w.qt[:, :k]

            def library():
                out = torch._int_mm(a_pad, bt_pad.t())[:, :n].to(torch.float32)
                return (out * row if with_row else out) * w.scale + w.bias

            if not torch.equal(library(), kernel()):
                raise AssertionError(f"the library yardstick computes another function at {name}")
        # Device times from CUDA-graph replays (several launches per replay
        # where the output is small), so the host's launch cost stays out;
        # that cost is timed apart, on the host clock.
        per_replay = 20 if per_forward > 1 or r * n < 1 << 20 else 2
        ms = graph_ms(kernel, per_replay)
        plain_ms = graph_ms(lambda: mq.matmul_q8_reference(a8, w, rs, order=order), per_replay)
        library_ms = None if library is None else graph_ms(library, per_replay)
        (host_us,) = tools.host_us([kernel])
    nbytes = r * k + k * n + 4 * r * n + 8 * n + (4 * r if with_row else 0)
    bound_ms, bound_by = bound(nbytes, 2 * r * k * n, INT8_OPS_PER_MS)
    plan = path.plan
    plan_info = None if plan is None else {"bn": plan.bn, "tiles": plan.tiles, "grid": plan.grid, "waves": plan.waves}
    tiles = "" if plan is None else (f", tiles 128 x {plan.bn}, {plan.tiles} tiles on {plan.grid} CTAs "
                                     f"({plan.waves} a CTA)")
    lib_text = "null (16 rows or fewer)" if library_ms is None else f"{library_ms * 1e3:.1f} us"
    log(f"int8 matmul {name} [{r}, {k}] x [{k}, {n}] ({order}{', row scale' if with_row else ''}, x{per_forward} "
        f"per forward): bit for bit; path {path.name}{tiles}, A loads {path.a_vec} B, "
        f"{'16-byte' if path.out_vec else 'element'} stores; kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
        f"torch._int_mm + epilogue {lib_text}; bound {bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} MB); "
        f"host time of a wrapper call {host_us:.1f} us")
    return {"name": name, "rkn": [r, k, n], "per_forward": per_forward, "path": path.name,
            "plan": plan_info, "a_vec": path.a_vec, "out_vec": path.out_vec, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "host_us": host_us}


def phase_q8_kernel(dev) -> dict:
    import torch

    from formula_vad_tpu_torch.ops import matmul_q8 as mq

    # One small ragged case against exact int64 arithmetic on the host.
    rng = np.random.default_rng(5)
    a, b = rng.integers(-127, 128, (100, 161)).astype(np.int8), rng.integers(-127, 128, (161, 161)).astype(np.int8)
    got = mq.matmul_q8(torch.from_numpy(a).to(dev), mq.Q8Weight.pack(torch.from_numpy(b).to(dev), torch.ones(161, device=dev)))
    if got.cpu().numpy().tobytes() != (a.astype(np.int64) @ b.astype(np.int64)).astype(np.float32).tobytes():
        raise AssertionError("int8 matmul kernel != int64 numpy on [100, 161] x [161, 161]")
    log("int8 matmul kernel == int64 numpy on [100, 161] x [161, 161]")

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    shapes = []
    for i, shape in enumerate(Q8_SHAPES):
        entry = q8_product(dev, i, *shape)
        if entry["path"] != "wgmma":
            raise AssertionError(f"int8 matmul at {entry['name']}: the wrapper took {entry['path']}, not the wgmma body")
        shapes.append(entry)
        for key in total:
            total[key] += entry["per_forward"] * entry[key]
    err = max(entry["max_abs_err"] for entry in shapes)
    bound_kinds = {entry["bound_by"] for entry in shapes}
    log("int8 matmul kernel == plain bit for bit at all six shapes, both orders, f32 and bf16 output")
    log(f"int8 matmul per forward ({Q8_LAUNCHES} launches): kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"torch._int_mm + epilogue {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    return {
        "name": "matmul_q8", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/matmul_q8.cu",
        "replaces": "formula_vad_tpu/ops/matmul_q8.py:69", "max_abs_err": err,
        **total, "bound_by": "bytes" if bound_kinds == {"bytes"} else "operations", "shapes": shapes,
    }


def q8_at(dev, rows: int, steps: int = Q8_STEPS, head_frames: int = 50) -> dict:
    """The int8 matmul kernel at the products of a forward of ``rows`` GRU
    rows x ``steps`` frames (a chunk step's 54, a low-latency hop's 1), each
    against its plain version (``q8_product``); -> the sums over the
    forward's launches (167 or 8)."""
    products = q8_shapes(rows, steps, head_frames)
    shapes = [q8_product(dev, 20 + i, *shape) for i, shape in enumerate(products)]
    total = {key: sum(e["per_forward"] * e[key] for e in shapes) for key in ("ms", "plain_ms", "bound_ms")}
    libs = [e["library_ms"] for e in shapes]
    total["library_ms"] = None if None in libs else sum(e["per_forward"] * t for e, t in zip(shapes, libs))
    lib_text = "null" if total["library_ms"] is None else f"{total['library_ms']:.3f} ms"
    log(f"int8 matmul over a forward at {rows} GRU rows x {steps} frames ({sum(p[4] for p in products)} launches), "
        f"bit for bit at all six "
        f"products: kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, torch._int_mm + epilogue "
        f"{lib_text}, bound {total['bound_ms']:.4f} ms")
    kinds = {e["bound_by"] for e in shapes}
    return {"rows": rows, "max_abs_err": max(e["max_abs_err"] for e in shapes), **total,
            "bound_by": "bytes" if kinds == {"bytes"} else "operations", "shapes": shapes}


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
    compare_simulators("int8", outs["int8_cuda"], outs["int8_cpu"])
    return launches


def compare_simulators(tier: str, gpu_dir: str, cpu_dir: str) -> None:
    """A non-parity tier's cuda and cpu simulator runs: the same segment
    count on every stream, every boundary within one FSM window."""
    for i in range(CORPUS_STREAMS):
        gpu, cpu = segment_spans(gpu_dir, i), segment_spans(cpu_dir, i)
        if len(gpu) != len(cpu) or not gpu:
            raise AssertionError(f"{tier} simulator s{i}: {len(gpu)} segments on cuda, {len(cpu)} on cpu")
        worst = max(abs(a - b) for g, c in zip(gpu, cpu) for a, b in zip(g, c))
        if worst > WINDOW_SEC + 1e-4:  # the files round to 0.1 ms
            raise AssertionError(f"{tier} simulator s{i}: a boundary moved {worst:.4f} s between cuda and cpu")
        log(f"{tier} simulator s{i}: {len(gpu)} segments on cuda and cpu, boundaries within {worst:.4f} s")
    same = read_text(gpu_dir, "report.txt") == read_text(cpu_dir, "report.txt")
    log(f"{tier} simulator report.txt identical on cuda and cpu: {same}")


GATE_KERNELS = (  # (wrapper in models/nsnet2_gates_cuda.py, kernel, the TPU kernel it replaces)
    ("gru_gates", 4, "benchmarks/gru_kernel_exp.py:105"),
    ("gru_gates_p", 5, "benchmarks/gru_kernel_exp.py:220"),
    ("gru_gates_f", 6, "benchmarks/gru_kernel_exp.py:401"),
)


def check_f32_form(name: str, wrapper, plain, net, dev) -> float:
    """A float32 per-gate form against its plain version at the RAGGED
    shapes (random gi, numpy seed 4); -> the largest max |dh2|."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates

    rng = np.random.default_rng(4)
    gw = gates.gate_weights(net, torch.float32)
    worst = 0.0
    for n, t in RAGGED:
        gi = [torch.from_numpy((rng.standard_normal((n, t, 400)) * 0.8).astype(np.float32)).to(dev) for _ in range(3)]
        got = wrapper(net, *gi)
        want = plain(gw, *gi)
        torch.cuda.synchronize()
        e = float((got - want).abs().max()) if bool(torch.isfinite(got).all()) else float("inf")
        log(f"{name} float32 vs plain at [{n}, {t}]: max |dh2| = {e:.3e} (tolerance {GRU_TOL})")
        if not e <= GRU_TOL:
            raise AssertionError(f"{name} float32 disagrees with its plain version at [{n}, {t}]: {e}")
        worst = max(worst, e)
    return worst


def check_p_form(name: str, kind: int, wrapper, plain, net, dev) -> dict:
    """The bf16 form of kernel ``kind`` on csrc/gru_gates_p.cu: its launch
    plan at the scoring shape, logged; then against its plain version at
    ragged row counts and two launches a call, counted as the plan's
    launches (gi from ``gi_gates`` of random features, numpy seed 5, as on
    the bf16 tier; the bf16 bars), a repeated call bit for bit, and the
    first 17 rows of a 1,680-row call equal to a 17-row call. -> the scoring
    shape's plan."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates

    (launch,) = plan = gates.device_p_plan(GRU_ROWS, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"{name} bf16 launch plan at {GRU_ROWS} rows on {sms} SMs: {gates.P_UNIT_GROUPS} unit groups of "
        f"{gates.P_UNITS} units x {launch.row_groups} row groups of {launch.tiles_per_group} 16-row tiles, grid "
        f"{launch.grid}, {launch.smem_bytes(kind)} bytes of shared memory a CTA ({len(plan)} launch)")
    rng = np.random.default_rng(5)
    gw = gates.gate_weights(net, torch.bfloat16)

    def gi_of(n, t):
        feats = torch.from_numpy(rng.normal(-3.0, 1.5, (n, t, 161)).astype(np.float32)).to(dev)
        return gates.gi_gates(net, net.fc_in(feats))

    for n, t in ((1, 54), (17, 2), (337, 54), (4000, 54)):
        gi = gi_of(n, t)
        before = wrapper.launches
        got = wrapper(net, *gi, dtype=torch.bfloat16)
        launched = wrapper.launches - before
        want = plain(gw, *gi)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        err, mean = float(d.max()), float(d.mean())
        log(f"{name} bf16 vs plain at [{n}, {t}] ({launched} launch(es) counted): "
            f"max |dh2| = {err:.3e}, mean {mean:.3e}")
        if launched != len(gates.device_p_plan(n, dev)):
            raise AssertionError(f"{name} bf16 at {n} rows counted {launched} launches, its plan has "
                                 f"{len(gates.device_p_plan(n, dev))}")
        if not (err <= BF16_MAX and mean <= BF16_MEAN):
            raise AssertionError(f"{name} bf16 disagrees with its plain version at [{n}, {t}]: {err}, {mean}")
    gi = gi_of(GRU_ROWS, GRU_STEPS)
    whole = wrapper(net, *gi, dtype=torch.bfloat16)
    if not torch.equal(whole, wrapper(net, *gi, dtype=torch.bfloat16)):
        raise AssertionError(f"{name} bf16: a repeated call changed bits")
    part = wrapper(net, *(g[:17].contiguous() for g in gi), dtype=torch.bfloat16)
    if not torch.equal(part, whole[:17]):
        raise AssertionError(f"{name} bf16: rows 0-16 of a 1,680-row call differ from a 17-row call")
    log(f"{name} bf16: a repeated call and rows 0-16 of 1,680 against a 17-row call give identical bits")
    return {"unit_groups": gates.P_UNIT_GROUPS, "row_groups": launch.row_groups,
            "tiles_per_group": launch.tiles_per_group, "grid": launch.grid, "smem_bytes": launch.smem_bytes(kind)}


def check_pre_flip(name: str, kind: int, wrapper, plain, dev) -> dict:
    """The bf16 form of kernel ``kind`` on random gi against its plain
    version, under the CPU tests' pre-flip bar (ROADMAP §3 fault 3 step 3):
    mean |dh2| <= PRE_FLIP_MEAN over each row's steps before its first bf16
    rounding flip of h2, over at least PRE_FLIP_STEPS such row-steps."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
    from formula_vad_tpu_torch.models.registry import load_denoiser

    net = load_denoiser("random", device=dev)
    rng = np.random.default_rng(100)
    gi = [torch.from_numpy((rng.standard_normal((PRE_FLIP_ROWS, GRU_STEPS, 400)) * 0.8).astype(np.float32)).to(dev)
          for _ in range(3)]
    args = gi if kind == 5 else [g.to(torch.bfloat16) for g in gi]
    kw = {"out_dtype": torch.float32} if kind == 6 else {}
    got = wrapper(net, *args, dtype=torch.bfloat16, **kw).float()
    want = plain(gates.gate_weights(net, torch.bfloat16), *args, **kw).float()
    flip = (got.to(torch.bfloat16) != want.to(torch.bfloat16)).any(dim=2)
    first = torch.where(flip.any(dim=1), flip.int().argmax(dim=1), GRU_STEPS)
    before = torch.arange(GRU_STEPS, device=dev)[None, :] < first[:, None]
    d = (got - want).abs()
    steps, mean = int(before.sum()), float(d[before].mean())
    log(f"{name} bf16 on random gi [{PRE_FLIP_ROWS}, {GRU_STEPS}] vs plain: first flips {first.tolist()}; before "
        f"them {steps} row-steps (floor {PRE_FLIP_STEPS}) at mean |dh2| {mean:.3e} (bar {PRE_FLIP_MEAN}); over all "
        f"steps mean {float(d.mean()):.3e}")
    if steps < PRE_FLIP_STEPS or not mean <= PRE_FLIP_MEAN:
        raise AssertionError(f"{name} bf16 misses the pre-flip bar on random gi: {steps} row-steps, mean {mean}")
    return {"rows": PRE_FLIP_ROWS, "row_steps": steps, "mean_abs_err": mean, "first_flips": first.tolist()}


def phase_gates(dev, kernel1_ms: float) -> tuple[list[dict], dict]:
    """Path A (the experiment tool, its own random weights) once with the
    counters at 0, then each per-gate kernel against its plain version on
    ``biased_net``; -> (kernel rows, path-A launches). ``kernel1_ms``:
    phase 2's single-call time of kernel 1, which the float32 forms run
    on."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms
    from formula_vad_tpu_torch.tools import gru_kernel_exp as exp

    feats = exp.features(GRU_ROWS, dev)
    wrappers = {name: getattr(gates, name) for name, _, _ in GATE_KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    exp.run(load_denoiser("random", device=dev), feats, list(exp.VARIANTS), iters=3)
    torch.cuda.synchronize()
    path_a = {name: fn.launches for name, fn in wrappers.items()}
    log(f"experiment tool (path A) launches over all variants: {path_a}")
    if min(path_a.values()) <= 0:
        raise AssertionError(f"a per-gate kernel never launched on the tool's path: {path_a}")

    net = biased_net(dev)
    ops = 3 * 2 * GRU_ROWS * 400 * 1200 * GRU_STEPS
    rows = []
    # The library yardsticks: cuDNN's GRU in float32 for the float32 forms;
    # for the bf16 forms cuDNN's GRU in float16, whose weights
    # flatten_parameters compacts once (it leaves bf16 weights alone, so a
    # bf16 GRU compacts them again on every call; timed too, for the record).
    grus = {dtype: cudnn_gru(net, dev, dtype) for dtype in (torch.float32, torch.float16, torch.bfloat16)}
    with torch.inference_mode():
        gi = exp._gi_gates(net, feats[0])
        x = net.fc_in(feats[0])
        gru_ms = {}
        for dtype, gru in grus.items():
            xd = x.to(dtype)
            gru_ms[dtype] = cuda_ms(lambda: gru(xd))
        log(f"cuDNN two-layer GRU [{GRU_ROWS}, {GRU_STEPS}]: float32 {gru_ms[torch.float32]:.3f} ms, float16 "
            f"{gru_ms[torch.float16]:.3f} ms (weights compacted once), bf16 {gru_ms[torch.bfloat16]:.3f} ms "
            f"(weights compacted on every call)")
        library_ms = {torch.float32: gru_ms[torch.float32], torch.bfloat16: gru_ms[torch.float16]}
        plan = nsnet2_cuda.device_plan(GRU_ROWS, dev)
        log(f"float32 forms: kernel 1's kernel (csrc/gru_stack.cu), launch plan at {GRU_ROWS} rows: {plan.tiles} tiles "
            f"of {plan.row_tile} rows x {plan.unit_tile} units, grid {plan.grid}")
        for name, kind, replaces in GATE_KERNELS:
            wrapper = wrappers[name]
            plain = getattr(gates, f"{name}_reference")
            forms = []
            for dtype in gates.DTYPES:
                gw = gates.gate_weights(net, dtype)
                args = gi if kind == 5 else tuple(g.to(dtype) for g in gi)  # the kernel's own gi dtype
                got = wrapper(net, *args, dtype=dtype)
                want = plain(gw, *args)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got.float()).all()):
                    raise AssertionError(f"{name} {dtype} produced non-finite values")
                d = (got.float() - want.float()).abs()
                err, mean = float(d.max()), float(d.mean())
                if dtype == torch.float32:
                    ok, bar = err <= GRU_TOL, f"max <= {GRU_TOL}"
                else:
                    f32 = plain(gates.gate_weights(net, torch.float32), *gi)
                    dist = (want.float() - f32).abs()
                    dist_max, dist_mean = float(dist.max()), float(dist.mean())
                    if not 10 * BF16_MEAN < dist_mean:
                        raise AssertionError(f"{name}: the bf16 mean bar does not tell bf16 from float32 here "
                                             f"(plain bf16 vs f32: mean {dist_mean:.3e})")
                    ok = mean <= BF16_MEAN and err <= BF16_MAX
                    bar = (f"mean <= {BF16_MEAN}, max <= {BF16_MAX}; plain bf16 vs plain f32: mean {dist_mean:.3e}, "
                           f"max {dist_max:.3e}")
                log(f"{name} (kernel {kind}) {str(dtype)[6:]} vs plain on the card: max |dh2| = {err:.3e}, "
                    f"mean {mean:.3e} ({bar})")
                if not ok:
                    raise AssertionError(f"{name} {dtype} disagrees with its plain version: max {err}, mean {mean}")
                if dtype == torch.float32:
                    before = nsnet2_cuda.gru_stack.launches
                    err = max(err, check_f32_form(name, wrapper, plain, net, dev))
                    if nsnet2_cuda.gru_stack.launches != before:
                        raise AssertionError(f"{name} float32 counted its launches as gru_stack's")
                    extra = {"source": "formula_vad_tpu_torch/csrc/gru_stack.cu"}
                else:
                    extra = {"source": "formula_vad_tpu_torch/csrc/gru_gates_p.cu",
                             "plan": check_p_form(name, kind, wrapper, plain, net, dev),
                             "pre_flip": check_pre_flip(name, kind, wrapper, plain, dev)}
                extra["queued_ms"] = queued_ms(lambda: wrapper(net, *args, dtype=dtype))
                if kind == 6:
                    f32_out, bf16_out = (wrapper(net, *args, dtype=dtype, out_dtype=o) for o in gates.DTYPES)
                    if not torch.equal(bf16_out, f32_out.to(torch.bfloat16)):
                        raise AssertionError(f"{name} {dtype} with bf16 out != its float32 out rounded")
                    log(f"{name} {str(dtype)[6:]}: bf16 out == float32 out rounded to bf16, bit for bit")
                    for tile in (840, 416):
                        if not torch.equal(wrapper(net, *args, dtype=dtype, tile=tile), got):
                            raise AssertionError(f"{name} {dtype}: tile {tile} changed the result")
                    log(f"{name} {str(dtype)[6:]}: tile = all rows, 840 and 416 give identical bits")
                ms = cuda_ms(lambda: wrapper(net, *args, dtype=dtype))
                plain_ms = cuda_ms(lambda: plain(gw, *args), reps=3)
                nbytes = sum(a.nbytes for a in args) + got.nbytes + 9 * 400 * 400 * dtype.itemsize + gw.b8.nbytes
                bound_ms, bound_by = bound(nbytes, ops, F32_OPS_PER_MS if dtype == torch.float32 else BF16_OPS_PER_MS)
                lib = "cuDNN GRU f32" if dtype == torch.float32 else "cuDNN GRU fp16 (stores h in fp16: another function)"
                log(f"{name} {str(dtype)[6:]} [{GRU_ROWS}, {GRU_STEPS}]: kernel {ms:.3f} ms ({ops / 1e9 / ms:.2f} TFLOP/s), "
                    f"plain {plain_ms:.3f} ms, {lib} {library_ms[dtype]:.3f} ms; bound {bound_ms:.3f} ms by {bound_by} "
                    f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
                if dtype == torch.float32:
                    log(f"{name} float32 [{GRU_ROWS}, {GRU_STEPS}]: single call {ms:.3f} ms, queued back to back "
                        f"{extra['queued_ms']:.3f} ms; {ms / library_ms[dtype]:.3f}x cuDNN's float32 GRU, "
                        f"{ms / kernel1_ms:.3f}x kernel 1's phase-2 single call ({kernel1_ms:.3f} ms)")
                else:
                    log(f"{name} bf16 [{GRU_ROWS}, {GRU_STEPS}] (csrc/gru_gates_p.cu): single call {ms:.3f} ms, queued "
                        f"back to back {extra['queued_ms']:.3f} ms; bound {bound_ms:.3f} ms, plain {plain_ms:.3f} ms, "
                        f"cuDNN GRU fp16 {gru_ms[torch.float16]:.3f} ms, bf16 {gru_ms[torch.bfloat16]:.3f} ms")
                forms.append({"dtype": str(dtype)[6:], "max_abs_err": err, "mean_abs_err": mean, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": library_ms[dtype], **extra})
            # The line's numbers are the bf16 form's: kernel 5's form on the
            # bf16 tier; both forms are under "forms".
            top = {k: v for k, v in forms[1].items() if k not in ("dtype", "mean_abs_err")}
            rows.append({"name": name, "route": "cuda", "replaces": replaces, **top, "forms": forms,
                         "cudnn_bf16_ms": gru_ms[torch.bfloat16]})
    return rows, path_a


def phase_bf16_slice(runner, audio, float_results, float_wall: float, corpus: str, smi: str) -> dict:
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_gates_cuda
    from formula_vad_tpu_torch.ops import precision
    from formula_vad_tpu_torch.pipeline import fsm_cuda, offline
    from formula_vad_tpu_torch.tools import cuda_ms

    audio_sec = SLICE_STREAMS * SLICE_SECONDS
    net, st = runner.net, runner.st
    counters = {"gru_gates_p": nsnet2_gates_cuda.gru_gates_p, "gru_stack": nsnet2_cuda.gru_stack,
                "scan_windows": fsm_cuda.scan_windows}
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(-3.0, 1.5, (GRU_ROWS, GRU_STEPS, 161)).astype(np.float32)
    ).to(runner.device)
    x = torch.from_numpy(audio).to(runner.device)
    with torch.inference_mode():
        float_model_ms = cuda_ms(lambda: net(feats, out_frames=50), reps=3)
        float_gains = net(feats, out_frames=50)
    precision.set_matmul_precision("default")
    try:
        results, walls, launches = timed_runs(runner, audio, counters)
        log(f"bf16 slice launches over 3 runs: {launches}")
        if launches != {"gru_gates_p": 3, "gru_stack": 0, "scan_windows": 3}:
            raise AssertionError(f"the bf16 slice launched {launches}, not 1 kernel-5 launch per run and no gru_stack")
        with torch.inference_mode():
            fe_ms = cuda_ms(lambda: offline.window_inputs_batch(net, st, x), reps=3)
            model_ms = cuda_ms(lambda: net(feats, out_frames=50), reps=3)
            gains = net(feats, out_frames=50)
    finally:
        precision.set_matmul_precision("highest")
    wall = statistics.median(walls)
    log(f"bf16 slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s: wall {wall * 1e3:.1f} ms (median of 3, runs "
        f"{[round(w * 1e3, 1) for w in walls]}), real-time factor {audio_sec / wall:.1f}; float tier in this call "
        f"{float_wall * 1e3:.1f} ms, real-time factor {audio_sec / float_wall:.1f}; on {smi}")
    log(f"bf16 slice split: front end (incl. bf16 model) {fe_ms:.1f} ms, host and FSM rest {wall * 1e3 - fe_ms:.1f} ms; "
        f"model forward at [{GRU_ROWS}, {GRU_STEPS}, 161]: bf16 tier {model_ms:.2f} ms, float {float_model_ms:.2f} ms; "
        f"gains bf16 vs float: max |d| {float((gains - float_gains).abs().max()):.3e}")
    n_seg = sum(len(r.segments) for r in results)
    if n_seg == 0:
        raise AssertionError("the bf16 slice found no speech segment")

    def spans(res):
        return {(seg["sample_from"], seg["sample_to"]) for seg in res.segments}

    differ = sum(len(spans(b) ^ spans(f)) for b, f in zip(results, float_results))
    log(f"bf16 slice segments: {n_seg} (float tier {sum(len(r.segments) for r in float_results)}); "
        f"segments found by one tier only: {differ}")

    outs = run_simulators(corpus, {"bf16_cuda": ("cuda", {}, ("--precision", "default")),
                                   "bf16_cpu": ("cpu", {}, ("--precision", "default"))})
    compare_simulators("bf16", outs["bf16_cuda"], outs["bf16_cpu"])
    return launches


def capture_slab_fsm(runner) -> dict:
    """Wrap ``runner``'s front end and final fetch: -> a dict collecting each
    slab's FSM inputs (on the card) and the fetched FSM outputs."""
    seen = {"inputs": []}
    front_end, fetch = runner._front_end, runner._fetch

    def capture_front_end(*args):
        out = front_end(*args)
        seen["inputs"].append(out[1:])
        return out

    def capture_fetch(slab_outs):
        seen["outputs"] = fetch(slab_outs)
        return seen["outputs"]

    runner._front_end, runner._fetch = capture_front_end, capture_fetch
    return seen


def spans_within_a_window(what: str, got, want) -> None:
    """A non-parity run's results ``got`` against ``want`` (``what`` names
    both): the same segment count on every stream, every boundary within one
    FSM window."""
    worst = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g.segments) != len(w.segments):
            raise AssertionError(f"{what}, s{i}: {len(g.segments)} segments against {len(w.segments)}")
        for a, b in zip(g.segments, w.segments):
            worst = max(worst, abs(a["sample_from"] - b["sample_from"]), abs(a["sample_to"] - b["sample_to"]))
    if worst > 1024:
        raise AssertionError(f"{what}: a boundary moved {worst} samples")
    log(f"{what}: {sum(len(r.segments) for r in want)} segments, boundaries within {worst} samples")


def slab_kernels(net, dev) -> dict:
    """Kernels 1, 5 (bf16) and 3 at the slab's shapes against their plain
    versions; -> {kernel name: its slab-shape entry}."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
    from formula_vad_tpu_torch.ops import matmul_q8 as mq
    from formula_vad_tpu_torch.tools import cuda_ms, graph_ms

    out = {}
    feats = torch.from_numpy(
        np.random.default_rng(8).normal(-3.0, 1.5, (SLAB_ROWS, GRU_STEPS, 161)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        x = net.fc_in(feats)
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
        got = nsnet2_cuda.gru_stack(net, gi1)
        want = nsnet2_cuda.gru_stack_reference(net, gi1)
        e = float((got - want).abs().max()) if bool(torch.isfinite(got).all()) else float("inf")
        if not e <= GRU_TOL:
            raise AssertionError(f"GRU kernel disagrees with its plain version at [{SLAB_ROWS}, {GRU_STEPS}]: {e}")
        ms = cuda_ms(lambda: nsnet2_cuda.gru_stack(net, gi1), reps=3)
        plain_ms = cuda_ms(lambda: nsnet2_cuda.gru_stack_reference(net, gi1), reps=3)
        ops = 3 * 2 * SLAB_ROWS * 400 * 1200 * GRU_STEPS
        bound_ms, _ = bound(gi1.nbytes + got.nbytes, ops, F32_OPS_PER_MS)
        out["gru_stack"] = {"rows": SLAB_ROWS, "max_abs_err": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
        log(f"GRU kernel at the slab's [{SLAB_ROWS}, {GRU_STEPS}]: max |dh2| {e:.3e} (tolerance {GRU_TOL}); "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms")

        gi = gates.gi_gates(net, x)
        before = gates.gru_gates_p.launches
        got = gates.gru_gates_p(net, *gi, dtype=torch.bfloat16)
        launched = gates.gru_gates_p.launches - before
        want = gates.gru_gates_p_reference(gates.gate_weights(net, torch.bfloat16), *gi)
        d = (got - want).abs()
        e, mean = float(d.max()), float(d.mean())
        plan = gates.device_p_plan(SLAB_ROWS, dev)
        if launched != len(plan) or len(plan) != 3:
            raise AssertionError(f"kernel 5 bf16 at {SLAB_ROWS} rows: {launched} launches counted, plan {len(plan)}")
        if not (e <= BF16_MAX and mean <= BF16_MEAN):
            raise AssertionError(f"kernel 5 bf16 disagrees with its plain version at {SLAB_ROWS} rows: {e}, {mean}")
        ms = cuda_ms(lambda: gates.gru_gates_p(net, *gi, dtype=torch.bfloat16), reps=3)
        plain_ms = cuda_ms(lambda: gates.gru_gates_p_reference(gates.gate_weights(net, torch.bfloat16), *gi), reps=3)
        bound_ms, _ = bound(sum(g.nbytes for g in gi) + got.nbytes, ops, BF16_OPS_PER_MS)
        out["gru_gates_p"] = {"rows": SLAB_ROWS, "launches_a_call": launched, "max_abs_err": e, "mean_abs_err": mean,
                              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
        log(f"kernel 5 bf16 at the slab's {SLAB_ROWS} rows ({launched} launches): max |dh2| {e:.3e}, mean {mean:.3e} "
            f"(bars {BF16_MAX}, {BF16_MEAN}); {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms")

    gen = torch.Generator(device=dev).manual_seed(11)
    a8 = torch.randint(-127, 128, (SLAB_ROWS, 400), dtype=torch.int8, device=dev, generator=gen)
    b8 = torch.randint(-127, 128, (400, 1200), dtype=torch.int8, device=dev, generator=gen)
    w = mq.Q8Weight.pack(b8, torch.rand(1200, device=dev, generator=gen) * 1e-3, torch.randn(1200, device=dev, generator=gen))
    with torch.inference_mode():
        got = mq.matmul_q8(a8, w, order="col_row")
        want = mq.matmul_q8_reference(a8, w, order="col_row")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8 matmul kernel != plain at the slab's in-scan [{SLAB_ROWS}, 400] x [400, 1200]")
        ms = graph_ms(lambda: mq.matmul_q8(a8, w, order="col_row"), 20)
        plain_ms = graph_ms(lambda: mq.matmul_q8_reference(a8, w, order="col_row"), 20)
    bound_ms, _ = bound(SLAB_ROWS * 400 + 400 * 1200 + 4 * SLAB_ROWS * 1200 + 8 * 1200, 2 * SLAB_ROWS * 400 * 1200,
                        INT8_OPS_PER_MS)
    out["matmul_q8"] = {"rows": SLAB_ROWS, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
    log(f"int8 matmul at the slab's in-scan [{SLAB_ROWS}, 400] x [400, 1200]: bit for bit; kernel {ms * 1e3:.1f} us, "
        f"plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us")
    return out


def phase_slab(net, dev, smi: str, float_rtf: float, root: str) -> tuple[dict, dict, list]:
    """Phase 10; -> (launches a kernel on the slab path, slab-shape entries,
    the float tier's segments). The race corpus stays in ``root`` for
    phase 18."""
    import torch

    from formula_vad_tpu_torch.io_ import AudioSource
    from formula_vad_tpu_torch.io_.prefetch import SlabPrefetcher
    from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_gates_cuda
    from formula_vad_tpu_torch.ops import matmul_q8, precision
    from formula_vad_tpu_torch.parallel.runner import BatchRunner
    from formula_vad_tpu_torch.parallel.slab_runner import SlabRunner
    from formula_vad_tpu_torch.pipeline import fsm_cuda, fsm_host
    from formula_vad_tpu_torch.testing.synth import write_corpus, write_ragged_corpus
    from formula_vad_tpu_torch.tools import busy_ms

    t_phase = time.perf_counter()
    race = os.path.join(root, "race")
    os.makedirs(race)
    write_ragged_corpus(race, SLAB_LENGTHS, seed=4)
    disk = sum(os.path.getsize(os.path.join(race, f"s{i}.wav")) for i in range(SLAB_STREAMS))
    audio_sec = sum(SLAB_LENGTHS) / 48000
    log(f"slab corpus: {SLAB_STREAMS} PCM16 streams of {min(SLAB_LENGTHS) / 48000:.2f}-{max(SLAB_LENGTHS) / 48000:.2f} s "
        f"({audio_sec:.1f} audio-s), {disk / 1e9:.2f} GB on disk, {2 * disk / 1e9:.2f} GB as float32; "
        f"written in {time.perf_counter() - t_phase:.1f} s")
    srcs = [AudioSource.open_stream(os.path.join(race, f"s{i}.wav")) for i in range(SLAB_STREAMS)]
    try:
        def readers(raw16):
            def mk(src):
                def read(start, n):
                    src.seek_to_sample(start)
                    return src.read_raw16(n) if raw16 else src.read(n)
                return read
            return [mk(src) for src in srcs]

        def run(runner, raw16=True, lengths=SLAB_LENGTHS):
            results = runner.run_readers(readers(raw16), lengths, raw16=raw16)
            torch.cuda.synchronize()
            return results

        # Every kernel's counter, reset before each tier's slab run and read
        # after it: each run must launch its tier's kernels and no other.
        counters = {"gru_stack": nsnet2_cuda.gru_stack, "scan_windows": fsm_cuda.scan_windows,
                    "gru_gates": nsnet2_gates_cuda.gru_gates, "gru_gates_p": nsnet2_gates_cuda.gru_gates_p,
                    "gru_gates_f": nsnet2_gates_cuda.gru_gates_f, "matmul_q8": matmul_q8.matmul_q8}

        def expect(tier, got, **want):
            want = dict(dict.fromkeys(counters, 0), scan_windows=SLAB_COUNT, **want)
            if got != want:
                raise AssertionError(f"the {tier} slab run launched {got}, not {want}")

        runner = SlabRunner(net, slab_chunks=SLAB_CHUNKS)  # the default VAD config, device FSM
        two = [min(n, 2 * SLAB_CHUNKS * 24000) for n in SLAB_LENGTHS]
        run(runner, lengths=two)  # the warm-up, so that its one-off allocations stay out of the baseline
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run(runner, lengths=two)
        two_wall = time.perf_counter() - t0
        peak_two = torch.cuda.max_memory_allocated(dev)

        seen = capture_slab_fsm(runner)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(counters)
        t0 = time.perf_counter()
        results = run(runner)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        smem = fsm_cuda.scan_windows.launches_by_body["smem"]
        peak = torch.cuda.max_memory_allocated(dev)
        del runner._front_end, runner._fetch  # the capture's wrappers
        log(f"slab run, float tier, device FSM, raw16 readers: {SLAB_COUNT} slabs of {SLAB_CHUNKS} chunks, wall "
            f"{wall * 1e3:.1f} ms, real-time factor {audio_sec / wall:.1f} (one-shot slice in phase 4: {float_rtf:.1f}); "
            f"2 slabs {two_wall * 1e3:.1f} ms; on {smi}")
        log(f"slab run launches: {launches}, scan_windows by body {fsm_cuda.scan_windows.launches_by_body}")
        expect("float", launches, gru_stack=SLAB_COUNT)
        if smem != SLAB_COUNT:
            raise AssertionError(f"the slab run launched {smem} smem-body scan_windows, not 1 a slab")
        log(f"peak device memory: {peak / 2**30:.3f} GiB over {SLAB_COUNT} slabs, {peak_two / 2**30:.3f} GiB over 2 "
            f"({peak / peak_two:.4f}x; bar {1 + PEAK_TOL})")
        if not peak <= (1 + PEAK_TOL) * peak_two:
            raise AssertionError(f"peak device memory grew with the slab count: {peak} against {peak_two}")

        mv, rt, va = (torch.cat(xs, dim=1).cpu().numpy() for xs in zip(*seen["inputs"]))
        st = runner.st
        want, _ = fsm_host.scan_windows_host(st.fsm_shape, st.fsm_params, mv, rt, va)
        for field, a, b in zip(want._fields, seen["outputs"], want):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"chained FSM output {field} != the host decoder's single call over {mv.shape}")
        log(f"chained FSM over {SLAB_COUNT} slabs == the host decoder's single call over {list(mv.shape)} windows: "
            f"all 7 outputs, bit for bit")
        n_seg = sum(len(r.segments) for r in results)
        if n_seg == 0:
            raise AssertionError("the slab run found no speech segment")
        segs = [r.segments for r in results]
        for name, other in (("host-FSM slab run", lambda: run(SlabRunner(net, slab_chunks=SLAB_CHUNKS, use_host_fsm=True))),
                            ("float32-reader slab run", lambda: run(runner, raw16=False))):
            t0 = time.perf_counter()
            if [r.segments for r in other()] != segs:
                raise AssertionError(f"the slab run's segments differ from the {name}'s")
            log(f"slab segments: {n_seg}, identical to the {name}'s ({(time.perf_counter() - t0) * 1e3:.1f} ms)")

        def first_streams():
            batch = np.zeros((ONE_SHOT_STREAMS, 2, max(SLAB_LENGTHS[:ONE_SHOT_STREAMS])), np.float32)
            for i in range(ONE_SHOT_STREAMS):
                srcs[i].seek_to_sample(0)
                batch[i, :, : SLAB_LENGTHS[i]] = srcs[i].read(SLAB_LENGTHS[i])
            return batch

        batch = first_streams()
        one = BatchRunner(net).run(batch, SLAB_LENGTHS[:ONE_SHOT_STREAMS])
        if [r.segments for r in one] != segs[:ONE_SHOT_STREAMS]:
            raise AssertionError("the slab run's segments differ from a one-shot run over its first streams")
        log(f"slab segments of the first {ONE_SHOT_STREAMS} streams identical to a one-shot BatchRunner over them")

        # The host's part alone: the prefetcher reading every slab, and one
        # slab's copy into pinned memory.
        t0 = time.perf_counter()
        prefetcher = SlabPrefetcher(readers(True), [n // 24000 for n in SLAB_LENGTHS], n_slabs=SLAB_COUNT,
                                    slab_chunks=SLAB_CHUNKS, chunk_size=24000, n_channels=2, b_pad=SLAB_STREAMS,
                                    depth=1, dtype=np.int16)
        try:
            slab = [prefetcher.get()[0] for _ in range(SLAB_COUNT)][-1]
        finally:
            prefetcher.close()
        read_ms = (time.perf_counter() - t0) * 1e3
        pinned = torch.empty(slab.shape, dtype=torch.int16, pin_memory=True)
        t0 = time.perf_counter()
        np.copyto(pinned.numpy(), slab)
        pin_ms = (time.perf_counter() - t0) * 1e3
        log(f"slab run's host part alone: the prefetcher reads the {SLAB_COUNT} slabs in {read_ms:.1f} ms "
            f"({read_ms / SLAB_COUNT:.1f} a slab); one slab's copy into pinned memory {pin_ms:.1f} ms "
            f"({slab.nbytes / 1e6:.0f} MB)")
        del slab, pinned

        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run(runner)
            prof_wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = None
        if events:
            busy, kernels, copies = busy_ms(events)
            hidden = kernels + copies - busy
            log(f"profiled slab run: wall {prof_wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / prof_wall:.1f}%), "
                f"kernels {kernels:.1f} ms, copies {copies:.1f} ms of which {hidden:.1f} ms "
                f"({100 * hidden / max(copies, 1e-9):.1f}%) under kernels; idle {prof_wall - busy:.1f} ms")
        else:
            log("profiled slab run: the trace holds no device events")

        tiers = {"float": launches}
        for tier, enter, leave, counter, per_slab in (
            ("bf16", lambda: precision.set_matmul_precision("default"), lambda: precision.set_matmul_precision("highest"),
             "gru_gates_p", 3),
            ("int8", lambda: precision.set_quant("int8"), lambda: precision.set_quant("off"), "matmul_q8", Q8_LAUNCHES),
        ):
            enter()
            try:
                reset_counts(counters)
                t0 = time.perf_counter()
                got = run(runner)
                tier_wall = time.perf_counter() - t0
                tiers[tier] = {name: fn.launches for name, fn in counters.items()}
                one = BatchRunner(net).run(batch, SLAB_LENGTHS[:ONE_SHOT_STREAMS])
            finally:
                leave()
            log(f"{tier} slab run: wall {tier_wall * 1e3:.1f} ms, real-time factor {audio_sec / tier_wall:.1f}; "
                f"launches {tiers[tier]}")
            expect(tier, tiers[tier], **{counter: per_slab * SLAB_COUNT})
            spans_within_a_window(f"{tier} slab run vs its one-shot run on the first {ONE_SHOT_STREAMS} streams",
                                  got[:ONE_SHOT_STREAMS], one)
        del batch
        kernels = slab_kernels(net, dev)
    finally:
        for src in srcs:
            src.close()

    corpus = os.path.join(root, "sim")
    os.makedirs(corpus)
    slab_plan = {"use_slabs": True, "slab_chunks": 32}
    write_corpus(corpus, CORPUS_STREAMS, SLAB_CORPUS_SECONDS, seed=5, fmt="pcm16",
                 plans={"slab_cuda": slab_plan, "slab_cpu": slab_plan, "oneshot_cuda": {}})
    outs = run_simulators(corpus, {"slab_cuda": ("cuda", {}), "slab_cpu": ("cpu", {}), "oneshot_cuda": ("cuda", {})})
    for name in ["report.txt"] + [f"s{i}-audacity.txt" for i in range(CORPUS_STREAMS)]:
        texts = {plan: read_text(outs[plan], name) for plan in outs}
        if len(set(texts.values())) != 1:
            raise AssertionError(f"{name} differs between the slab (cuda, cpu) and one-shot simulator runs")
    log("simulator on PCM16: use_slabs plans on cuda and cpu and the one-shot plan write identical report.txt and "
        "Audacity files; s0: " + read_text(outs["slab_cuda"], "s0-audacity.txt").strip().replace("\n", " | "))
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    # Each kernel's launches in its tier's slab run; kernels 4 and 6, on no
    # tier's path, the sum of their counts over the three runs (0).
    return {"gru_stack": tiers["float"]["gru_stack"], "scan_windows": tiers["float"]["scan_windows"],
            "gru_gates_p": tiers["bf16"]["gru_gates_p"], "matmul_q8": tiers["int8"]["matmul_q8"],
            **{name: sum(t[name] for t in tiers.values()) for name in ("gru_gates", "gru_gates_f")}}, kernels, segs


def gates_on_path(net, dev, rows: int, kind: int) -> dict:
    """Kernel 5 (the bf16 tier: float32 gi, bf16 h) or kernel 6 (the bf16_io
    tier: bf16 gi, bf16 out) on the gi its tier hands it (the per-gate
    projections of the fc_in output of random features, numpy seed 12), at
    [rows, 54], against its plain version: phase 8's bars, and as many
    launches counted as its plan holds; its plan, single and queued times,
    plain time, bound and cuDNN's fp16 GRU at that shape."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
    from formula_vad_tpu_torch.ops import precision
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms

    feats = torch.from_numpy(
        np.random.default_rng(12).normal(-3.0, 1.5, (rows, GRU_STEPS, 161)).astype(np.float32)).to(dev)
    bf16 = torch.bfloat16
    if kind == 5:
        wrapper, plain, kw, what = gates.gru_gates_p, gates.gru_gates_p_reference, {}, "kernel 5 bf16 on the bf16 path"
    else:
        wrapper, plain, kw = gates.gru_gates_f, gates.gru_gates_f_reference, {"out_dtype": bf16}
        what = "kernel 6 bf16 (bf16 out) on the bf16_io path"
    precision.set_io_dtype("bf16" if kind == 6 else "f32")
    try:
        with torch.inference_mode():
            x = net.fc_in(precision.io_cast(feats))
            gi = gates.gi_gates(net, x)
            if kind == 6:
                gi = tuple(g.to(bf16) for g in gi)
    finally:
        precision.set_io_dtype("f32")
    gw = gates.gate_weights(net, bf16)
    plan = gates.device_p_plan(rows, dev)
    launch = plan[0]

    def call():
        return wrapper(net, *gi, dtype=bf16, **kw)

    with torch.inference_mode():
        before = wrapper.launches
        got = call()
        launched = wrapper.launches - before
        want = plain(gw, *gi, **kw)
        torch.cuda.synchronize()
        if got.dtype != (bf16 if kind == 6 else torch.float32) or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{what} gave {got.dtype} or non-finite values at {rows} rows")
        d = (got.float() - want.float()).abs()
        err, mean = float(d.max()), float(d.mean())
        # Phase 8's pre-flip bar: over each row's steps before its first
        # bf16 rounding flip of h2.
        flip = (got.to(bf16) != want.to(bf16)).any(dim=2)
        first = torch.where(flip.any(dim=1), flip.int().argmax(dim=1), GRU_STEPS)
        pre = torch.arange(GRU_STEPS, device=dev)[None, :] < first[:, None]
        pre_steps = int(pre.sum())
        pre_mean = float(d[pre].mean()) if pre_steps else None
        if launched != len(plan):
            raise AssertionError(f"{what} at {rows} rows counted {launched} launches, its plan has {len(plan)}")
        if not pre_steps or not pre_mean <= PRE_FLIP_MEAN:
            raise AssertionError(f"{what} misses the pre-flip bar at [{rows}, {GRU_STEPS}]: {pre_steps} row-steps "
                                 f"before the first flips, mean {pre_mean}")
        if not (err <= BF16_MAX and mean <= BF16_MEAN):
            raise AssertionError(f"{what} disagrees with its plain version at [{rows}, {GRU_STEPS}]: "
                                 f"max {err}, mean {mean}")
        ms = cuda_ms(call)
        queued = queued_ms(call)
        plain_ms = cuda_ms(lambda: plain(gw, *gi, **kw), reps=3)
        gru = cudnn_gru(net, dev, torch.float16)
        xh = x.to(torch.float16)
        library_ms = cuda_ms(lambda: gru(xh))
    ops = 3 * 2 * rows * 400 * 1200 * GRU_STEPS
    nbytes = sum(g.nbytes for g in gi) + got.nbytes + gw.w9.nbytes + gw.b8.nbytes
    bound_ms, bound_by = bound(nbytes, ops, BF16_OPS_PER_MS)
    log(f"{what} at [{rows}, {GRU_STEPS}]: plan {len(plan)} launch(es), the first {gates.P_UNIT_GROUPS} unit groups "
        f"x {launch.row_groups} row groups of {launch.tiles_per_group} 16-row tiles, grid {launch.grid}, "
        f"{launch.smem_bytes(kind)} B shared a CTA; {launched} launch(es) counted; max |dh2| {err:.3e}, mean "
        f"{mean:.3e} (bars {BF16_MAX}, {BF16_MEAN}); before each row's first flip {pre_steps} row-steps at mean "
        f"{pre_mean:.3e} (bar {PRE_FLIP_MEAN}){' (first flips ' + str(first.tolist()) + ')' if rows <= 8 else ''}; single call {ms:.3f} ms, queued {queued:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us by {bound_by}, cuDNN GRU fp16 {library_ms:.3f} ms")
    return {"rows": rows, "launches_a_call": launched, "grid": launch.grid, "row_groups": launch.row_groups,
            "tiles_per_group": launch.tiles_per_group, "max_abs_err": err, "mean_abs_err": mean,
            "pre_flip_row_steps": pre_steps, "pre_flip_mean_abs_err": pre_mean, "ms": ms,
            "queued_ms": queued, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_tiers(runner, audio, smi: str) -> dict:
    """Phase 11; -> {"slice": each kernel's launches in each tier's 3 slice
    runs, "campaign": each kernel's launches over the campaign,
    "kernel_6_path": kernel 6's entries at the path's shapes}."""
    import torch

    from formula_vad_tpu_torch.ops import precision
    from formula_vad_tpu_torch.testing import tier_fuzz

    t_phase = time.perf_counter()
    audio_sec = SLICE_STREAMS * SLICE_SECONDS
    counters = path_counters()
    launches, results, walls = {}, {}, {}
    for tier, level, io, recurrence in TIER_RUNS:
        precision.set_matmul_precision(level)
        precision.set_io_dtype(io)
        try:
            results[tier], runs, launches[tier] = timed_runs(runner, audio, counters)
        finally:
            precision.set_matmul_precision("highest")
            precision.set_io_dtype("f32")
        walls[tier] = statistics.median(runs)
        want = dict(dict.fromkeys(counters, 0), scan_windows=3, **{recurrence: 3})
        if launches[tier] != want:
            raise AssertionError(f"the {tier} slice launched {launches[tier]} over 3 runs, not {want}")
        log(f"{tier} slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s: wall {walls[tier] * 1e3:.1f} ms (median of 3, runs "
            f"{[round(w * 1e3, 1) for w in runs]}), real-time factor {audio_sec / walls[tier]:.1f}; launches over "
            f"the 3 runs {launches[tier]}; on {smi}")
    log("tier slice medians (ms): " + ", ".join(f"{t} {w * 1e3:.1f}" for t, w in walls.items()))
    float_segs = [r.segments for r in results["float"]]
    if not sum(map(len, float_segs)):
        raise AssertionError("the float slice found no speech segment")
    if [r.segments for r in results["high"]] != float_segs:
        raise AssertionError("the high tier's slice segments differ from the float tier's")
    log(f"high slice segments: {sum(map(len, float_segs))}, identical to the float tier's")
    spans_within_a_window("bf16_io slice vs the float tier's", results["bf16_io"], results["float"])

    net, dev = runner.net, runner.device
    path = [gates_on_path(net, dev, rows, 6) for rows in (GRU_ROWS, CAMPAIGN_ROWS)]

    t0 = time.perf_counter()
    reset_counts(counters)
    stats = tier_fuzz.run_campaign(net, n_cases=CAMPAIGN_CASES, n_chunks=CAMPAIGN_CHUNKS)
    torch.cuda.synchronize()
    campaign = {name: fn.launches for name, fn in counters.items()}
    log(f"tier-fuzz campaign on the demo weights, {CAMPAIGN_CASES} cases of {CAMPAIGN_CHUNKS} chunks "
        f"({CAMPAIGN_ROWS} GRU rows and [1, {CAMPAIGN_CHUNKS * 24000 // 1024}] FSM windows a run): "
        f"{time.perf_counter() - t0:.1f} s on {smi}; launches {campaign}")
    for line in tier_fuzz.format_table(stats).splitlines():
        log(line)
    if (precision.matmul_precision(), precision.io_dtype()) != ("highest", None):
        raise AssertionError("the campaign left the tier switches changed")
    n = stats["highest"].n_cases
    # Each case: the probe and the highest run, and one run a tier.
    want = dict(dict.fromkeys(counters, 0), gru_stack=2 * n, gru_gates_3x=n, gru_gates_p=n, gru_gates_f=n,
                scan_windows=4 * n)
    if campaign != want:
        raise AssertionError(f"the campaign launched {campaign}, not {want}")
    if n != CAMPAIGN_CASES or stats["highest"].n_boundaries < n:
        raise AssertionError(f"the campaign is vacuous: {n} cases, {stats['highest'].n_boundaries} boundaries")
    # At high, every deviated case must be a known near-tie: each is run
    # alone (seed_base + case rebuilds it) and its deviations counted.
    high = stats["high"]
    known = {case: tier_fuzz.run_campaign(net, n_cases=1, n_chunks=CAMPAIGN_CHUNKS, seed_base=600_000 + case,
                                          tiers=tier_fuzz.TIERS[:1])["high"] for case in HIGH_KNOWN_TIES}
    log(f"high: {high.deviated_cases} deviated cases over the campaign; the known near-ties alone: "
        + ", ".join(f"case {c} {k.deviated_cases} ({k.n_shifted_boundaries} boundaries, max {k.max_shift_windows} "
                    f"window)" for c, k in known.items()))
    if high.seg_count_mismatch_cases or high.max_shift_windows > 1 \
            or high.deviated_cases != sum(k.deviated_cases for k in known.values()):
        raise AssertionError(f"the high tier deviated beyond its known near-ties: {high}")
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {"slice": launches, "campaign": campaign, "kernel_6_path": path, "walls": walls}


def kernel_1_at(net, dev, rows: int) -> dict:
    """Kernel 1 at a chunk step's ``rows`` x 54 steps (gi1 from random
    features, numpy seed ``rows``) against its plain version on the demo
    and the biased weights (GRU_TOL), with its launch plan, single and
    queued times, plain and cuDNN times and bound."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms

    plan = nsnet2_cuda.device_plan(rows, dev)
    rng = np.random.default_rng(rows)
    feats = torch.from_numpy(rng.normal(-3.0, 1.5, (rows, GRU_STEPS, 161)).astype(np.float32)).to(dev)
    gru = cudnn_gru(net, dev)
    err = 0.0
    with torch.inference_mode():
        x = net.fc_in(feats)
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
        for label, weights in (("demo", net), ("biased", biased_net(dev))):
            got = nsnet2_cuda.gru_stack(weights, gi1)
            want = nsnet2_cuda.gru_stack_reference(weights, gi1)
            e = float((got - want).abs().max()) if bool(torch.isfinite(got).all()) else float("inf")
            if not e <= GRU_TOL:
                raise AssertionError(f"GRU kernel disagrees with its plain version at [{rows}, {GRU_STEPS}], {label}: {e}")
            err = max(err, e)
        got = nsnet2_cuda.gru_stack(net, gi1)
        ms = cuda_ms(lambda: nsnet2_cuda.gru_stack(net, gi1))
        queued = queued_ms(lambda: nsnet2_cuda.gru_stack(net, gi1))
        plain_ms = cuda_ms(lambda: nsnet2_cuda.gru_stack_reference(net, gi1), reps=3)
        library_ms = cuda_ms(lambda: gru(x))
    ops = 3 * 2 * rows * 400 * 1200 * GRU_STEPS
    weights = (net.gru1.wh, net.gru1.bh, net.gru2.wi, net.gru2.bi, net.gru2.wh, net.gru2.bh)
    nbytes = gi1.nbytes + got.nbytes + sum(w.nbytes for w in weights)
    bound_ms, bound_by = bound(nbytes, ops, F32_OPS_PER_MS)
    log(f"GRU kernel at a chunk step's [{rows}, {GRU_STEPS}]: plan {plan.tiles} tiles of {plan.row_tile} rows x "
        f"{plan.unit_tile} units, grid {plan.grid}; max |dh2| {err:.3e} on the demo and biased weights (tolerance "
        f"{GRU_TOL}); single call {ms:.3f} ms, queued {queued:.3f} ms, plain {plain_ms:.3f} ms, cuDNN GRU "
        f"{library_ms:.3f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by}")
    return {"rows": rows, "steps": GRU_STEPS, "grid": plan.grid, "tiles": plan.tiles, "row_tile": plan.row_tile,
            "unit_tile": plan.unit_tile, "max_abs_err": err, "ms": ms, "queued_ms": queued, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def check_stream_fsm(net, st, audio, dev) -> dict:
    """The chained FSM calls of a streaming run of ``audio`` [B, 2, T] (one
    a chunk step, each continuing the last one's carry) against the host
    decoder and against the kernel's plain version: chained over the same
    chunks, all seven outputs at every slot and the final carry; and against
    the host decoder in one call over each stream's valid windows joined (a
    23-window chunk leaves its last slot empty between valid windows), the
    outputs at every valid slot and the final carry, every invalid slot
    inert. All bit for bit. Then the kernel at [B, 24]: its plan, a fresh and
    a chained call's times, its plain version's and its bound."""
    import torch

    from formula_vad_tpu_torch.pipeline import fsm, fsm_cuda, fsm_host, vad
    from formula_vad_tpu_torch.tools import cuda_ms

    with torch.inference_mode():
        carry, outs = vad.process_stream(net, st, torch.from_numpy(audio).to(dev))
    mv, rt, va = (x.cpu().numpy() for x in (outs.min_vol, outs.ratios, outs.window_valid))
    wb = outs.win_indices[..., 0].cpu().numpy()
    got = fsm.WindowOutput(*(x.cpu().numpy() for x in outs.windows))
    final = {k: v.cpu().numpy() for k, v in carry["fsm"].items()}
    shape, params = st.fsm_shape, st.fsm_params

    def same_carry(other, what):
        for key in final:
            if final[key].tobytes() != np.ascontiguousarray(other[key]).tobytes():
                raise AssertionError(f"streaming FSM != {what}: final carry {key}")

    def chunk_args(k):
        return [torch.from_numpy(np.ascontiguousarray(x[:, k])).to(dev) for x in (mv, rt, va)] + \
            [torch.from_numpy(np.ascontiguousarray(wb[:, k])).to(dev)]

    host_carry = plain_carry = None
    for k in range(mv.shape[1]):
        want, host_carry = fsm_host.scan_windows_host(shape, params, mv[:, k], rt[:, k], va[:, k], host_carry, wb[:, k])
        *args, base = chunk_args(k)
        plain, plain_carry = fsm_cuda.scan_windows_reference(shape, params, *args, plain_carry, base)
        for other, out in (("the host decoder", want), ("the plain version", plain)):
            for field, a, w in zip(got._fields, got, out):
                w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
                if np.ascontiguousarray(a[:, k]).tobytes() != np.ascontiguousarray(w).tobytes():
                    raise AssertionError(f"streaming FSM != {other} chained per chunk: chunk {k}, {field}")
    same_carry({k: v.cpu().numpy() for k, v in plain_carry.items()}, "the plain version chained per chunk")
    same_carry(host_carry, "the host decoder chained per chunk")
    b = mv.shape[0]
    flat = [x.reshape(b, -1) for x in (mv, rt, va)]
    n = flat[2].sum(axis=1)
    joined = [np.zeros((b, n.max()), np.float32) for _ in range(2)]
    for i in range(b):
        for j in range(2):
            joined[j][i, : n[i]] = flat[j][i, flat[2][i]]
    want, one_carry = fsm_host.scan_windows_host(shape, params, *joined, np.arange(n.max()) < n[:, None])
    for i in range(b):
        for field, a, w in zip(got._fields, got, want):
            a = a.reshape(b, -1)[i]
            if a[flat[2][i]].tobytes() != w[i, : n[i]].tobytes():
                raise AssertionError(f"streaming FSM != host decoder over the joined valid windows: s{i}, {field}")
            if field in ("event", "event_win", "seg_valid") and a[~flat[2][i]].any():
                raise AssertionError(f"streaming FSM: an invalid slot of s{i} is not inert ({field})")
    same_carry(one_carry, "the host decoder over the joined valid windows")
    events = np.bincount(want.event.reshape(-1), minlength=4)
    log(f"streaming FSM at [{b}, {mv.shape[2]}] over {mv.shape[1]} chunk calls ({int(va.sum())} valid windows of "
        f"{va.size} slots, events none/started/completed/aborted {events.tolist()}) == the host decoder and the plain "
        f"version chained per chunk, and the host decoder in one call over the joined valid windows: all 7 outputs "
        f"and the final carry, bit for bit")
    if events[2] == 0:
        raise AssertionError("the streaming FSM check saw no completed segment")

    # The kernel at a chunk step's [B, 24]: fresh (the first chunk) and
    # continuing a carry (every later one), as process_stream calls it.
    *first_args, first_base = chunk_args(0)
    *args, base = chunk_args(1)
    with torch.inference_mode():
        _, first_carry = fsm_cuda.scan_windows(shape, params, *first_args, win_base=first_base)
        plan = fsm_cuda.scan_windows.last_plan
        fresh_ms = cuda_ms(lambda: fsm_cuda.scan_windows(shape, params, *args, win_base=base))
        ms = cuda_ms(lambda: fsm_cuda._scan_chained(shape, params, *args, first_carry, base))
        plain_ms = cuda_ms(lambda: fsm_cuda.scan_windows_reference(shape, params, *args, first_carry, base), reps=3)
        out, out_carry = fsm_cuda._scan_chained(shape, params, *args, first_carry, base)
    nbytes = sum(x.nbytes for x in args) + base.nbytes + sum(x.nbytes for x in out) \
        + sum(x.nbytes for x in first_carry.values()) + sum(x.nbytes for x in out_carry.values())
    bound_ms, bound_by = bound(nbytes, 0, F32_OPS_PER_MS)
    log(f"FSM kernel at a chunk step's [{b}, {mv.shape[2]}]: plan {plan.body} body, {plan.ctas} CTAs of {plan.threads} "
        f"threads, tile {plan.tile}, {plan.smem_bytes} B shared a CTA; continuing a carry {ms:.4f} ms, fresh "
        f"{fresh_ms:.4f} ms, plain {plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by}")
    return {"rows": b, "windows": int(mv.shape[2]), "chunks": int(mv.shape[1]), "valid_windows": int(va.sum()),
            "slots": int(va.size), "body": plan.body, "ctas": plan.ctas, "max_abs_err": 0.0, "ms": ms,
            "fresh_ms": fresh_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def check_pipeline(net, stream, audio, counters, smi: str) -> dict:
    """The host AudioPipeline on one PIPELINE_SECONDS stereo stream ``audio`` pushed
    in irregular sizes: its segments against the streaming runner's, its
    recordings (one original and one denoised a segment that ends inside
    the stream, at its sample_from, its length), its launches, and the
    time from a chunk's PCM leaving the ring to its events (upload, step,
    fetch, events) beside the 500 ms chunk cadence."""
    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline, Callbacks

    want = stream.run(audio[None])[0].segments
    AudioPipeline(PipelineConfig(), net).push_samples(audio[:, : 2 * 24000])  # warm-up: a 2-row chunk step's caches
    recs = {"original": [], "denoised": []}
    pipe = AudioPipeline(PipelineConfig(), net, Callbacks(on_original_recording=recs["original"].append,
                                                          on_denoised_recording=recs["denoised"].append))
    latency = []
    process = pipe._process_chunk

    def timed(chunk):
        t0 = time.perf_counter()
        process(chunk)
        latency.append((time.perf_counter() - t0) * 1e3)

    pipe._process_chunk = timed
    reset_counts(counters)
    rng, pos = np.random.default_rng(5), 0
    while pos < audio.shape[1]:
        n = int(rng.integers(1000, 100_000))
        pipe.push_samples(audio[:, pos : pos + n])
        pos += n
    launches = {name: fn.launches for name, fn in counters.items()}
    chunks = audio.shape[1] // 24000
    if launches != dict(dict.fromkeys(counters, 0), gru_stack=chunks, scan_windows=chunks):
        raise AssertionError(f"AudioPipeline launched {launches} over {chunks} chunks")
    if not want or pipe.segments != want:
        raise AssertionError(f"AudioPipeline segments {pipe.segments} != the streaming runner's {want}")
    ends_inside = [seg for seg in want if seg["sample_to"] <= audio.shape[1]]
    for kind, bufs in recs.items():
        spans = [(b.global_start_frame_number, b.length, b.n_channels) for b in bufs]
        if spans != [(seg["sample_from"], seg["sample_to"] - seg["sample_from"], 1) for seg in ends_inside]:
            raise AssertionError(f"AudioPipeline {kind} recordings {spans} against the segments {ends_inside}")
    p50, p95 = (float(np.percentile(latency, q)) for q in (50, 95))
    log(f"AudioPipeline, one {PIPELINE_SECONDS:.0f} s stereo stream in irregular pushes: {len(want)} segments equal "
        f"to the streaming runner's; {len(ends_inside)} original and {len(ends_inside)} denoised recordings at each "
        f"segment's sample_from; launches {launches}; a chunk's PCM to its events {p50:.2f} ms p50, {p95:.2f} ms p95, "
        f"max {max(latency):.2f} ms over {len(latency)} chunks, against the 500 ms chunk cadence; on {smi}")
    return {"chunks": len(latency), "segments": len(want), "latency_p50_ms": p50, "latency_p95_ms": p95,
            "launches": launches}


def clip_frames(run_dir: str) -> dict:
    """{(instance, clip file): its sample count} of a simulator run."""
    from formula_vad_tpu_torch.io_ import AudioSource

    clips = {}
    for inst in sorted(d for d in os.listdir(run_dir) if os.path.isdir(os.path.join(run_dir, d))):
        for name in sorted(os.listdir(os.path.join(run_dir, inst))):
            src = AudioSource.open_stream(os.path.join(run_dir, inst, name))
            clips[(inst, name)] = src.n_frames
            src.close()
    return clips


def step_times(stream, audio) -> tuple[float, float]:
    """One streaming run of ``audio`` with each chunk step timed: -> the
    medians of its CUDA-event time and of the host time of its Python call,
    in ms, both logged with their ranges."""
    import torch

    from formula_vad_tpu_torch.pipeline import vad

    step = vad.chunk_step
    host_ms, marks = [], []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = step(*args, **kwargs)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        marks.append((start, end))
        return out

    vad.chunk_step = timed
    try:
        stream.run(audio)
    finally:
        vad.chunk_step = step
    torch.cuda.synchronize()
    event_ms = [a.elapsed_time(b) for a, b in marks]
    log(f"  a chunk step, over {len(marks)}: CUDA-event time median {statistics.median(event_ms):.3f} ms (min "
        f"{min(event_ms):.3f}, max {max(event_ms):.3f}); host time of the Python call median "
        f"{statistics.median(host_ms):.3f} ms (min {min(host_ms):.3f}, max {max(host_ms):.3f})")
    return statistics.median(event_ms), statistics.median(host_ms)


def profiled_busy(stream, audio, steps: int | None = STREAM_CHUNKS) -> tuple[float | None, float]:
    """One run of ``audio`` under torch.profiler: -> (the device's busy ms,
    or None where the trace holds no device event; the run's wall ms),
    logged with the launches (a chunk step, over ``steps`` chunk steps)
    and the top kernels."""
    import torch

    from formula_vad_tpu_torch.tools import busy_ms

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        stream.run(audio)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("  profiled run: the trace holds no device events")
        return None, wall
    busy, kernels, copies = busy_ms(events)
    n_kernels = sum(1 for e in events if not e.name.lower().startswith(("memcpy", "memset")))
    per_step = f", {n_kernels / steps:.0f} a chunk step" if steps else ""
    log(f"  profiled run: wall {wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / wall:.1f}%; kernels "
        f"{kernels:.1f} ms in {n_kernels} launches{per_step}; copies {copies:.1f} ms), idle {wall - busy:.1f} ms")
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("  profiled run, device time by kernel (ms): " + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    return busy, wall


def phase_stream(runner, audio, float_results, float_wall: float, corpus: str, batched_dir: str, smi: str) -> dict:
    """Phase 12; -> {"runs": each kernel's launches in each tier's streaming
    runs, "stream_shapes": each kernel of the path at a chunk step's shapes,
    "tiers": each tier's wall and chunk-step times, and the measures}."""
    from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_gates_cuda
    from formula_vad_tpu_torch.ops import matmul_q8, precision
    from formula_vad_tpu_torch.parallel.runner import BatchRunner
    from formula_vad_tpu_torch.pipeline import fsm_cuda
    from formula_vad_tpu_torch.testing.synth import synth_stream

    t_phase = time.perf_counter()
    net, dev, st = runner.net, runner.device, runner.st
    counters = {"gru_stack": nsnet2_cuda.gru_stack, "scan_windows": fsm_cuda.scan_windows,
                "gru_gates": nsnet2_gates_cuda.gru_gates, "gru_gates_p": nsnet2_gates_cuda.gru_gates_p,
                "gru_gates_f": nsnet2_gates_cuda.gru_gates_f, "matmul_q8": matmul_q8.matmul_q8}
    stream = BatchRunner(net, use_offline=False)
    audio_sec = SLICE_STREAMS * SLICE_SECONDS
    runs, tiers = {}, {}
    for tier, level, io, quant, recurrence, per_step in STREAM_TIERS:
        precision.set_matmul_precision(level)
        precision.set_io_dtype(io)
        precision.set_quant(quant)
        try:
            results, walls, runs[tier] = timed_runs(stream, audio, counters)
            log(f"{tier} streaming slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s ({STREAM_CHUNKS} chunk steps a run):")
            event_ms, host_ms = step_times(stream, audio)
            busy, prof_wall = profiled_busy(stream, audio)
            offline = float_results if tier == "float" else runner.run(audio)
        finally:
            precision.set_matmul_precision("highest")
            precision.set_io_dtype("f32")
            precision.set_quant("off")
        want = dict(dict.fromkeys(counters, 0), scan_windows=3 * STREAM_CHUNKS,
                    **{recurrence: 3 * per_step * STREAM_CHUNKS})
        if runs[tier] != want:
            raise AssertionError(f"the {tier} streaming slice launched {runs[tier]} over 3 runs, not {want}")
        wall = statistics.median(walls)
        tiers[tier] = {"wall_ms": wall * 1e3, "runs_ms": [w * 1e3 for w in walls], "rtf": audio_sec / wall,
                       "step_event_ms": event_ms, "step_host_ms": host_ms, "busy_ms": busy,
                       "profiled_wall_ms": prof_wall}
        log(f"  {tier}: wall {wall * 1e3:.1f} ms (median of 3 after a warm-up, runs "
            f"{[round(w * 1e3, 1) for w in walls]}), real-time factor {audio_sec / wall:.1f}; launches over the 3 runs "
            f"{runs[tier]}; on {smi}")
        if tier == "float":
            log(f"  the offline path's real-time factor on the same slice: {audio_sec / float_wall:.1f} (phase 4)")
            got, off = [r.segments for r in results], [r.segments for r in offline]
            if got != off:
                for i, (g, w) in enumerate(zip(got, off)):
                    if g != w:
                        log(f"s{i} streaming: {g}\ns{i} offline:   {w}")
                raise AssertionError("the streaming slice's segments differ from phase 4's offline segments")
            log(f"  streaming slice segments: {sum(map(len, got))}, identical to phase 4's offline segments")
            float_segments = got
        else:
            spans_within_a_window(f"  {tier} streaming slice vs the {tier} offline run", results, offline)

    pipe_audio = synth_stream(np.random.default_rng(4), PIPELINE_SECONDS)[0]
    # Every kernel of the path at a chunk step's shapes against its plain
    # version: the slice's B = 21 streams (42 GRU rows) and AudioPipeline's
    # one stereo stream (2 rows).
    fsm_shapes = [check_stream_fsm(net, st, audio, dev), check_stream_fsm(net, st, pipe_audio[None], dev)]
    shapes = {"gru_stack": [kernel_1_at(net, dev, rows) for rows in STREAM_ROWS],
              "gru_gates_p": [gates_on_path(net, dev, rows, 5) for rows in STREAM_ROWS],
              "gru_gates_f": [gates_on_path(net, dev, rows, 6) for rows in STREAM_ROWS],
              "matmul_q8": [q8_at(dev, rows) for rows in STREAM_ROWS],
              "scan_windows": fsm_shapes}
    pipeline = check_pipeline(net, stream, pipe_audio, counters, smi)

    outs = run_simulators(corpus, {"stream_cuda": ("cuda", {}), "stream_cpu": ("cpu", {})})
    outs["batched_cuda"] = batched_dir
    for name in ["report.txt"] + [f"s{i}-audacity.txt" for i in range(CORPUS_STREAMS)]:
        texts = {plan: read_text(d, name) for plan, d in outs.items()}
        if len(set(texts.values())) != 1:
            for plan, text in texts.items():
                log(f"--- {name}, {plan}:\n{text}")
            raise AssertionError(f"{name} differs between the streaming cuda, streaming cpu and batched cuda runs")
    clips = {plan: clip_frames(d) for plan, d in outs.items()}
    if not clips["batched_cuda"] or not clips["stream_cuda"] == clips["stream_cpu"] == clips["batched_cuda"]:
        raise AssertionError(f"the streaming plans' clips differ from the batched plan's: {clips}")
    log(f"streaming simulator plans on cuda and cpu: report.txt and Audacity files identical to each other and to "
        f"phase 5's batched cuda plan; {len(clips['batched_cuda'])} clips with the batched plan's names and sample counts")
    log("streaming tiers (median wall ms; chunk step event / host ms; device busy %): " + "; ".join(
        f"{t} {v['wall_ms']:.1f}, {v['step_event_ms']:.3f} / {v['step_host_ms']:.3f}, "
        + ("not traced" if v["busy_ms"] is None else f"{100 * v['busy_ms'] / v['profiled_wall_ms']:.1f}%")
        for t, v in tiers.items()))
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, "stream_shapes": shapes, "pipeline": pipeline, "tiers": tiers,
            "offline_rtf": audio_sec / float_wall, "float_segments": float_segments}


def path_counters() -> dict:
    """Every kernel wrapper of the port, by its name in the kernels line."""
    from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_gates_cuda
    from formula_vad_tpu_torch.ops import matmul_q8
    from formula_vad_tpu_torch.pipeline import fsm_cuda

    return {"gru_stack": nsnet2_cuda.gru_stack, "scan_windows": fsm_cuda.scan_windows,
            "gru_gates": nsnet2_gates_cuda.gru_gates, "gru_gates_p": nsnet2_gates_cuda.gru_gates_p,
            "gru_gates_f": nsnet2_gates_cuda.gru_gates_f, "matmul_q8": matmul_q8.matmul_q8,
            "gru_gates_3x": nsnet2_gates_cuda.gru_gates_3x, "gru_stack_mixed": nsnet2_cuda.gru_stack_mixed}


def recorders(n: int, slot_of=None):
    """({"original": [...], "denoised": [...]} of (start frame, samples) a
    stream, and the Callbacks that fill them)."""
    from formula_vad_tpu_torch.pipeline.pipeline import Callbacks

    recs = {"original": [[] for _ in range(n)], "denoised": [[] for _ in range(n)]}

    def cb(i):
        return Callbacks(
            on_original_recording=lambda b: recs["original"][i].append((b.global_start_frame_number, b.channel_pcm.copy())),
            on_denoised_recording=lambda b: recs["denoised"][i].append((b.global_start_frame_number, b.channel_pcm.copy())),
        )

    return recs, [cb(i) for i in range(n)]


def serve_run(net, chunks, record: bool = True, **kw) -> dict:
    """One OnlineBatchServer run of ``chunks`` [ticks, B, C, 24000]
    (float32 or int16), every stream valid every tick: its segments,
    recordings, each tick's host outputs (``record``), tick_stats, and on
    the host's clock each push (ingest included) and each shard's fetch
    (its wait for its copies, and the host-FSM decode where on)."""
    import torch

    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.parallel.online import OnlineBatchServer

    n_ticks, b = chunks.shape[:2]
    recs, cbs = recorders(b)
    server = OnlineBatchServer(PipelineConfig(), b, params=net, callbacks=cbs, **kw)
    ticks, fetch_ms, push_ms = [], [], []
    run_step, finish = server._run_step, server._finish_fetch

    def step(c, v):
        out = run_step(c, v)
        if record:
            ticks.append({k: x.copy() for k, x in out.items()})
        return out

    def timed_finish(*args):
        t0 = time.perf_counter()
        out = finish(*args)
        fetch_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    server._run_step, server._finish_fetch = step, timed_finish
    for k in range(n_ticks):
        t0 = time.perf_counter()
        server.push(chunks[k])
        push_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {"segments": server.segments, "recs": recs, "ticks": ticks, "stats": server.tick_stats(),
            "fetch_ms": fetch_ms, "push_ms": push_ms}


def same_recordings(what: str, got: dict, want: dict, exact: bool) -> float:
    """Original recordings bit for bit; denoised ones at the same starts,
    bit for bit or (``exact`` False) within SERVE_ROWS_TOL, or absent in
    ``got`` (the events-only tier). -> their max |difference|."""
    err = 0.0
    for kind in ("original", "denoised"):
        if kind == "denoised" and not any(got[kind]):
            continue
        for i, (g, w) in enumerate(zip(got[kind], want[kind])):
            if [s for s, _ in g] != [s for s, _ in w]:
                raise AssertionError(f"{what}: stream {i}'s {kind} recordings start at {[s for s, _ in g]}, "
                                     f"not {[s for s, _ in w]}")
            for (start, a), (_, b) in zip(g, w):
                if a.shape != b.shape:
                    raise AssertionError(f"{what}: stream {i}'s {kind} recording at {start}: {a.shape} != {b.shape}")
                e = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
                if (kind == "original" or exact) and a.tobytes() != b.tobytes() or e > SERVE_ROWS_TOL:
                    raise AssertionError(f"{what}: stream {i}'s {kind} recording at {start} differs by {e}")
                err = max(err, e)
    return err


def same_serving(what: str, got: dict, want: dict, exact: bool) -> float:
    """Two serving runs of the same audio: segments, original recordings
    and every decision and index of every tick bit for bit; the float
    outputs (denoised audio and recordings, window volumes and ratios) bit
    for bit, or (``exact`` False) within SERVE_ROWS_TOL. -> their max
    |difference| (0.0: bit for bit)."""
    if got["segments"] != want["segments"]:
        raise AssertionError(f"{what}: segments differ:\n{got['segments']}\n!=\n{want['segments']}")
    err = same_recordings(what, got["recs"], want["recs"], exact)
    if len(got["ticks"]) != len(want["ticks"]):
        raise AssertionError(f"{what}: {len(got['ticks'])} ticks recorded, not {len(want['ticks'])}")
    for k, (g, w) in enumerate(zip(got["ticks"], want["ticks"])):
        for field, a in g.items():
            b = w[field]
            if a.size == 0 and field == "denoised":
                continue
            if a.dtype.kind == "f":
                e = float(np.abs(a.astype(np.float64) - b).max())
                if exact and a.tobytes() != b.tobytes() or e > SERVE_ROWS_TOL:
                    raise AssertionError(f"{what}: tick {k} {field} differs by {e}")
                err = max(err, e)
            elif a.tobytes() != b.tobytes():
                raise AssertionError(f"{what}: tick {k} {field} differs")
    return err


def launches_of(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def check_launches(what: str, counters, **want) -> dict:
    got = launches_of(counters)
    if got != dict(dict.fromkeys(counters, 0), **want):
        raise AssertionError(f"{what} launched {got}, not {want} and nothing else")
    return got


def serve_stats(what: str, run: dict, smi: str) -> dict:
    """Log a serving run's tick latencies, pushes and fetches; -> them."""
    st = run["stats"]
    push, fetch = run["push_ms"], run["fetch_ms"]
    log(f"  {what}: tick p50 {st['p50_ms']:.3f} ms, p95 {st['p95_ms']:.3f} ms, max {st['max_ms']:.3f} ms over "
        f"{st['window']} ticks of {st['streams']} streams ({st['over_budget']} over the {st['budget_ms']:.0f} ms "
        f"budget); a push (tick and ingest) p50 {statistics.median(push):.3f} ms, p95 "
        f"{float(np.percentile(push, 95)):.3f} ms; a shard's fetch p50 {statistics.median(fetch):.3f} ms over "
        f"{len(fetch)}; on {smi}")
    return {"tick_p50_ms": st["p50_ms"], "tick_p95_ms": st["p95_ms"], "tick_max_ms": st["max_ms"],
            "over_budget": st["over_budget"], "push_p50_ms": statistics.median(push),
            "push_p95_ms": float(np.percentile(push, 95)), "fetch_p50_ms": statistics.median(fetch),
            "streams": st["streams"], "ticks": st["window"]}


def serve_fleet(net, audio, offline_results, stream_segments, counters, smi: str) -> dict:
    """Phase 13 (a): the slice's fleet and its variants."""
    n_ticks = audio.shape[-1] // 24000
    b = audio.shape[0]
    chunks = np.ascontiguousarray(audio[..., : n_ticks * 24000].reshape(b, 2, n_ticks, 24000).transpose(2, 0, 1, 3))
    serve_run(net, chunks[:2], record=False)  # warm-up: caches, pinned buffers of this shape
    reset_counts(counters)
    main = serve_run(net, chunks)
    launches = check_launches("the serving fleet", counters, gru_stack=n_ticks, scan_windows=n_ticks)
    if main["segments"] != [r.segments for r in offline_results] or main["segments"] != stream_segments:
        raise AssertionError("the serving fleet's segments differ from phase 4's offline or phase 12's streaming run")
    n_segments = sum(map(len, main["segments"]))
    if not n_segments:
        raise AssertionError("the serving fleet found no segment")
    log(f"serving fleet {b} x {n_ticks} ticks (float tier, device FSM): {n_segments} segments identical to phase 4's "
        f"offline and phase 12's streaming runs; {sum(map(len, main['recs']['original']))} original and "
        f"{sum(map(len, main['recs']['denoised']))} denoised recordings; launches {launches}")
    out = {"fleet": serve_stats("device FSM", main, smi), "launches": launches, "variants": {}}
    pcm = np.clip(np.round(chunks * 32768.0), -32768, 32767).astype(np.int16)
    for name, kw, want_launches, exact in (
        ("host_fsm", dict(use_host_fsm=True), dict(gru_stack=n_ticks), True),
        ("microbatch_3", dict(microbatch=3), dict(gru_stack=3 * n_ticks, scan_windows=3 * n_ticks), False),
        ("events_only", dict(collect_denoised=False), dict(gru_stack=n_ticks, scan_windows=n_ticks), True),
    ):
        reset_counts(counters)
        run = serve_run(net, chunks, **kw)
        check_launches(f"the serving fleet with {name}", counters, **want_launches)
        err = same_serving(f"serving fleet, {name} against the default", run, main, exact)
        out["variants"][name] = dict(serve_stats(name, run, smi), max_abs_err=err, bitwise=err == 0.0,
                                     launches=launches_of(counters))
        log(f"  {name}: segments, original recordings, decisions and indices bit for bit with the default run; "
            f"float outputs {'bit for bit' if err == 0.0 else f'within {err:.3e}'}")
    reset_counts(counters)
    as_float = serve_run(net, pcm.astype(np.float32) / np.float32(32768.0))
    as_int16 = serve_run(net, pcm)
    check_launches("the serving fleet's float32 and int16 pushes", counters, gru_stack=2 * n_ticks,
                   scan_windows=2 * n_ticks)
    same_serving("serving fleet, int16 push against float32 push", as_int16, as_float, True)
    out["variants"]["int16_push"] = dict(serve_stats("int16 push", as_int16, smi), max_abs_err=0.0, bitwise=True)
    log("  int16 push: bit for bit with the float32 push of the same PCM16 samples")
    return out


@contextlib.contextmanager
def host_split():
    """Time, over every AudioPipeline, the ring writes with their recorders
    (``_write_and_record``, both rings) and the rest of a chunk's output
    consumption (``_consume_chunk_output`` less its denoised ring write), in
    ms summed over the block: {"rings": .., "events": ..}."""
    from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline

    split = {"rings": 0.0, "events": 0.0}
    write, consume = AudioPipeline._write_and_record, AudioPipeline._consume_chunk_output

    def timed_write(self, *args):
        t0 = time.perf_counter()
        write(self, *args)
        split["rings"] += (time.perf_counter() - t0) * 1e3

    def timed_consume(self, out):
        before = split["rings"]
        t0 = time.perf_counter()
        consume(self, out)
        split["events"] += (time.perf_counter() - t0) * 1e3 - (split["rings"] - before)

    AudioPipeline._write_and_record, AudioPipeline._consume_chunk_output = timed_write, timed_consume
    try:
        yield split
    finally:
        AudioPipeline._write_and_record, AudioPipeline._consume_chunk_output = write, consume


def serve_big(net, audio, counters, smi: str) -> dict:
    """Phase 13 (b): SERVE_BIG_STREAMS streams over SERVE_BIG_TICKS ticks,
    each a window of a slice stream at its own offset. Kernel 2's chained
    check runs over twice the ticks: a fresh stream completes no segment in
    its first 4 s."""
    from formula_vad_tpu_torch.config import VADConfig
    from formula_vad_tpu_torch.pipeline import vad

    b, n = SERVE_BIG_STREAMS, SERVE_BIG_TICKS
    src = np.stack([audio[j % SLICE_STREAMS, :, 2 * (j // SLICE_STREAMS) * 24000:][:, : 2 * n * 24000]
                    for j in range(b)])
    chunks = np.ascontiguousarray(src[..., : n * 24000].reshape(b, 2, n, 24000).transpose(2, 0, 1, 3))
    serve_run(net, chunks[:1], record=False)  # warm-up at this fleet's shapes
    reset_counts(counters)
    with host_split() as split:
        run = serve_run(net, chunks, record=False)
    launches = check_launches(f"the {b}-stream fleet", counters, gru_stack=n, scan_windows=n)
    rings_gb = b * 2 * 2 * 10 * 48000 * 4 / 1e9
    log(f"serving fleet {b} x {n} ticks ({2 * b} GRU rows a tick, {rings_gb:.2f} GB of host rings): launches {launches}")
    stats = serve_stats(f"{b} streams", run, smi)
    stats.update({f"{k}_ms_a_tick": v / n for k, v in split.items()})
    log(f"  {b} streams, the host's ingest a tick: ring writes and recorders {split['rings'] / n:.1f} ms, the rest of "
        f"the outputs' consumption (events, segments) {split['events'] / n:.1f} ms, against a push's "
        f"{sum(run['push_ms']) / n:.1f} ms and a tick's {stats['tick_p50_ms']:.1f} ms (p50)")
    st = vad.statics_from_config(VADConfig())
    dev = next(net.parameters()).device
    shapes = {"gru_stack": [kernel_1_at(net, dev, 2 * b)], "scan_windows": [check_stream_fsm(net, st, src, dev)]}
    return {"fleet": stats, "launches": launches, "serve_shapes": shapes}


def ragged_plan(audio) -> tuple[list, list, list]:
    """Phase 13 (c)'s ticks: 4 slots on a random valid pattern (numpy seed
    13, tick 0 all valid), each slot serving slice stream i; slot 2 reset at
    SERVE_RESET_TICK to slice stream 4. -> (each tick's (valid, chunks),
    each logical stream's chunks in order (slots 0-3, then slot 2's new
    stream), each tick's slot -> logical stream)."""
    rng = np.random.default_rng(13)
    n = audio.shape[-1] // 24000
    sources = [0, 1, 2, 3]
    pos = [0] * 4
    logical = [[] for _ in range(5)]
    ticks, owners = [], []
    k = 0
    while True:
        if k == SERVE_RESET_TICK:
            sources[2], pos[2] = 4, 0
        owner = [4 if (i == 2 and k >= SERVE_RESET_TICK) else i for i in range(4)]
        left = np.array([pos[i] < n for i in range(4)])
        if not left.any():
            break
        valid = (np.ones(4, bool) if k == 0 else rng.random(4) < 0.75) & left
        chunk = np.zeros((4, 2, 24000), np.float32)
        for i in np.nonzero(valid)[0]:
            chunk[i] = audio[sources[i], :, pos[i] * 24000 : (pos[i] + 1) * 24000]
            logical[owner[i]].append(chunk[i])
            pos[i] += 1
        ticks.append((valid, chunk))
        owners.append(owner)
        k += 1
    return ticks, logical, owners


def serve_ragged(net, audio, counters, smi: str) -> dict:
    """Phase 13 (c): ragged serving with a reset, against solo pipelines;
    then a checkpoint and a resume against the uninterrupted run."""
    import torch

    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.parallel.online import OnlineBatchServer
    from formula_vad_tpu_torch.pipeline import fsm
    from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline

    ticks, logical, owners = ragged_plan(audio)

    def serve(server, cbs, span, segments):
        """Push ``ticks[span]``, resetting slot 2 to logical stream 4 at
        SERVE_RESET_TICK; keep the old slot 2's segments in ``segments``."""
        for k in span:
            if k == SERVE_RESET_TICK:
                segments[2] = list(server.pipelines[2].segments)
                server.reset_stream(2, cbs[4])
            server.push(ticks[k][1], valid=ticks[k][0])

    def new_server(cbs):
        return OnlineBatchServer(PipelineConfig(), SERVE_RAGGED_STREAMS, params=net, callbacks=cbs[:4])

    recs_a, cbs_a = recorders(5)
    server_a = new_server(cbs_a)
    segs_a = {}
    reset_counts(counters)
    serve(server_a, cbs_a, range(len(ticks)), segs_a)
    check_launches("the ragged fleet", counters, gru_stack=len(ticks), scan_windows=len(ticks))
    segs_a.update({0: server_a.segments[0], 1: server_a.segments[1], 3: server_a.segments[3],
                   4: server_a.segments[2]})

    recs_solo, cbs_solo = recorders(5)
    segs_solo = {}
    for i, chunks in enumerate(logical):
        pipe = AudioPipeline(PipelineConfig(), net, cbs_solo[i])
        pipe.push_samples(np.concatenate(chunks, axis=1))
        segs_solo[i] = pipe.segments
    if segs_solo != segs_a:
        raise AssertionError(f"ragged serving with a reset: segments {segs_a} != solo pipelines' {segs_solo}")
    solo_err = same_recordings("ragged serving against solo pipelines", recs_a, recs_solo, exact=False)

    # A checkpoint at SERVE_SAVE_TICK, loaded by a new server.
    recs_b, cbs_b = recorders(5)
    server_b = new_server(cbs_b)
    segs_b = {}
    serve(server_b, cbs_b, range(SERVE_SAVE_TICK), segs_b)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        server_b.save_state(ckpt)
        save_ms = (time.perf_counter() - t0) * 1e3
        before = [list(s) for s in server_b.segments]
        recs_c, cbs_c = recorders(5)
        server_c = OnlineBatchServer(PipelineConfig(), SERVE_RAGGED_STREAMS, params=net,
                                     callbacks=[cbs_c[i] for i in (0, 1, 4, 3)])
        t0 = time.perf_counter()
        server_c.load_state(ckpt)
        load_ms = (time.perf_counter() - t0) * 1e3
    checked = []
    check_carry = fsm.check_carry

    def counted(shape, carry, b, indices=True):
        checked.append(indices)
        return check_carry(shape, carry, b, indices)

    fsm.check_carry = counted
    try:
        for k in range(SERVE_SAVE_TICK, len(ticks)):
            server_c.push(ticks[k][1], valid=ticks[k][0])
    finally:
        fsm.check_carry = check_carry
    torch.cuda.synchronize()
    if checked[0] is not True or any(checked[1:]):
        raise AssertionError(f"after the load the FSM's carry checks were {checked}: not the checked path once, then chained")
    segs_bc = {i: before[i] + server_c.segments[i] for i in (0, 1, 3)}
    segs_bc[2] = segs_b[2]
    segs_bc[4] = before[2] + server_c.segments[2]
    if segs_bc != segs_a:
        raise AssertionError(f"resumed serving: segments {segs_bc} != the uninterrupted run's {segs_a}")
    joined = {kind: [recs_b[kind][i] + recs_c[kind][i] for i in range(5)] for kind in recs_b}
    same_recordings("resumed serving against the uninterrupted run", joined, recs_a, exact=True)
    n_recs = sum(map(len, recs_a["original"]))
    log(f"ragged serving, {SERVE_RAGGED_STREAMS} slots x {len(ticks)} ticks, a reset at tick {SERVE_RESET_TICK}: "
        f"{sum(len(v) for v in segs_a.values())} segments and {n_recs} original recordings equal to 5 solo "
        f"AudioPipelines' (denoised recordings within {solo_err:.3e}); a save_state at tick {SERVE_SAVE_TICK} "
        f"({save_ms:.1f} ms) and a new server's load_state ({load_ms:.1f} ms): segments and recordings bit for bit "
        f"with the uninterrupted run; the FSM carry checked once after the load, then chained "
        f"({len(checked)} scans); on {smi}")
    return {"ticks": len(ticks), "segments": sum(len(v) for v in segs_a.values()), "recordings": n_recs,
            "solo_denoised_max_abs": solo_err, "save_ms": save_ms, "load_ms": load_ms}


class DaemonProcess:
    """A daemon as a process on the card: newline-JSON in, lines out (a
    reader thread), standard error to a file."""

    def __init__(self, module: str, args: list[str], err_path: str):
        import threading

        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.err = open(err_path, "w")
        self.proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self.err, text=True)
        self.lines: list[str] = []
        self.reader = threading.Thread(target=self._pump, daemon=True)
        self.reader.start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def send(self, lines):
        for line in lines:
            self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def wait_for(self, line: str, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        while line not in self.lines:
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.kill()
                raise AssertionError(f"no {line} from the daemon (rc {self.proc.returncode})")
            time.sleep(0.02)

    def finish(self, timeout: float = 300.0) -> list[str]:
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=timeout)
        self.reader.join(timeout=30)
        self.err.close()
        if rc != 0:
            raise AssertionError(f"daemon exited {rc}:\n{open(self.err.name).read()[-4000:]}")
        return list(self.lines)

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=60)
        self.reader.join(timeout=30)
        self.proc.stdin.close()
        self.err.close()


def wav_tree(root: str) -> dict:
    """{relative path: bytes} of every WAV under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            if name.endswith(".wav"):
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


def serve_daemons(corpus: str, smi: str) -> dict:
    """Phase 13 (d): the multidaemon SIGKILLed after its second checkpoint
    ack and resumed, against an uninterrupted run; the solo daemon on one
    stream against the multidaemon's."""
    import io

    from formula_vad_tpu_torch.apps.multidaemon import MultiDaemon
    from formula_vad_tpu_torch.io_.audio import AudioBuffer

    streams = [f"s{i}" for i in range(CORPUS_STREAMS)]
    wav = [os.path.join(corpus, f"s{i}.wav") for i in range(CORPUS_STREAMS)]
    cmds = [json.dumps(c) for c in (
        {"action": "segment", "stream": "s0", "file_path": wav[0], "playhead_timestamp_ms": 0},
        {"action": "segment", "stream": "s1", "file_path": wav[1], "playhead_timestamp_ms": 1000},
        {"action": "segment", "stream": "s2", "file_path": wav[2], "playhead_timestamp_ms": 2000},
        {"action": "skip_segment", "stream": "s0"},
        {"action": "segment", "stream": "s1", "file_path": wav[0], "playhead_timestamp_ms": 40000},
        {"action": "segment", "stream": "s2", "file_path": wav[1], "playhead_timestamp_ms": 50000},
        {"action": "segment", "stream": "s0", "file_path": wav[2], "playhead_timestamp_ms": 60000},
    )]
    args = ["-n", "RACE", "--streams", ",".join(streams), "--denoiser", "demo", "--checkpoint-every", "1"]
    with tempfile.TemporaryDirectory() as root:
        out_a, out_b, out_solo = (os.path.join(root, d) for d in ("a", "b", "solo"))
        for d in (out_a, out_b, out_solo):
            os.makedirs(d)
        t0 = time.perf_counter()
        buf = io.StringIO()
        MultiDaemon("RACE", out_a, streams, "demo", stdout=buf, state_dir=os.path.join(root, "state_a"),
                    checkpoint_every=1).run(stdin=io.StringIO("".join(c + "\n" for c in cmds)))
        want = [line.replace(out_a, "OUT") for line in buf.getvalue().splitlines()]
        uninterrupted_s = time.perf_counter() - t0
        if not any('"recording"' in line for line in want):
            raise AssertionError("the multidaemon's run made no recording")

        state = os.path.join(root, "state_b")
        t0 = time.perf_counter()
        first = DaemonProcess("formula_vad_tpu_torch.apps.multidaemon", ["-o", out_b, "--state", state, *args],
                              os.path.join(root, "first.err"))
        first.send(cmds[:2])
        first.wait_for(json.dumps({"action": "checkpoint", "commands_processed": 2}))
        first.send(cmds[2:3])  # in flight when the SIGKILL lands
        time.sleep(0.05)
        first.kill()
        # The supervisor keeps the lines up to the last ack and replays stdin from there.
        acks = [i for i, line in enumerate(first.lines) if json.loads(line)["action"] == "checkpoint"]
        kept = first.lines[: acks[-1] + 1]
        acked = json.loads(kept[-1])["commands_processed"]
        second = DaemonProcess("formula_vad_tpu_torch.apps.multidaemon", ["-o", out_b, "--state", state, *args],
                               os.path.join(root, "second.err"))
        second.send(cmds[acked:])
        got = [line.replace(out_b, "OUT") for line in kept + second.finish()]
        resumed_s = time.perf_counter() - t0
        if got != want:
            raise AssertionError("the resumed multidaemon's events differ from the uninterrupted run's:\n"
                                 + "\n".join(got) + "\n!=\n" + "\n".join(want))
        tree_a, tree_b = wav_tree(out_a), wav_tree(out_b)
        if tree_a != tree_b or not tree_a:
            raise AssertionError(f"the resumed multidaemon's WAVs differ: {sorted(tree_a)} vs {sorted(tree_b)}")

        t0 = time.perf_counter()
        solo = DaemonProcess("formula_vad_tpu_torch.apps.daemon", ["-o", out_solo, "-n", "RACE", "--denoiser", "demo"],
                             os.path.join(root, "solo.err"))
        solo.send([json.dumps({k: v for k, v in json.loads(c).items() if k != "stream"})
                   for c in cmds if json.loads(c)["stream"] == "s1"])
        solo.finish()
        solo_s = time.perf_counter() - t0
        tree_solo = wav_tree(out_solo)
        mine = {os.path.basename(k): v for k, v in tree_a.items() if k.startswith("s1" + os.sep)}
        if sorted(tree_solo) != sorted(mine) or not mine:
            raise AssertionError(f"the solo daemon's WAVs {sorted(tree_solo)} != the multidaemon's s1 {sorted(mine)}")
        den_err = 0.0
        for name, data in tree_solo.items():
            if name.endswith("-original.wav") and data != mine[name]:
                raise AssertionError(f"the solo daemon's {name} differs from the multidaemon's")
            if name.endswith("-denoised.wav"):
                a = AudioBuffer.load_from_file(os.path.join(out_solo, name)).channel_pcm
                b = AudioBuffer.load_from_file(os.path.join(out_a, "s1", name)).channel_pcm
                den_err = max(den_err, float(np.abs(a.astype(np.float64) - b).max()))
        if den_err > SERVE_ROWS_TOL:
            raise AssertionError(f"the solo daemon's denoised WAVs differ from the multidaemon's by {den_err}")
    n_recs = sum('"recording"' in line for line in want)
    log(f"daemons on the card over phase 5's corpus ({len(cmds)} commands, {n_recs} recordings, {len(tree_a)} WAVs): "
        f"the multidaemon SIGKILLed after its ack of command 2 (replayed from command {acked + 1}) and resumed from "
        f"its state directory: events and WAVs "
        f"byte for byte with the uninterrupted run ({uninterrupted_s:.1f} s in this process; killed and resumed "
        f"processes {resumed_s:.1f} s); the solo daemon on s1: {len(tree_solo)} WAVs, the originals byte for byte "
        f"with the multidaemon's, the denoised ones {'byte for byte' if den_err == 0 else f'within {den_err:.3e}'} "
        f"({solo_s:.1f} s); on {smi}")
    return {"commands": len(cmds), "recordings": n_recs, "wavs": len(tree_a), "solo_denoised_max_abs": den_err,
            "uninterrupted_s": uninterrupted_s, "killed_and_resumed_s": resumed_s, "solo_s": solo_s}


def phase_serve(net, audio, offline_results, stream_segments, corpus: str, smi: str) -> dict:
    """Phase 13; -> {"launches": each kernel's launches in the slice
    fleet's run, "serve_shapes": kernels 1 and 2 at the large fleet's
    shapes, and the measures}."""
    t_phase = time.perf_counter()
    counters = path_counters()
    fleet = serve_fleet(net, audio, offline_results, stream_segments, counters, smi)
    big = serve_big(net, audio, counters, smi)
    ragged = serve_ragged(net, audio, counters, smi)
    daemons = serve_daemons(corpus, smi)
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": fleet.pop("launches"), "serve_shapes": big.pop("serve_shapes"), "fleet": fleet,
            "big": big, "ragged": ragged, "daemons": daemons}


def _nonzero_state(rows: int, seed: int, dev):
    """A GRU state (h1, h2) as a run leaves one: tanh of N(0, 0.8), numpy seed ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (rows, 400))).astype(np.float32)).to(dev)
                 for _ in range(2))


def _hop_features(net, dev, rows: int, seed: int):
    """The fc_in output of one hop's random features a row, [rows, 1, 400]."""
    import torch

    feats = torch.from_numpy(np.random.default_rng(seed).normal(-3.0, 1.5, (rows, 1, 161)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        return feats, net.fc_in(feats)


def state_kernel_1_at(net, dev, rows: int) -> dict:
    """Kernel 1 at a low-latency hop, [rows, 1], continuing a nonzero state:
    ``kernel_1_with_a_state`` on one hop's random features a row."""
    import torch

    _, x = _hop_features(net, dev, rows, rows)
    with torch.inference_mode():
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
    return kernel_1_with_a_state(net, x, gi1, _nonzero_state(rows, rows + 1, dev), "at a hop's")


def kernel_1_with_a_state(net, x, gi1, state, what: str, launched=None) -> dict:
    """Kernel 1 on ``gi1`` [rows, T, 1200] continuing ``state``, against its
    plain version (LL_TOL, the sequence and the final state): the wrapper's
    output ``launched`` where the caller caught it on its path, else a new
    call's; with its plan, single and queued times, plain time, bound and
    cuDNN's two-layer GRU from the same h0 on ``x``, the fc_in output that
    ``gi1`` projects."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms

    rows, steps = gi1.shape[:2]
    dev = gi1.device
    plan = nsnet2_cuda.device_plan(rows, dev)
    gru = cudnn_gru(net, dev)
    h0 = torch.stack(state).contiguous()  # [layers, rows, 400]
    with torch.inference_mode():
        got, (h1, h2) = launched if launched is not None else nsnet2_cuda.gru_stack(net, gi1, state)
        want, (w1, w2) = nsnet2_cuda.gru_stack_reference(net, gi1, state)
        err = max(float((a - b).abs().max()) for a, b in ((got, want), (h1, w1), (h2, w2)))
        lib_out, _ = gru(x, h0)
        lib_err = float((lib_out - got).abs().max())
        if not err <= LL_TOL:
            raise AssertionError(f"kernel 1 with a state disagrees with its plain version at [{rows}, {steps}]: {err}")

        def call():
            return nsnet2_cuda.gru_stack(net, gi1, state)

        ms = cuda_ms(call)
        queued = queued_ms(call)
        plain_ms = cuda_ms(lambda: nsnet2_cuda.gru_stack_reference(net, gi1, state), reps=3 if steps == 1 else 1)
        library_ms = cuda_ms(lambda: gru(x, h0))
    ops = 3 * 2 * rows * steps * 400 * 1200
    weights = (net.gru1.wh, net.gru1.bh, net.gru2.wi, net.gru2.bi, net.gru2.wh, net.gru2.bh)
    nbytes = gi1.nbytes + got.nbytes + 2 * sum(h.nbytes for h in state) + sum(w.nbytes for w in weights)
    bound_ms, bound_by = bound(nbytes, ops, F32_OPS_PER_MS)
    log(f"kernel 1 with a state {what} [{rows}, {steps}]: plan {plan.tiles} tiles of {plan.row_tile} rows x "
        f"{plan.unit_tile} units, grid {plan.grid} ({-(-plan.tiles // plan.grid)} a CTA at most); max |dh| {err:.3e} "
        f"(tolerance {LL_TOL}); single call {ms:.4f} ms, queued {queued:.4f} ms, plain {plain_ms:.3f} ms, cuDNN GRU "
        f"with h0 {library_ms:.4f} ms (its h2 {lib_err:.1e} from the kernel's); bound {bound_ms * 1e3:.2f} us by "
        f"{bound_by}")
    return {"rows": rows, "steps": steps, "grid": plan.grid, "tiles": plan.tiles, "row_tile": plan.row_tile,
            "max_abs_err": err, "ms": ms, "queued_ms": queued, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "library_max_abs_diff": lib_err}


def kernel_1_on_a_run(net, x) -> dict:
    """Kernel 1 as ``lowlatency.run`` launches it over all the hops of ``x``
    [B, 2, T] from a nonzero GRU state: the launch's gi1, state and outputs
    caught at the wrapper (the fc_in output by a forward hook), then
    ``kernel_1_with_a_state`` on them."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.pipeline import lowlatency

    b, dev = x.shape[0], x.device
    state = lowlatency.init_state((b, 2), dev)
    state["gru"] = tuple(h.reshape(b, 2, 400) for h in _nonzero_state(2 * b, 2 * b + 3, dev))
    caught, fc_in = [], []
    wrapper = nsnet2_cuda.gru_stack

    def catching(net_, gi1, state=None):
        out = wrapper(net_, gi1, state=state)
        caught.append((gi1, state, out))
        return out

    hook = net.fc_in.register_forward_hook(lambda module, args, out: fc_in.append(out))
    # The wrapper counts its launches on the module's name, here ``catching``.
    catching.launches = wrapper.launches
    nsnet2_cuda.gru_stack = catching
    try:
        with torch.inference_mode():
            lowlatency.run(net, x, state)
    finally:
        nsnet2_cuda.gru_stack = wrapper
        wrapper.launches = catching.launches
        hook.remove()
    if len(caught) != 1 or len(fc_in) != 1:
        raise AssertionError(f"a low-latency run from a nonzero state called kernel 1 {len(caught)} times")
    gi1, h0, launched = caught[0]
    return kernel_1_with_a_state(net, fc_in[0], gi1, h0, "on a low-latency run's", launched)


def state_gates_at(net, dev, rows: int, kind: int) -> dict:
    """Kernel 5 (the bf16 tier) or kernel 6 (bf16 out, the bf16_io tier) at a
    low-latency hop, [rows, 1], continuing a nonzero state, on the gi its
    tier hands it, against its plain version: max |dh2| <= BF16_MAX, the
    pre-flip bar, the whole-call mean bar for the output and the final
    float32 state; its times, plain time, bound and cuDNN's fp16 GRU from
    the same h0."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
    from formula_vad_tpu_torch.ops import precision
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms

    bf16 = torch.bfloat16
    feats, _ = _hop_features(net, dev, rows, rows + kind)
    precision.set_io_dtype("bf16" if kind == 6 else "f32")
    try:
        with torch.inference_mode():
            x = net.fc_in(precision.io_cast(feats))
            gi = gates.gi_gates(net, x)
    finally:
        precision.set_io_dtype("f32")
    if kind == 5:
        wrapper, plain, kw, what = gates.gru_gates_p, gates.gru_gates_p_reference, {}, "kernel 5 bf16"
    else:
        wrapper, plain, kw, what = gates.gru_gates_f, gates.gru_gates_f_reference, {"out_dtype": bf16}, \
            "kernel 6 bf16 (bf16 out)"
        gi = tuple(g.to(bf16) for g in gi)
    state = _nonzero_state(rows, rows + kind + 1, dev)
    gw = gates.gate_weights(net, bf16)
    plan = gates.device_p_plan(rows, dev)

    def call():
        return wrapper(net, *gi, dtype=bf16, state=state, **kw)

    with torch.inference_mode():
        before = wrapper.launches
        got, (h1, h2) = call()
        launched = wrapper.launches - before
        want, (w1, w2) = plain(gw, *gi, state=state, **kw)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        err, mean = float(d.max()), float(d.mean())
        flip = (got.to(bf16) != want.to(bf16)).any(dim=2)
        pre = ~flip  # one step: the rows whose output did not flip
        pre_mean = float(d[pre].mean()) if bool(pre.any()) else None
        state_err = max(float((a - b).abs().max()) for a, b in ((h1, w1), (h2, w2)))
        state_mean = max(float((a - b).abs().mean()) for a, b in ((h1, w1), (h2, w2)))
        if launched != len(plan):
            raise AssertionError(f"{what} with a state at {rows} rows counted {launched} launches, its plan has {len(plan)}")
        if pre_mean is None or not pre_mean <= PRE_FLIP_MEAN:
            raise AssertionError(f"{what} with a state misses the pre-flip bar at [{rows}, 1]: {pre_mean}")
        if not (err <= BF16_MAX and mean <= BF16_MEAN and state_err <= BF16_MAX and state_mean <= BF16_MEAN):
            raise AssertionError(f"{what} with a state disagrees with its plain version at [{rows}, 1]: max {err}, "
                                 f"mean {mean}, final state max {state_err}, mean {state_mean}")
        ms = cuda_ms(call)
        queued = queued_ms(call)
        plain_ms = cuda_ms(lambda: plain(gw, *gi, state=state, **kw), reps=3)
        gru = cudnn_gru(net, dev, torch.float16)
        xh, h0 = x.to(torch.float16), torch.stack(state).to(torch.float16).contiguous()
        library_ms = cuda_ms(lambda: gru(xh, h0))
    ops = 3 * 2 * rows * 400 * 1200
    nbytes = sum(g.nbytes for g in gi) + got.nbytes + 2 * sum(h.nbytes for h in state) + gw.w9.nbytes + gw.b8.nbytes
    bound_ms, bound_by = bound(nbytes, ops, BF16_OPS_PER_MS)
    log(f"{what} with a state at a hop's [{rows}, 1]: {launched} launch(es), grid {plan[0].grid}; max |dh2| {err:.3e}, "
        f"mean {mean:.3e}, over the {int(pre.sum())} rows without a flip {pre_mean:.3e}, final state max "
        f"{state_err:.3e}, mean {state_mean:.3e} (bars {BF16_MAX}, {BF16_MEAN}, {PRE_FLIP_MEAN}); single call "
        f"{ms:.4f} ms, queued {queued:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us by "
        f"{bound_by}, cuDNN GRU fp16 with h0 {library_ms:.4f} ms")
    return {"rows": rows, "steps": 1, "launches_a_call": launched, "grid": plan[0].grid, "max_abs_err": err,
            "mean_abs_err": mean, "pre_flip_mean_abs_err": pre_mean, "state_max_abs_err": state_err, "ms": ms,
            "queued_ms": queued, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def profiled_steps(net, state, x, steps: int = 50) -> dict:
    """``steps`` chained low-latency steps of ``x``'s hops from ``state``
    under torch.profiler -> the device's busy share of the wall, the device
    events a step and the top kernels (logged); where the trace holds no
    device event, only the wall."""
    import torch

    from formula_vad_tpu_torch.pipeline import lowlatency
    from formula_vad_tpu_torch.tools import busy_ms

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = lowlatency.step(net, state, x[..., i * LL_HOP : (i + 1) * LL_HOP])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # Every synchronising runtime call by name; the steps' own are besides the
    # one cudaDeviceSynchronize at the end.
    syncs = collections.Counter(e.name for e in prof.events() if "synchronize" in e.name.lower())
    if not events:
        log(f"  {steps} profiled steps: wall {wall:.1f} ms; the trace holds no device events")
        return {"steps": steps, "wall_ms": wall, "busy_ms": None}
    busy, kernels, copies = busy_ms(events)
    n_kernels = sum(1 for e in events if not e.name.lower().startswith(("memcpy", "memset")))
    n_copies = sum(1 for e in events if e.name.lower().startswith("memcpy"))
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  {steps} chained steps under torch.profiler: wall {wall:.1f} ms ({wall / steps:.3f} ms a step), device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}%; kernels {kernels:.1f} ms in {n_kernels} launches, "
        f"{n_kernels / steps:.0f} a step; copies {copies:.2f} ms in {n_copies}), synchronising calls "
        f"{dict(syncs)}; device time by kernel (ms): " + "; ".join(f"{n[:50]} {t:.2f}" for n, t in top))
    return {"steps": steps, "wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
            "kernels_a_step": n_kernels / steps, "copies": n_copies, "syncs": dict(syncs)}


def phase_lowlatency(net, dev, audio, smi: str) -> dict:
    """Phase 14, the low-latency mode (``pipeline/lowlatency.py``): the
    slice's 21 streams x 2 channels in one ``run`` (2,000 hops) and in
    LL_STEPS chained ``step`` calls, the chain against the run (LL_TOL), the
    profiled steps, kernel 1 on a run from a nonzero state, the impulse
    check, the scale curve (``tools/lowlatency_scale.py``), each tier's step
    and kernels 1, 3, 5 and 6 at a hop's shapes with a state;
    -> {"launches": each kernel's launches in the run, the chain and the
    tiers' steps, "shapes", and the measures}."""
    import torch

    from formula_vad_tpu_torch.ops import precision
    from formula_vad_tpu_torch.pipeline import lowlatency
    from formula_vad_tpu_torch.tools import lowlatency_scale

    t_phase = time.perf_counter()
    counters = path_counters()
    b = audio.shape[0]
    x = torch.from_numpy(audio).to(dev)
    n_hops = audio.shape[-1] // LL_HOP
    audio_sec = b * n_hops * LL_HOP / 48000
    with torch.inference_mode():
        lowlatency.run(net, x[..., : 10 * LL_HOP])  # warm-up: weights packed, bases cached
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        final, out = lowlatency.run(net, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = check_launches("the low-latency run", counters, gru_stack=1)
        if tuple(out.shape) != (b, 2, n_hops * LL_HOP) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"the low-latency run gave {tuple(out.shape)} or non-finite values")
        log(f"low-latency run, {b} streams x 2 channels x {n_hops} hops ({audio_sec:.0f} s of audio) in one call: wall "
            f"{wall * 1e3:.1f} ms, real-time factor {audio_sec / wall:.1f}, launches {run_launches}; on {smi}")
    run_shape = kernel_1_on_a_run(net, x)
    with torch.inference_mode():
        reset_counts(counters)
        state = lowlatency.init_state((b, 2), dev)
        outs, event_ms, host_ms = [], [], []
        for i in range(LL_STEPS):
            hop = x[..., i * LL_HOP : (i + 1) * LL_HOP]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, o = lowlatency.step(net, state, hop)
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(start.elapsed_time(end))
            outs.append(o)
        step_launches = check_launches("the chained low-latency steps", counters, gru_stack=LL_STEPS)
        chain = torch.cat(outs, -1)
        part_state, _ = lowlatency.run(net, x[..., : LL_STEPS * LL_HOP])
        chain_err = float((chain - out[..., : LL_STEPS * LL_HOP]).abs().max())
        state_err = max(float((state[k] - part_state[k]).abs().max()) for k in ("in_tail", "out_tail", "last_sample"))
        state_err = max([state_err] + [float((a - c).abs().max()) for a, c in zip(state["gru"], part_state["gru"])])
        if not (chain_err <= LL_TOL and state_err <= LL_TOL):
            raise AssertionError(f"the step chain disagrees with the run: outputs {chain_err}, state {state_err}")
        pct = lambda v, q: float(np.percentile(v, q))  # noqa: E731
        log(f"low-latency step at {b} streams x 2 channels, {LL_STEPS} chained: CUDA events p50 {pct(event_ms, 50):.3f} "
            f"ms, p95 {pct(event_ms, 95):.3f} ms; host clock to completion p50 {pct(host_ms, 50):.3f} ms, p95 "
            f"{pct(host_ms, 95):.3f} ms (budget 10 ms a hop); launches {step_launches}; the chain against the run: "
            f"outputs {chain_err:.2e}, final state {state_err:.2e} (tolerance {LL_TOL})")

        step_profile = profiled_steps(net, state, x)

        impulse = torch.zeros((1, 2, 10 * LL_HOP), device=dev)
        impulse[..., 5 * LL_HOP + 99] = 1.0  # on the decimation grid
        energy = lowlatency.run(net, impulse)[1].abs().reshape(2, 10, LL_HOP).sum(dim=(0, 2)).cpu().numpy()
        if (energy[:5] > 1e-6).any() or (energy[8:] > 1e-6).any() or not (energy[5:7] > 1e-6).any():
            raise AssertionError(f"an impulse in hop 5 reaches output hops {np.nonzero(energy > 1e-6)[0].tolist()}")
        log(f"impulse in input hop 5 reaches output hops {np.nonzero(energy > 1e-6)[0].tolist()} (energy "
            f"{np.round(energy[4:9], 4).tolist()} at hops 4-8): one hop of latency and the OLA tail")

    scale = []
    log(f"{'B':>6} {'ms/hop':>8} {'<10ms':>6} {'ceiling':>8}   (tools/lowlatency_scale.py, float tier, demo weights)")
    for streams in LL_SCALE:
        r = lowlatency_scale.measure(net, streams)
        scale.append(r)
        log(f"{r['b']:>6} {r['ms_per_hop']:>8.3f} {str(r['fits_10ms']):>6} {r['streams_ceiling']:>8}")

    tiers, tier_launches = {}, dict.fromkeys(counters, 0)
    hop = x[..., :LL_HOP]
    for tier, level, io, quant, recurrence, per_step in LL_TIERS:
        precision.set_matmul_precision(level)
        precision.set_io_dtype(io)
        precision.set_quant(quant)
        try:
            with torch.inference_mode():
                st0 = lowlatency.init_state((b, 2), dev)
                lowlatency.step(net, st0, hop)  # warm-up
                torch.cuda.synchronize()
                reset_counts(counters)
                st1, o = lowlatency.step(net, st0, hop)
                torch.cuda.synchronize()
                got = check_launches(f"the {tier} tier's low-latency step", counters, **{recurrence: per_step})
                times = []
                for _ in range(20):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    st1, o = lowlatency.step(net, st1, hop)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
        finally:
            precision.set_matmul_precision("highest")
            precision.set_io_dtype("f32")
            precision.set_quant("off")
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"the {tier} tier's low-latency step gave non-finite values")
        for name in tier_launches:
            tier_launches[name] += got[name]
        tiers[tier] = {"step_event_ms_p50": statistics.median(times), "launches": got}
        log(f"  {tier} tier: a step launches {got} and nothing else; {statistics.median(times):.3f} ms a step (CUDA "
            f"events, median of 20, {b} streams)")

    shapes = {"gru_stack": [state_kernel_1_at(net, dev, rows) for rows in LL_ROWS] + [run_shape],
              "gru_gates_p": [state_gates_at(net, dev, LL_ROWS[0], 5)],
              "gru_gates_f": [state_gates_at(net, dev, LL_ROWS[0], 6)],
              "matmul_q8": [q8_at(dev, LL_ROWS[0], steps=1, head_frames=1)]}
    launches = {name: run_launches[name] + step_launches[name] + tier_launches[name] for name in counters}
    log(f"phase 14 (low latency) took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "shapes": shapes, "run_wall_ms": wall * 1e3, "run_rtf": audio_sec / wall,
            "step_event_ms": {"p50": pct(event_ms, 50), "p95": pct(event_ms, 95)},
            "step_host_ms": {"p50": pct(host_ms, 50), "p95": pct(host_ms, 95)}, "chain_max_abs_err": chain_err,
            "step_profile": step_profile, "scale": scale, "tiers": tiers}


def phase_sweep(net, dev, audio, float_results, float_wall: float, corpus: str, smi: str) -> dict:
    """Phase 14, the sweep: the slice with K = 8 alternative machines (a 4 x
    2 grid of speech_threshold_factor x channel_vol_ratio_threshold, the
    base config among them) behind one front end; kernel 2's launches and
    shape; the base machine's alternative segments and the primary's
    against phase 4's; every machine's outputs bit for bit with the host
    decoder; the wall against the plain slice; kernel 2 at the sweep's rows;
    ``apps.tune`` on phase 5's corpus, cuda against cpu. -> {"launches",
    "shape", and the measures}."""
    import contextlib
    import io

    import torch

    from formula_vad_tpu_torch.apps import tune
    from formula_vad_tpu_torch.config import VADConfig, VADMachineConfig
    from formula_vad_tpu_torch.parallel.runner import BatchRunner
    from formula_vad_tpu_torch.pipeline import fsm, fsm_cuda, fsm_host, offline
    from formula_vad_tpu_torch.tools import cuda_ms

    t_phase = time.perf_counter()
    counters = path_counters()
    grid = [VADMachineConfig(speech_threshold_factor=f, channel_vol_ratio_threshold=r)
            for f in SWEEP_FACTORS for r in SWEEP_RATIOS]
    runner = BatchRunner(net, VADConfig(alt_vad_machine_configs=grid))
    st, machines, k = runner.st, runner.machines, len(grid)
    results, walls, launches = timed_runs(runner, audio, counters)
    plan = fsm_cuda.scan_windows.last_plan
    if launches != dict(dict.fromkeys(counters, 0), gru_stack=3, scan_windows=3) or plan.ctas != len(audio) * (k + 1):
        raise AssertionError(f"the sweep launched {launches} over 3 runs, the FSM at {plan.ctas} rows")
    primary = [r.segments for r in results]
    if primary != [r.segments for r in float_results] or any(r.alt_segments[SWEEP_BASE] != r.segments for r in results):
        raise AssertionError("the sweep's primary or base-config machine differs from phase 4's segments")
    wall = statistics.median(walls)
    counts = [sum(len(r.alt_segments[m]) for r in results) for m in range(k)]
    log(f"sweep: the slice with {k} alternative machines ({len(SWEEP_FACTORS)} x {len(SWEEP_RATIOS)} grid of "
        f"speech_threshold_factor x channel_vol_ratio_threshold): wall {wall * 1e3:.1f} ms (median of 3 after a "
        f"warm-up) against the plain slice's {float_wall * 1e3:.1f} ms (phase 4), x{wall / float_wall:.3f}; launches "
        f"over the 3 runs {launches}; kernel 2 at [{plan.ctas}, {audio.shape[-1] // st.fft_size}] ({len(audio)} streams x {k + 1} "
        f"machines, stream-major); segments a machine {counts}; the base machine's and the primary's equal phase "
        f"4's; on {smi}")

    # Every machine's seven outputs against the host decoder, bit for bit.
    x = torch.from_numpy(audio).to(dev)
    with torch.inference_mode():
        win_out, _ = offline.process_batch_offline(net, st, x, fsm_params=machines)
        mv, rt, va = offline.window_inputs_batch(net, st, x)
    b, w = mv.shape
    rows = [fsm.repeat_rows(t, k + 1) for t in (mv, rt, va)]
    host, _ = fsm_host.scan_windows_host(st.fsm_shape, fsm.tile_rows(machines, b), *(t.cpu().numpy() for t in rows))
    for field, got, want in zip(host._fields, win_out, host):
        if got.cpu().numpy().reshape(b * (k + 1), w).tobytes() != np.ascontiguousarray(want).tobytes():
            raise AssertionError(f"the sweep's FSM != the host decoder: {field}")
    log(f"sweep: all {b * (k + 1)} (stream, config) rows' 7 outputs == the host decoder, bit for bit")
    params = fsm.tile_rows(machines, b)
    with torch.inference_mode():
        out, carry = fsm_cuda.scan_windows(st.fsm_shape, params, *rows)
        err = max(float(np.abs(got.cpu().numpy().reshape(want.shape).astype(np.float64) - want).max())
                  for got, want in zip(out, host))
        if err != 0.0:
            raise AssertionError(f"kernel 2 at the sweep's rows differs from the host decoder by {err}")
        ms = cuda_ms(lambda: fsm_cuda.scan_windows(st.fsm_shape, params, *rows))
        plain_ms = cuda_ms(lambda: fsm_cuda.scan_windows_reference(st.fsm_shape, params, *rows), reps=1)
    nbytes = sum(t.nbytes for t in rows) + sum(t.nbytes for t in out) + sum(t.nbytes for t in carry.values())
    bound_ms, bound_by = bound(nbytes, 0, F32_OPS_PER_MS)
    log(f"FSM kernel at the sweep's [{b * (k + 1)}, {w}]: max |d| {err} against the host decoder; {ms:.4f} ms a fresh "
        f"call, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us by {bound_by}")
    shape = {"rows": b * (k + 1), "windows": w, "ctas": plan.ctas, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

    boards = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            tune.main(["-i", os.path.join(corpus, "plan_cuda.json"), "--grid", TUNE_GRID, "--device", device])
        boards[device] = text.getvalue()
    if boards["cuda"] != boards["cpu"] or "base" not in boards["cuda"]:
        raise AssertionError(f"the tuner's leaderboard differs between cuda and cpu:\n{boards['cuda']}\n{boards['cpu']}")
    log(f"apps.tune --grid {TUNE_GRID} on phase 5's corpus: the same leaderboard on cuda and cpu "
        f"({time.perf_counter() - t0:.1f} s both):\n{boards['cuda'].rstrip()}")
    log(f"phase 14 (sweep) took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "shape": shape, "wall_ms": wall * 1e3, "plain_wall_ms": float_wall * 1e3,
            "segments_a_machine": counts}


def registry_onnx(net, dev, audio, float_results, corpus: str, batched_dir: str, counters, root: str) -> dict:
    """Phase 15 (a): the demo weights through the port's ONNX writer and
    importer on the card: bit for bit the ``.npz`` model's weights; the
    slice through BatchRunner (one gru_stack and one scan_windows a run,
    segments identical to phase 4's); the simulator on phase 5's corpus
    with a plan naming the file, its files identical to phase 5's cuda
    run's. -> {"net", "launches", "wall_s"}."""
    from formula_vad_tpu_torch.models.onnx_import import export_nsnet2_onnx
    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.parallel.runner import BatchRunner

    path = os.path.join(root, "demo.onnx")
    with open(path, "wb") as f:
        f.write(export_nsnet2_onnx(net))
    imported = load_denoiser(path, device=dev)
    for (name, a), (_, b) in zip(net.named_parameters(), imported.named_parameters()):
        if a.device != b.device or not bool((a == b).all()):
            raise AssertionError(f"the imported {name} differs from the .npz model's")
    log(f"ONNX: the demo weights written ({os.path.getsize(path) / 1e6:.2f} MB) and imported on the card, every "
        "parameter bit for bit with the .npz model's")
    results, walls, launches = timed_runs(BatchRunner(imported), audio, counters)
    check_launches("the imported model's slice", counters, gru_stack=3, scan_windows=3)
    if [r.segments for r in results] != [r.segments for r in float_results]:
        raise AssertionError("the imported model's slice segments differ from phase 4's")
    wall = statistics.median(walls)
    log(f"ONNX slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s: {sum(len(r.segments) for r in results)} segments "
        f"identical to phase 4's; wall {wall * 1e3:.1f} ms (runs {[round(w * 1e3, 1) for w in walls]}); launches "
        f"over 3 runs {launches}")
    with open(os.path.join(corpus, "plan_cuda.json")) as f:
        plan = json.load(f)
    plan["config"] = {"output_dir": "out_onnx_cuda", "vad_config": {"denoiser_model_path": path}}
    with open(os.path.join(corpus, "plan_onnx_cuda.json"), "w") as f:
        json.dump(plan, f)
    out = run_simulators(corpus, {"onnx_cuda": ("cuda", {})})["onnx_cuda"]
    for name in ["report.txt"] + [f"s{i}-audacity.txt" for i in range(CORPUS_STREAMS)]:
        if read_text(out, name) != read_text(batched_dir, name):
            raise AssertionError(f"{name} of the simulator plan naming the .onnx file differs from phase 5's cuda run")
    log("simulator plan naming the .onnx file (--device cuda): report.txt and segment files identical to phase 5's")
    return {"net": imported, "launches": launches, "wall_s": wall}


def offline_stages(runner, audio, rounds: int = 3) -> dict:
    """BatchRunner.run's offline stages on the device FSM, as ``run`` calls
    them, timed apart on the host clock with a synchronisation after each:
    the pageable upload of the batch, the device work (the model's gains
    and kernel 2), the fetch of the window outputs, the segment assembly.
    -> each stage's median ms over ``rounds``."""
    import torch

    from formula_vad_tpu_torch.parallel.runner import results
    from formula_vad_tpu_torch.pipeline import offline

    st = runner.st
    n_valid = np.full(audio.shape[0], audio.shape[-1] // st.chunk_size, np.int32)
    times = collections.defaultdict(list)

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(rounds):
        with torch.inference_mode():
            x = stage("upload", lambda: torch.from_numpy(audio).to(runner.device))
            valid = torch.from_numpy(n_valid).to(runner.device)
            win = stage("device", lambda: offline.process_batch_offline(runner.net, st, x, valid, st.fsm_params)[0])
            win = stage("fetch", lambda: type(win)(*(t.cpu().numpy() for t in win)))
            stage("assembly", lambda: results(st, win, 0))
    return {name: statistics.median(v) for name, v in times.items()}


def registry_gate(dev, audio, float_wall: float, counters, smi: str) -> dict:
    """Phase 15 (b): the spectral gate on the card. The slice offline (one
    scan_windows a run, no GRU or int8 launch; RTF beside phase 4's; one
    torch.profiler split) and streaming (40 scan_windows a run), their
    segments equal to each other and to the CPU gate run's (host decoder);
    OnlineBatchServer for GATE_TICKS ticks at 21 streams, decisions bit for
    bit with the CPU fleet's. -> {"net", "launches", "launches_stream",
    "launches_serve", "wall_s", "rtf", "busy_ms", ...}."""
    import torch

    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.parallel.runner import BatchRunner

    gate, gate_cpu = load_denoiser("spectral_gate", device=dev), load_denoiser("spectral_gate", device="cpu")
    audio_sec = SLICE_STREAMS * SLICE_SECONDS
    results, walls, launches = timed_runs(BatchRunner(gate), audio, counters)
    check_launches("the gate's slice", counters, scan_windows=3)
    wall = statistics.median(walls)
    segments = [r.segments for r in results]
    t0 = time.perf_counter()
    cpu = [r.segments for r in BatchRunner(gate_cpu, use_host_fsm=True).run(audio)]
    cpu_s = time.perf_counter() - t0
    if segments != cpu:
        raise AssertionError("the gate's slice segments differ between the card and the CPU")
    if not sum(map(len, segments)):
        raise AssertionError("the gate found no segment in the slice")
    log(f"gate slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s: wall {wall * 1e3:.1f} ms (median of 3, runs "
        f"{[round(w * 1e3, 1) for w in walls]}), real-time factor {audio_sec / wall:.1f}, against the float tier's "
        f"{float_wall * 1e3:.1f} ms, {audio_sec / float_wall:.1f} (phase 4), on {smi}; {sum(map(len, segments))} "
        f"segments identical to the CPU run's ({cpu_s:.1f} s on the host); launches over 3 runs {launches}")
    runner = BatchRunner(gate)
    busy, prof_wall = profiled_busy(runner, audio, steps=None)
    split = offline_stages(runner, audio)
    log(f"gate slice's stages on the host clock (median of 3, ms): "
        + ", ".join(f"{name} {ms:.2f}" for name, ms in split.items())
        + f"; sum {sum(split.values()):.2f} against the run's {wall * 1e3:.1f} ms wall ({audio.nbytes / 1e6:.1f} MB uploaded)")
    stream = BatchRunner(gate, use_offline=False)
    stream.run(audio)  # warm-up
    reset_counts(counters)
    t0 = time.perf_counter()
    stream_segments = [r.segments for r in stream.run(audio)]
    torch.cuda.synchronize()
    stream_wall = time.perf_counter() - t0
    launches_stream = check_launches("the gate's streaming slice", counters, scan_windows=STREAM_CHUNKS)
    if stream_segments != segments:
        raise AssertionError("the gate's streaming segments differ from its offline segments")
    log(f"gate streaming slice: {stream_wall * 1e3:.1f} ms, real-time factor {audio_sec / stream_wall:.1f}, segments "
        f"identical to offline; launches {launches_stream}")
    b = audio.shape[0]
    chunks = np.ascontiguousarray(audio[..., : GATE_TICKS * 24000].reshape(b, 2, GATE_TICKS, 24000).transpose(2, 0, 1, 3))
    serve_run(gate, chunks[:2], record=False)  # warm-up
    reset_counts(counters)
    fleet = serve_run(gate, chunks)
    launches_serve = check_launches("the gate's fleet", counters, scan_windows=GATE_TICKS)
    err = same_serving("the gate's fleet, card against CPU", fleet, serve_run(gate_cpu, chunks, use_host_fsm=True),
                       exact=False)
    log(f"gate fleet {b} streams x {GATE_TICKS} ticks: segments, recordings' starts, decisions and indices bit for "
        f"bit with the CPU fleet (host decoder), float outputs within {err:.3e}; launches {launches_serve}")
    return {"net": gate, "launches": launches, "launches_stream": launches_stream, "launches_serve": launches_serve,
            "wall_s": wall, "rtf": audio_sec / wall, "busy_ms": busy, "profiled_wall_ms": prof_wall,
            "stages_ms": split, "stream_wall_s": stream_wall, "fleet": serve_stats("gate fleet", fleet, smi), "fleet_max_abs_err": err}


def registry_quality(dev, models: dict, counters) -> dict:
    """Phase 15 (c): eval/denoise_quality.evaluate of each model on the
    card against the same model on the CPU (QUALITY_TOL_DB a number), the
    JAX package's floors; the imported model's numbers equal the demo's.
    -> {model: the card's result}."""
    from formula_vad_tpu_torch.eval import denoise_quality as dq
    from formula_vad_tpu_torch.models.registry import load_denoiser

    kw = dict(n_pairs=QUALITY_PAIRS, seconds=QUALITY_SECONDS)
    out, cpu_of = {}, {}
    for name, (net, spec) in models.items():
        reset_counts(counters)
        t0 = time.perf_counter()
        card = dq.evaluate(net, device=dev, **kw)
        card_s = time.perf_counter() - t0
        launched = launches_of(counters)
        if spec not in cpu_of:
            cpu_of[spec] = dq.evaluate(load_denoiser(spec, device="cpu"), device="cpu", **kw)
        cpu = cpu_of[spec]
        for g, w in zip(card["pairs"] + [card], cpu["pairs"] + [cpu]):
            for key, v in g.items():
                if key.endswith("_db") and not abs(v - w[key]) <= QUALITY_TOL_DB:
                    raise AssertionError(f"SI-SDR of {name} on the card differs from the CPU's: {key} {v} against {w[key]}")
        mean = card["mean_si_sdr_impr_db"]
        floor_ok = (mean >= GATE_FLOOR_DB) if spec == "spectral_gate" else (
            mean >= DEMO_FLOOR_DB and all(r["si_sdr_impr_db"] >= DEMO_PAIR_FLOOR_DB for r in card["pairs"]))
        if not floor_ok:
            raise AssertionError(f"SI-SDR of {name} misses the JAX package's floor: {card}")
        log(f"SI-SDR improvement of {name} ({QUALITY_PAIRS} held-out pairs x {QUALITY_SECONDS:.0f} s): card "
            f"{[r['si_sdr_impr_db'] for r in card['pairs']]} dB (mean {mean}), CPU "
            f"{[r['si_sdr_impr_db'] for r in cpu['pairs']]} (mean {cpu['mean_si_sdr_impr_db']}); {card_s:.1f} s on "
            f"the card; launches {launched}")
        out[name] = card
    if out["onnx"] != out["demo"]:
        raise AssertionError("the imported model's SI-SDR differs from the demo weights'")
    if not out["demo"]["mean_si_sdr_impr_db"] > out["spectral_gate"]["mean_si_sdr_impr_db"]:
        raise AssertionError("the demo weights do not beat the gate on SI-SDR")
    return out


def phase_registry(net, dev, audio, float_results, float_wall: float, corpus: str, batched_dir: str, smi: str) -> dict:
    """Phase 15: the rest of the denoiser registry. -> {"onnx", "gate",
    "gate_stream", "gate_serve", "quality": each kernel's launches on the
    path, and the measures}."""
    t_phase = time.perf_counter()
    counters = path_counters()
    with tempfile.TemporaryDirectory() as root:
        onnx = registry_onnx(net, dev, audio, float_results, corpus, batched_dir, counters, root)
        gate = registry_gate(dev, audio, float_wall, counters, smi)
        quality = registry_quality(dev, {"demo": (net, "demo"), "onnx": (onnx["net"], "demo"),
                                         "spectral_gate": (gate["net"], "spectral_gate")}, counters)
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"onnx": onnx["launches"], "gate": gate["launches"], "gate_stream": gate["launches_stream"],
                         "gate_serve": gate["launches_serve"]},
            "gate": {k: v for k, v in gate.items() if k != "net" and not k.startswith("launches")},
            "quality": quality}


def train_grads(dev, counters) -> dict:
    """Phase 16 (a): one batch of the CLI's default shape through the
    trainer's differentiable forward and backward on the CPU and on the
    card, the same random weights; no kernel may launch. Then the scoring
    forward with gradients on must raise. -> the errors and times."""
    import torch

    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.train import nsnet2_train

    batch = nsnet2_train.synth_batch(torch.Generator().manual_seed(16), TRAIN_BATCHES[0], TRAIN_FRAMES)
    got = {}
    for where in ("cpu", dev):
        net = nsnet2_train.trainable(load_denoiser("random", device=where))
        reset_counts(counters)
        t0 = time.perf_counter()
        loss = nsnet2_train.spectral_loss(net, *(x.to(where) for x in batch))
        loss.backward()
        grads = [p.grad.cpu() for p in net.parameters()]
        secs = time.perf_counter() - t0
        check_launches(f"the trainer's forward and backward on {where}", counters)
        got[str(where)] = (loss.item(), grads, secs)
    (cpu_loss, cpu, cpu_s), (card_loss, card, card_s) = got["cpu"], got[str(dev)]
    scales = [float(w.abs().max()) for w in cpu]
    errs = [float((g - w).abs().max()) / sc for g, w, sc in zip(card, cpu, scales)]
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if min(scales) <= 0 or min(float(g.abs().max()) for g in card) <= 0:
        raise AssertionError(f"a gradient is zero: largest |g| a parameter {scales}")
    if loss_err > 1e-5 or max(errs) > TRAIN_GRAD_TOL:
        raise AssertionError(f"the card's loss or gradients differ from the CPU's: loss {loss_err:.3e}, grads {errs}")
    log(f"trainer gradients at [{TRAIN_BATCHES[0]}, {TRAIN_FRAMES}, 161], card against CPU (TF32 off): loss "
        f"{card_loss:.7f} against {cpu_loss:.7f} (rel {loss_err:.2e}); largest |dg| over each array's largest |g| "
        f"{max(errs):.2e} (bar {TRAIN_GRAD_TOL:.0e}; all 16 nonzero); forward + backward {card_s * 1e3:.1f} ms on "
        f"the card (first call), {cpu_s * 1e3:.1f} ms on the CPU; no kernel launched")
    scoring = nsnet2_train.trainable(load_denoiser("random", device=dev))
    try:
        scoring(batch[0].to(dev))
    except RuntimeError as e:
        if "nsnet2_train.apply" not in str(e):
            raise
        log(f"the scoring forward with gradients on refuses: {str(e)[:120]}...")
    else:
        raise AssertionError("the scoring forward ran kernel 1 with gradients on")
    check_launches("the refused scoring forward", counters)
    return {"loss_rel_err": loss_err, "grad_max_rel_err": max(errs), "card_ms": card_s * 1e3, "cpu_ms": cpu_s * 1e3}


def train_run(argv: list[str], counters) -> tuple[dict, dict, float, list[str]]:
    """One apps.train.main run (on the card, its default) with the launch
    counters and the peak memory reset before it -> (its last_run, the
    launches, the peak device memory in MB, the JSON lines it printed)."""
    import io

    import torch

    from formula_vad_tpu_torch.apps import train as train_app

    reset_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if train_app.main(argv) != 0:
            raise AssertionError(f"apps.train {argv} failed")
    peak = torch.cuda.max_memory_allocated() / 1e6
    return train_app.main.last_run, launches_of(counters), peak, [ln for ln in out.getvalue().splitlines() if ln]


def train_profiled(argv: list[str], counters) -> tuple[dict, dict]:
    """An apps.train.main run under torch.profiler, the launch counters
    reset before it -> (over its "train_steps" range, the device's busy
    share and the kernels a step; the launches)."""
    import torch

    from formula_vad_tpu_torch.apps import train as train_app
    from formula_vad_tpu_torch.tools import busy_ms

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    reset_counts(counters)
    with torch.profiler.profile(activities=activities) as prof:
        train_app.main(argv)
    launches = launches_of(counters)
    steps = train_app.main.last_run["steps"]
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    (loop,) = [e for e in prof.events() if e.name == "train_steps" and e.device_type == cpu]
    a, b = loop.time_range.start, loop.time_range.end
    events = [e for e in prof.events() if e.device_type == cuda and e.name != "train_steps"
              and a <= e.time_range.start <= b]
    window = (b - a) / 1e3
    if not events:
        log(f"  {steps} profiled steps: {window:.1f} ms; the trace holds no device events")
        return {"steps": steps, "window_ms": window, "busy_ms": None}, launches
    busy, kernels, copies = busy_ms(events)
    n_kernels = sum(1 for e in events if not e.name.lower().startswith(("memcpy", "memset")))
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    log(f"  {steps} steps under torch.profiler: {window:.1f} ms ({window / steps:.2f} ms a step), device busy "
        f"{busy:.1f} ms ({100 * busy / window:.1f}%), {n_kernels} kernels ({n_kernels / steps:.0f} a step, "
        f"{kernels:.1f} ms), copies {copies:.2f} ms; device time by kernel (ms): "
        + "; ".join(f"{n[:50]} {t:.2f}" for n, t in by_name.most_common(5)))
    top_host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:6]
    log("  host self time by op over the run (ms, calls): "
        + "; ".join(f"{a.key[:40]} {a.self_cpu_time_total / 1e3:.1f} ({a.count})" for a in top_host))
    return {"steps": steps, "window_ms": window, "busy_ms": busy, "busy_share": busy / window,
            "kernels_a_step": n_kernels / steps}, launches


def near_plain(what: str, got, want, levels, tol: float) -> float:
    """Kernel A or B against its plain version: max |d| <= ``tol``; where a
    class is 'default', h is rounded to bf16 where it enters its products
    and another float32 summation order now and then moves it across a bf16
    rounding step, so phase 8's bf16 bars hold there. -> max |d|."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    d = (got.float() - want.float()).abs()
    e, m = float(d.max()), float(d.mean())
    ok = e <= BF16_MAX and m <= BF16_MEAN if "default" in levels else e <= tol
    bar = f"max <= {BF16_MAX}, mean <= {BF16_MEAN}" if "default" in levels else f"max <= {tol}"
    log(f"  {what}: max |d| {e:.3e}, mean {m:.3e} ({bar})")
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version: max {e}, mean {m}")
    return e


def nearer_own_levels(what: str, got, want, levels, plain_at) -> dict:
    """The control beside ``near_plain``: the kernel's output lies nearer
    (mean |d|) its plain version at its own levels than the plain versions
    at all-'highest' and at the two classes swapped (``plain_at(levels)``),
    so a kernel that ignored its levels (kernel 1's code) or swapped the
    classes fails where both lie within the bar. -> {other levels: mean |d|
    to them over the mean |d| to its own}."""
    own = float((got - want).abs().mean())
    ratios = {}
    for other in sorted({("highest", "highest"), levels[::-1]} - {levels}):
        far = float((got - plain_at(other)).abs().mean())
        ratios[other] = far / own if own else float("inf")
        if not own < far:
            raise AssertionError(f"{what}: as near the plain version at {other} ({far:.3e}) as at its own ({own:.3e})")
    log(f"  {what}: mean |d| to its own plain {own:.3e}; to the plain at other levels "
        + ", ".join(f"{o} {r:.1f}x" for o, r in ratios.items()))
    return ratios


def kernel_a_rows(net, dev, smi: str) -> dict:
    """Phase 17 (a): kernel A (``gru_gates_3x``) at each pair of levels
    against its plain version at P17_SHAPES (N(0, 0.3) GRU biases), and
    nearer it than the plain versions at other levels, and at [42, 1]
    continuing a nonzero state; all-high also on N(0, 0.8) gi. Then
    each instantiation's plan, cluster size, single and queued time at
    [1,680, 54] on the demo weights beside kernel 1's float32 time and
    cuDNN's float32 GRU (TF32 off, another function: the nearest library
    call) in the same process, and its bound; and its single and queued
    times and bounds at [42, 54] (a chunk step), [42, 1] from a state (a
    low-latency step) and [4,000, 54]. The plan's count of the exchange's
    L2 bytes (``plan_exchange_bytes_3x``, not a measurement) is logged
    only. -> the kernels line's entry."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms

    bnet = biased_net(dev)
    f32 = torch.float32

    def gi_of(n, t, seed, weights):
        feats = np.random.default_rng(seed).normal(-3.0, 1.5, (n, t, 161)).astype(np.float32)
        with torch.inference_mode():
            return gates.gi_gates(weights, weights.fc_in(torch.from_numpy(feats).to(dev)))

    errs, ratios = {}, []
    for levels in A_LEVELS:
        err = 0.0
        for n, t in P17_SHAPES:
            gi = gi_of(n, t, n, bnet)
            before = gates.gru_gates_3x.launches
            with torch.inference_mode():
                got = gates.gru_gates_3x(bnet, *gi, levels)
                want = gates.gru_gates_p_reference(gates.gate_weights(bnet, f32), *gi, levels=levels)
            torch.cuda.synchronize()
            plan = gates.device_p_plan(n, dev, gates.P3_UNITS)
            if gates.gru_gates_3x.launches - before != len(plan):
                raise AssertionError(f"kernel A at {n} rows counted {gates.gru_gates_3x.launches - before} launches")
            what = f"kernel A {levels} vs plain at [{n}, {t}]"
            err = max(err, near_plain(f"{what} ({len(plan)} launch(es))", got, want, levels, A_HIGH_TOL))
            with torch.inference_mode():
                ratios += nearer_own_levels(what, got, want, levels, lambda other: gates.gru_gates_p_reference(
                    gates.gate_weights(bnet, f32), *gi, levels=other)).values()
        rows = LL_ROWS[0]
        gi = gi_of(rows, 1, 5, bnet)
        rng = np.random.default_rng(6)
        state = tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (rows, 400))).astype(np.float32)).to(dev)
                      for _ in range(2))
        with torch.inference_mode():
            got, (h1, h2) = gates.gru_gates_3x(bnet, *gi, levels, state=state)
            want, (w1, w2) = gates.gru_gates_p_reference(gates.gate_weights(bnet, f32), *gi, state=state, levels=levels)
        for label, a, b in (("h2", got, want), ("final h1", h1, w1), ("final h2", h2, w2)):
            err = max(err, near_plain(f"kernel A {levels} from a state at [{rows}, 1], {label}", a, b, levels,
                                      A_HIGH_TOL))
        errs[levels] = err
    rng = np.random.default_rng(100)
    gi = tuple(torch.from_numpy((rng.standard_normal((8, GRU_STEPS, 400)) * 0.8).astype(np.float32)).to(dev)
               for _ in range(3))
    with torch.inference_mode():
        got = gates.gru_gates_3x(net, *gi, ("high", "high"))
        want = gates.gru_gates_p_reference(gates.gate_weights(net, f32), *gi, levels=("high", "high"))
    errs[A_LEVELS[0]] = max(errs[A_LEVELS[0]], near_plain("kernel A all-high on N(0, 0.8) gi [8, 54] (no rounding "
                                                         "cascade)", got, want, ("high", "high"), A_HIGH_TOL))

    # Times at the scoring shape on the demo weights, kernel 1 and cuDNN beside.
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(-3.0, 1.5, (GRU_ROWS, GRU_STEPS, 161)).astype(np.float32)).to(dev)
    gru = cudnn_gru(net, dev)

    def a_bound(n, t, passes, carried):
        """Bytes: gi in, out, a state's two rows in and the final h1 out, the
        weights once; operations: each step's products at their passes,
        none with h = 0 (step 0 of a stateless call)."""
        ops = 2 * n * 400 * 1200 * (t * passes[0] + 2 * (t if carried else t - 1) * passes[1])
        nbytes = 4 * n * t * 400 * 4 + (3 * n * 400 * 4 if carried else 0) + gates.units_3x(net).nbytes
        return bound(nbytes, ops, BF16_OPS_PER_MS)

    def a_plan(n):
        (launch,) = gates.device_p_plan(n, dev, gates.P3_UNITS)
        return (f"{launch.row_groups} row group(s) of up to {launch.tiles_per_group} tiles x 50 unit groups of 8 "
                f"units = {launch.grid} CTAs in clusters of {gates.P3_CLUSTER} "
                f"({'pairs' if launch.tiles_per_group > gates.P3_WARPS else 'single tiles'} a warp), "
                f"{launch.smem_bytes('A')} bytes of shared memory a CTA")

    with torch.inference_mode():
        x = net.fc_in(feats)
        gi = gates.gi_gates(net, x)
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
        k1 = {"ms": cuda_ms(lambda: nsnet2_cuda.gru_stack(net, gi1)),
              "queued_ms": queued_ms(lambda: nsnet2_cuda.gru_stack(net, gi1))}
        library_ms = cuda_ms(lambda: gru(x))
        library_queued = queued_ms(lambda: gru(x))
        plan = gates.device_p_plan(GRU_ROWS, dev, gates.P3_UNITS)
        inst = []
        for levels in A_LEVELS:
            passes = [gates.PASSES[level] for level in levels]
            ms = cuda_ms(lambda: gates.gru_gates_3x(net, *gi, levels))
            queued = queued_ms(lambda: gates.gru_gates_3x(net, *gi, levels))
            plain_ms = cuda_ms(lambda: gates.gru_gates_p_reference(gates.gate_weights(net, f32), *gi, levels=levels),
                               reps=1)
            bound_ms, bound_by = a_bound(GRU_ROWS, GRU_STEPS, passes, False)
            l2 = gates.plan_exchange_bytes_3x(GRU_ROWS, GRU_STEPS, levels)
            inst.append({"passes": list(passes), "levels": list(levels), "ms": ms, "queued_ms": queued,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": errs[levels]})
            log(f"kernel A {levels} at [{GRU_ROWS}, {GRU_STEPS}]: plan {len(plan)} launch, {a_plan(GRU_ROWS)}; "
                f"the plan's count of exchange L2 reads (not measured) {l2 / 1e9:.3f} GB a call (one read a CTA: "
                f"{gates.plan_exchange_bytes_3x(GRU_ROWS, GRU_STEPS, levels, cluster=1) / 1e9:.3f}); {ms:.3f} ms "
                f"single, {queued:.3f} queued, plain {plain_ms:.2f} ms; bound {bound_ms:.3f} ms by {bound_by}; "
                f"kernel 1 float32 in this process {k1['ms']:.3f} single, {k1['queued_ms']:.3f} queued; cuDNN float32 "
                f"GRU (TF32 off, another function) {library_ms:.3f} / {library_queued:.3f}; on {smi}")
        # The other shapes kernel A runs at: a 'high' chunk step, a 'high'
        # low-latency step from a state, and more rows than one launch held
        # before its shared memory stopped growing with them.
        shapes = []
        rng = np.random.default_rng(7)
        for n, t, carried in ((2 * SLICE_STREAMS, GRU_STEPS, False), (LL_ROWS[0], 1, True), (4000, GRU_STEPS, False)):
            x = net.fc_in(torch.from_numpy(rng.normal(-3.0, 1.5, (n, t, 161)).astype(np.float32)).to(dev))
            gi_n = gates.gi_gates(net, x)
            state = tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (n, 400))).astype(np.float32)).to(dev)
                          for _ in range(2)) if carried else None
            for levels in A_LEVELS:
                passes = [gates.PASSES[level] for level in levels]
                ms = cuda_ms(lambda: gates.gru_gates_3x(net, *gi_n, levels, state=state))
                queued = queued_ms(lambda: gates.gru_gates_3x(net, *gi_n, levels, state=state))
                bound_ms, bound_by = a_bound(n, t, passes, carried)
                l2 = gates.plan_exchange_bytes_3x(n, t, levels, carried)
                shapes.append({"shape": [n, t], "carried": carried, "levels": list(levels), "ms": ms,
                               "queued_ms": queued, "bound_ms": bound_ms, "bound_by": bound_by})
                log(f"kernel A {levels} at [{n}, {t}]{' from a state' if carried else ''}: {a_plan(n)}; the plan's "
                    f"count of exchange L2 reads (not measured) {l2 / 1e6:.3f} MB a call; {ms:.3f} ms single, "
                    f"{queued:.3f} queued; bound {bound_ms * 1e3:.2f} us by {bound_by}; on {smi}")
    top = inst[0]
    return {
        "name": "gru_gates_3x", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/gru_gates_p.cu",
        "replaces": "formula_vad_tpu/models/nsnet2_pallas.py:88", "max_abs_err": max(errs.values()),
        "ms": top["ms"], "queued_ms": top["queued_ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": library_ms, "library_queued_ms": library_queued,
        "library": "cuDNN two-layer torch.nn.GRU, float32, TF32 off (another function: float32 products)",
        "kernel_1_ms": k1["ms"], "kernel_1_queued_ms": k1["queued_ms"], "instantiations": inst,
        "tol_high": A_HIGH_TOL, "control_min_ratio": min(ratios), "grid": plan[0].grid,
        "tiles_per_group": plan[0].tiles_per_group, "smem_bytes": plan[0].smem_bytes("A"), "cluster": gates.P3_CLUSTER,
        "shapes": shapes,
    }


def kernel_b_rows(net, dev, smi: str) -> dict:
    """Phase 17 (b): kernel B (``gru_stack_mixed``) at each mix with
    'highest' against ``gru_stack_reference`` at the same levels: at
    P17_SHAPES (N(0, 0.8) gi1, N(0, 0.3) GRU biases) and at [42, 1] from a
    nonzero state, and nearer it than the plain versions at other levels;
    each instantiation's registers and local (spill) bytes, which must be
    0; its single and queued time at [1,680, 54] on the demo weights beside
    kernel 1's and cuDNN's float32 GRU, and at [42, 54] and [42, 1] from a
    state, each beside its bound (a 'highest' class at the float32 rate, a
    'high' or 'default' one as its bf16 passes at the tensor cores'). With
    CHIP_SMOKE_PARENT, the parent checkout's kernel B queued at the same
    inputs in this process, its calls and this tree's in turn (A B B A).
    -> the kernels line's entry."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2_cuda
    from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
    from formula_vad_tpu_torch.tools import cuda_ms, cudnn_gru, queued_ms

    bnet = biased_net(dev)
    errs, ratios = {}, []
    for levels in B_LEVELS:
        err = 0.0
        # The audit's two mixes (one class at 'high') at every shape; those
        # with 'default' at the scoring shape (the GPU tests take the rest).
        for n, t in P17_SHAPES if "high" in levels else P17_SHAPES[:1]:
            gi1 = torch.from_numpy((np.random.default_rng(n).standard_normal((n, t, 1200)) * 0.8).astype(np.float32))
            gi1 = gi1.to(dev)
            before = nsnet2_cuda.gru_stack_mixed.launches
            with torch.inference_mode():
                got = nsnet2_cuda.gru_stack_mixed(bnet, gi1, levels)
                want = nsnet2_cuda.gru_stack_reference(bnet, gi1, levels=levels)
            torch.cuda.synchronize()
            if nsnet2_cuda.gru_stack_mixed.launches - before != 1:
                raise AssertionError(f"kernel B {levels} at {n} rows was not counted once")
            what = f"kernel B {levels} vs plain at [{n}, {t}]"
            err = max(err, near_plain(what, got, want, levels, B_HIGH_TOL))
            with torch.inference_mode():
                ratios += nearer_own_levels(what, got, want, levels, lambda other: nsnet2_cuda.gru_stack_reference(
                    bnet, gi1, levels=other)).values()
        if "high" not in levels:
            errs[levels] = err
            continue
        rows = LL_ROWS[0]
        rng = np.random.default_rng(7)
        gi1 = torch.from_numpy((rng.standard_normal((rows, 1, 1200)) * 0.8).astype(np.float32)).to(dev)
        state = tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (rows, 400))).astype(np.float32)).to(dev)
                      for _ in range(2))
        with torch.inference_mode():
            got, (h1, h2) = nsnet2_cuda.gru_stack_mixed(bnet, gi1, levels, state)
            want, (w1, w2) = nsnet2_cuda.gru_stack_reference(bnet, gi1, state, levels=levels)
        for label, a, b in (("h2", got, want), ("final h1", h1, w1), ("final h2", h2, w2)):
            err = max(err, near_plain(f"kernel B {levels} from a state at [{rows}, 1], {label}", a, b, levels,
                                      B_HIGH_TOL))
        errs[levels] = err
    built = {levels: nsnet2_cuda.mixed_attributes(levels, dev) for levels in B_LEVELS}
    log(f"kernel B's instantiations as built (registers a thread, local bytes a thread): "
        + ", ".join(f"{levels} {a['registers']}, {a['local_bytes']}" for levels, a in built.items()))
    if any(a["local_bytes"] for a in built.values()):
        raise AssertionError(f"a kernel B instantiation spills to local memory: {built}")

    width = {"highest": 4, "high": 4, "default": 2}  # bytes a weight as the kernel reads it ('high': hi and lo)

    def b_bound(n, t, levels, carried):
        """Bytes: gi1 in, out, a state's two rows in and the final h1 out,
        the weights once at the width the kernel reads them; operations:
        the three products a step, none with h = 0 (gru_h's two at step 0
        of a stateless call), a 'highest' class at the float32 rate (67
        TFLOP/s) on the FMA pipe, a 'high' one as three bf16 x bf16 passes
        and a 'default' one as a pass, summed in float32, at the tensor
        cores' 989 TFLOP/s; the two pipes run at once, so the operations
        take the longer of the two times. -> (bound_ms, bound_by, float32
        ops, bf16 ops)."""
        product = 2 * n * 400 * 1200
        # gru_i: h1 Wi2 every step; gru_h: h1 Wh1 and h2 Wh2 where h[t-1] exists.
        classes = ((levels[0], t * product), (levels[1], 2 * (t if carried else t - 1) * product))
        f32_ops = sum(ops for level, ops in classes if level == "highest")
        bf16_ops = sum(ops * gates.PASSES[level] for level, ops in classes if level != "highest")
        nbytes = (n * t * 1200 * 4 + n * t * 400 * 4 + (3 * n * 400 * 4 if carried else 0)
                  + 400 * 1200 * (width[levels[0]] + 2 * width[levels[1]]))
        ops_ms = max(f32_ops / F32_OPS_PER_MS, bf16_ops / BF16_OPS_PER_MS)
        return (*bound(nbytes, ops_ms, 1.0), f32_ops, bf16_ops)  # the operations given as their time

    parent = parent_port()
    pcuda = importlib.import_module(f"{parent.__name__}.models.nsnet2_cuda") if parent else None
    pnet = importlib.import_module(f"{parent.__name__}.models.registry").load_denoiser("demo", device=dev) if parent \
        else None
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(-3.0, 1.5, (GRU_ROWS, GRU_STEPS, 161)).astype(np.float32)).to(dev)
    gru = cudnn_gru(net, dev)
    rng = np.random.default_rng(8)
    rows = LL_ROWS[0]
    state = tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (rows, 400))).astype(np.float32)).to(dev)
                  for _ in range(2))
    with torch.inference_mode():
        x = net.fc_in(feats)
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
        k1_ms = cuda_ms(lambda: nsnet2_cuda.gru_stack(net, gi1))
        k1_queued = queued_ms(lambda: nsnet2_cuda.gru_stack(net, gi1))
        library_ms = cuda_ms(lambda: gru(x))
        # A chunk step's rows (the slice's 21 streams x 2 channels) and a
        # low-latency hop of theirs from a state.
        shapes = ((GRU_ROWS, GRU_STEPS, gi1, None), (rows, GRU_STEPS, gi1[:rows].contiguous(), None),
                  (rows, 1, gi1[:rows, :1].contiguous(), state))
        inst = []
        for levels in B_LEVELS:
            row = {"levels": list(levels), "max_abs_err": errs[levels], **built[levels], "shapes": []}
            for n, t, g, st in shapes:
                ms = cuda_ms(lambda: nsnet2_cuda.gru_stack_mixed(net, g, levels, st))
                queued = queued_ms(lambda: nsnet2_cuda.gru_stack_mixed(net, g, levels, st))
                bound_ms, bound_by, f32_ops, bf16_ops = b_bound(n, t, levels, st is not None)
                at = {"shape": [n, t], "carried": st is not None, "ms": ms, "queued_ms": queued, "bound_ms": bound_ms,
                      "bound_by": bound_by}
                line = (f"kernel B {levels} at [{n}, {t}]{' from a state' if st is not None else ''}: {ms:.3f} ms "
                        f"single, {queued:.3f} queued; bound {bound_ms:.4f} ms by {bound_by} ({f32_ops / 1e9:.2f} "
                        f"GFLOP of float32 at 67 TFLOP/s, {bf16_ops / 1e9:.2f} of bf16 passes at 989, the longer "
                        f"of the two)")
                if pcuda is not None:  # the parent's kernel B and this one in turn: A B B A
                    calls = (lambda: pcuda.gru_stack_mixed(pnet, g, levels, st),
                             lambda: nsnet2_cuda.gru_stack_mixed(net, g, levels, st))
                    times = [queued_ms(calls[j]) for j in (0, 1, 1, 0)]
                    at["parent_queued_ms"], at["abba_queued_ms"] = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
                    line += (f"; A B B A queued, the parent's kernel B {at['parent_queued_ms']:.3f}, this one "
                             f"{at['abba_queued_ms']:.3f}")
                row["shapes"].append(at)
                if n == GRU_ROWS:
                    plain_ms = cuda_ms(lambda: nsnet2_cuda.gru_stack_reference(net, g, levels=levels), reps=1)
                    row.update(ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                    line += (f"; plain {plain_ms:.2f} ms; kernel 1 in this process {k1_ms:.3f} single, "
                             f"{k1_queued:.3f} queued, cuDNN float32 GRU {library_ms:.3f}")
                log(f"{line}; on {smi}")
            inst.append(row)
    plans = {levels: nsnet2_cuda.device_plan(GRU_ROWS, dev, levels) for levels in B_LEVELS}
    plan = plans[B_LEVELS[0]]
    log(f"kernel B's plan at [{GRU_ROWS}, {GRU_STEPS}] (its own occupancy, {nsnet2_cuda.MIXED_SMEM_BYTES} bytes "
        f"of shared memory a CTA): {plan.tiles} tiles of {plan.row_tile} rows x "
        f"{plan.unit_tile} units, grid {plan.grid}, the same at every mix: {len(set(plans.values())) == 1}")
    top = inst[0]
    return {
        "name": "gru_stack_mixed", "route": "cuda", "source": "formula_vad_tpu_torch/csrc/gru_mixed.cu",
        "replaces": "formula_vad_tpu/models/nsnet2_pallas.py:88", "max_abs_err": max(errs.values()),
        "ms": top["ms"], "queued_ms": top["queued_ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": library_ms,
        "library": "cuDNN two-layer torch.nn.GRU, float32, TF32 off (another function: every product float32)",
        "kernel_1_ms": k1_ms, "kernel_1_queued_ms": k1_queued, "instantiations": inst, "tol_high": B_HIGH_TOL,
        "control_min_ratio": min(ratios), "grid": plan.grid, "tiles": plan.tiles, "row_tile": plan.row_tile,
        "unit_tile": plan.unit_tile, "smem_bytes": nsnet2_cuda.MIXED_SMEM_BYTES,
    }


def parent_port():
    """The package of the checkout CHIP_SMOKE_PARENT names, loaded once as
    ``parent_port`` beside this one (its kernels built from its own
    sources), or None where the variable is not set."""
    import importlib.util

    parent = os.environ.get("CHIP_SMOKE_PARENT")
    if not parent:
        return None
    if "parent_port" not in sys.modules:
        pkg = os.path.join(os.path.abspath(parent), "formula_vad_tpu_torch")
        spec = importlib.util.spec_from_file_location("parent_port", os.path.join(pkg, "__init__.py"),
                                                      submodule_search_locations=[pkg])
        module = importlib.util.module_from_spec(spec)
        sys.modules["parent_port"] = module
        spec.loader.exec_module(module)
    return sys.modules["parent_port"]


def unchanged_outputs(pkg: str, dev) -> dict:
    """The outputs of kernel 1 (gru_stack) and kernel 5 in bf16
    (gru_gates_p) of package ``pkg`` on fixed inputs: the demo weights,
    numpy-drawn gi at [1,680, 54] and a [42, 54] call continuing a nonzero
    state. -> {name: first 16 hex digits of the SHA-256 of the outputs'
    bytes}."""
    import hashlib
    import importlib

    import torch

    registry = importlib.import_module(f"{pkg}.models.registry")
    cuda = importlib.import_module(f"{pkg}.models.nsnet2_cuda")
    gates = importlib.import_module(f"{pkg}.models.nsnet2_gates_cuda")
    net = registry.load_denoiser("demo", device=dev)
    rng = np.random.default_rng(17)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.8).astype(np.float32)).to(dev)

    gi1, gi = draw(GRU_ROWS, GRU_STEPS, 1200), tuple(draw(GRU_ROWS, GRU_STEPS, 400) for _ in range(3))
    state = tuple(torch.tanh(draw(42, 400)) for _ in range(2))
    with torch.inference_mode():
        k1 = [cuda.gru_stack(net, gi1), *cuda.gru_stack(net, gi1[:42].contiguous(), state)[1]]
        k5 = [gates.gru_gates_p(net, *gi, dtype=torch.bfloat16)]
        k5 += gates.gru_gates_p(net, *(g[:42].contiguous() for g in gi), dtype=torch.bfloat16, state=state)[1]
    torch.cuda.synchronize()

    def digest(ts):
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]

    return {"gru_stack": digest(k1), "gru_gates_p": digest(k5)}


def check_unchanged(dev) -> dict:
    """Phase 17 (c): kernel 1 (highest/highest) and kernel 5 (default/
    default) give the parent tree's bits: against PARENT_DIGESTS, and where
    CHIP_SMOKE_PARENT names a checkout, against its package loaded beside
    this one and built from its own sources. It fails where it can compare
    with neither (another nvcc release and no parent checkout). -> {"digests":
    this build's, "against": what they were compared with}."""
    from formula_vad_tpu_torch import _build

    got = unchanged_outputs("formula_vad_tpu_torch", dev)
    want = dict(PARENT_DIGESTS)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    release = nvcc.stdout.strip().splitlines()[-1]
    if release != PARENT_DIGESTS_NVCC:
        log(f"unchanged instantiations: PARENT_DIGESTS were recorded with nvcc '{PARENT_DIGESTS_NVCC}', this build "
            f"uses '{release}'; they bind that release only")
        want = {}
    parent = os.environ.get("CHIP_SMOKE_PARENT")
    if parent:
        beside = unchanged_outputs(parent_port().__name__, dev)
        log(f"unchanged instantiations: the parent's build at {parent} gives {beside}")
        if want and beside != want:
            raise AssertionError(f"the parent's digests {beside} differ from PARENT_DIGESTS {want}")
        want = beside
    against = f"the parent's build at {parent}" if parent else f"PARENT_DIGESTS (nvcc '{PARENT_DIGESTS_NVCC}')"
    if not want:
        raise AssertionError(f"the unchanged instantiations cannot be compared: nvcc '{release}' is not the release "
                             "of PARENT_DIGESTS, and CHIP_SMOKE_PARENT names no parent checkout to build")
    log(f"unchanged instantiations: this build {got}, {against} {want}")
    if got != want:
        raise AssertionError(f"kernels 1 and 5 no longer give the parent's bits: {got} against {want}")
    return {"digests": got, "against": against}


def f64_sums(a, b, stage: str | None = None, level: str | None = None):
    """``precision.matmul``'s function at 'default', 'highest' and under
    bf16 storage with the products summed in float64: another summation
    order, the witness of phase 17 (f)."""
    import torch

    from formula_vad_tpu_torch.ops import precision

    if a.dtype == b.dtype == torch.bfloat16:
        return (a.double() @ b.double()).to(torch.bfloat16)
    level = precision.matmul_precision(stage) if level is None else level
    a, b = a.float(), b.float()
    if level == "default":
        a, b = precision.bf16_round(a), precision.bf16_round(b)
    elif level != "highest":
        raise ValueError(f"f64_sums takes 'default' and 'highest', not {level!r}")
    return (a.double() @ b.double()).float()


def lbr0_tiers(dev, counters) -> dict:
    """Phase 17 (f): lbr = 0 weights, which no kernel takes, at 'default'
    and under bf16 storage: the plain loop on the card, run twice a seed
    (LBR0_SEEDS; the two bit for bit), against the CPU, with no launch. The
    demo weights within the CPU tests' bars, max and mean. The biased
    weights within the max bar; their mean is fault 3's rounding cascade (a
    bf16 rounding step of h taken otherwise cascades through a row's
    steps), so it is held to LBR0_WITNESS_X times the largest mean |d| that
    the witness, the CPU's forward with every product summed in float64
    (``f64_sums``), stands from the CPU on these seeds. -> the launches of
    the card's runs (all 0)."""
    import torch

    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.ops import precision

    cpu = torch.device("cpu")
    total = dict.fromkeys(counters, 0)
    for label, make in (("demo", lambda d: load_denoiser("demo", device=d)), ("biased", biased_net)):
        nets = {d: make(d) for d in (dev, cpu)}
        for n in nets.values():
            n.gru1.linear_before_reset = n.gru2.linear_before_reset = 0
        for level, io, bars in (("default", "f32", (2e-3, 2e-5)), ("highest", "bf16", (4e-3, 2e-5))):
            card, witness = [], []
            for seed in LBR0_SEEDS:
                feats = torch.from_numpy(
                    np.random.default_rng(seed).normal(-3.0, 1.5, (42, GRU_STEPS, 161)).astype(np.float32))
                matmul = precision.matmul
                precision.set_matmul_precision(level)
                precision.set_io_dtype(io)
                try:
                    reset_counts(counters)
                    with torch.inference_mode():
                        got = nets[dev](feats.to(dev), out_frames=50).cpu()
                        again = nets[dev](feats.to(dev), out_frames=50).cpu()
                        torch.cuda.synchronize()
                        launched = launches_of(counters)
                        want = nets[cpu](feats, out_frames=50)
                        precision.matmul = f64_sums
                        sums64 = nets[cpu](feats, out_frames=50)
                finally:
                    precision.matmul = matmul
                    precision.set_matmul_precision("highest")
                    precision.set_io_dtype("f32")
                total = {k: total[k] + v for k, v in launched.items()}
                d = (got.float() - want.float()).abs()
                card.append(float(d.mean()))
                witness.append(float((sums64.float() - want.float()).abs().mean()))
                log(f"lbr = 0 {label} weights at {level}, {io} storage, seed {seed} (the plain loop on the card, "
                    f"{got.dtype}, twice): gains vs the CPU's max |d| {float(d.max()):.3e}, mean {card[-1]:.3e}; "
                    f"float64 sums vs the CPU's mean {witness[-1]:.3e}, vs the card's "
                    f"{float((sums64.float() - got.float()).abs().mean()):.3e}; launches {launched}")
                if not torch.equal(got, again):
                    raise AssertionError(f"lbr = 0 {label} at {level}, {io}, seed {seed}: two card runs differ")
                mean_ok = card[-1] <= bars[1] if label == "demo" else True
                if not (float(d.max()) <= bars[0] and mean_ok and not any(launched.values())):
                    raise AssertionError(f"lbr = 0 {label} at {level}, {io}, seed {seed}: max {float(d.max())}, "
                                         f"mean {card[-1]}, launches {launched}")
            if label == "biased":
                limit = LBR0_WITNESS_X * max(witness)
                log(f"lbr = 0 biased weights at {level}, {io} storage: card vs CPU mean |d| {max(card):.3e} at most "
                    f"over seeds {LBR0_SEEDS} (limit {limit:.3e}: {LBR0_WITNESS_X} x the float64 sums' largest, "
                    f"{max(witness):.3e})")
                if not max(card) <= limit:
                    raise AssertionError(f"lbr = 0 biased at {level}, {io}: card vs CPU mean {max(card)} > {limit}")
    return total


def phase_precision(runner, audio, float_results, tier_walls: dict, smi: str) -> tuple[list[dict], dict]:
    """Phase 17: the remaining precision tiers. (a) kernel A, (b) kernel B
    against their plain versions with their plans, times and bounds; (c)
    the unchanged instantiations bit for bit with the parent's; (d) the
    'high' slice through BatchRunner, kernel A once a run and kernel 1
    never; (e) the int8 slice under bf16 storage, 167 kernel-3 launches a
    run; (f) lbr = 0 weights at 'default' and under bf16 storage, card
    against CPU, no launch; (g) the stage audit's entry point on the card.
    -> (the kernels line's entries, {path: each kernel's launches})."""
    import io as io_mod

    import torch

    from formula_vad_tpu_torch.ops import precision
    from formula_vad_tpu_torch.tools import stage_precision_audit

    t_phase = time.perf_counter()
    net, dev = runner.net, runner.device
    audio_sec = SLICE_STREAMS * SLICE_SECONDS
    rows = [kernel_a_rows(net, dev, smi), kernel_b_rows(net, dev, smi)]
    log(f"phase 17 (a, b) took {time.perf_counter() - t_phase:.1f} s")
    digests = check_unchanged(dev)
    counters = path_counters()
    launches = {}

    # (d) the high slice: its recurrence on kernel A, once a run.
    precision.set_matmul_precision("high")
    try:
        results, walls, launches["high"] = timed_runs(runner, audio, counters)
    finally:
        precision.set_matmul_precision("highest")
    if launches["high"] != dict(dict.fromkeys(counters, 0), gru_gates_3x=3, scan_windows=3):
        raise AssertionError(f"the high slice launched {launches['high']} over 3 runs, not 1 kernel A and 1 FSM a run")
    spans_within_a_window("the high slice (kernel A) against the float tier's", results, float_results)
    wall = statistics.median(walls)
    log(f"high slice {SLICE_STREAMS} x {SLICE_SECONDS:.0f} s: wall {wall * 1e3:.1f} ms (median of 3, runs "
        f"{[round(w * 1e3, 1) for w in walls]}), real-time factor {audio_sec / wall:.1f}; phase 11 in this call: "
        + ", ".join(f"{t} {w * 1e3:.1f} ms (RTF {audio_sec / w:.1f})" for t, w in tier_walls.items())
        + f"; launches over 3 runs {launches['high']}; on {smi}")

    # (e) int8 under bf16 storage.
    precision.set_quant("int8")
    precision.set_io_dtype("bf16")
    try:
        results, walls, launches["int8_bf16"] = timed_runs(runner, audio, counters)
    finally:
        precision.set_quant("off")
        precision.set_io_dtype("f32")
    if launches["int8_bf16"] != dict(dict.fromkeys(counters, 0), matmul_q8=3 * Q8_LAUNCHES, scan_windows=3):
        raise AssertionError(f"the int8 + bf16 storage slice launched {launches['int8_bf16']} over 3 runs")
    spans_within_a_window("the int8 slice under bf16 storage against the float tier's", results, float_results)
    wall = statistics.median(walls)
    log(f"int8 slice under bf16 storage: wall {wall * 1e3:.1f} ms (median of 3), real-time factor "
        f"{audio_sec / wall:.1f}; {Q8_LAUNCHES} kernel-3 launches a run; on {smi}")

    launches["lbr0"] = lbr0_tiers(dev, counters)

    # (g) the stage audit's entry point, in this process so that its launches count.
    reset_counts(counters)
    out = io_mod.StringIO()
    with contextlib.redirect_stdout(out):
        code = stage_precision_audit.main([])
    torch.cuda.synchronize()
    launches["audit"] = launches_of(counters)
    for line in out.getvalue().splitlines():
        log(f"  audit | {line}")
    stages = [line for line in out.getvalue().splitlines() if line.startswith("stage ")]
    if code != 0 or len(stages) != 7:
        raise AssertionError(f"the stage audit exited {code} with {len(stages)} stage rows")
    if launches["audit"]["gru_stack_mixed"] < 2 or launches["audit"]["gru_gates_3x"] < 1:
        raise AssertionError(f"the audit did not run kernels A and B: {launches['audit']}")
    log(f"stage audit (python -m formula_vad_tpu_torch.tools.stage_precision_audit, SPA defaults): launches "
        f"{launches['audit']}")
    rows[0]["launches"] = launches["high"]["gru_gates_3x"]
    rows[1]["launches"] = launches["audit"]["gru_stack_mixed"]
    rows[0]["digests_unchanged"] = digests["digests"]
    rows[0]["digests_checked_against"] = digests["against"]
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return rows, launches



def phase_train(dev, audio, smi: str) -> dict:
    """Phase 16: training. -> {"launches": each kernel's launches in the
    training runs ("train", all 0), the eval-only run ("eval") and the
    slice scored with the trained weights ("score"), and the measures}."""
    import torch

    from formula_vad_tpu_torch.eval import denoise_quality as dq
    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.parallel.runner import BatchRunner
    from formula_vad_tpu_torch.train import nsnet2_train

    t_phase = time.perf_counter()
    counters = path_counters()
    grads = train_grads(dev, counters)
    launches = {"train": dict.fromkeys(counters, 0)}
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        def base(b):
            return ["--synthetic", str(TRAIN_POOL), "--device-data", "--batch", str(b), "--frames", str(TRAIN_FRAMES)]

        for b in TRAIN_BATCHES:
            argv = base(b) + ["--steps", str(TRAIN_STEPS), "--out", os.path.join(root, f"w{b}.onnx"),
                              "--ckpt-dir", os.path.join(root, f"ck{b}"), "--ckpt-every", str(TRAIN_STEPS)]
            run, got, peak, _ = train_run(argv, counters)
            for name, n in got.items():
                launches["train"][name] += n
            losses = run["losses"]
            first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
            if not (all(np.isfinite(losses)) and last < first):
                raise AssertionError(f"the loss did not fall at batch {b}: {losses}")
            event_ms, host_ms = statistics.median(run["event_ms"][1:]), statistics.median(run["host_ms"][1:])
            log(f"apps.train --batch {b} --frames {TRAIN_FRAMES} ({TRAIN_STEPS} steps, pool {TRAIN_POOL} on the "
                f"card) on {smi}: step {event_ms:.2f} ms on CUDA events, {host_ms:.2f} ms on the host clock "
                f"(medians past the first step; first {run['event_ms'][0]:.1f}); loss {losses[0]:.5f} -> "
                f"{losses[-1]:.5f} (means of the first and last 5: {first:.5f} -> {last:.5f}); peak memory "
                f"{peak:.1f} MB; launches {got}")
            prof, got = train_profiled(base(b) + ["--steps", str(TRAIN_PROFILED), "--out", os.path.join(root, "p.npz")],
                                       counters)
            for name, n in got.items():
                launches["train"][name] += n
            if prof["busy_ms"] is not None:
                # The profiler slows the host 2-3x, so its busy share of a
                # step is a floor; against the unprofiled step it is nearer.
                prof["busy_share_of_step"] = prof["busy_ms"] / prof["steps"] / event_ms
                log(f"  device busy a step (profiled) over the unprofiled step: {100 * prof['busy_share_of_step']:.1f}%")
            runs[b] = {"step_event_ms": event_ms, "step_host_ms": host_ms, "first_step_ms": run["event_ms"][0],
                       "loss_first5": first, "loss_last5": last, "peak_mb": peak, "profiled": prof}
        # (c) a run stopped at a checkpoint and resumed against the straight one.
        b = TRAIN_BATCHES[0]
        ck, resumed = os.path.join(root, "ck_resume"), os.path.join(root, "resumed.onnx")
        for steps in (TRAIN_RESUME_AT, TRAIN_STEPS):
            run, got, _, _ = train_run(base(b) + ["--steps", str(steps), "--out", resumed, "--ckpt-dir", ck,
                                                   "--ckpt-every", str(TRAIN_RESUME_AT)], counters)
            for name, n in got.items():
                launches["train"][name] += n
        if run["start_step"] != TRAIN_RESUME_AT:
            raise AssertionError(f"the second run did not resume at step {TRAIN_RESUME_AT}: {run['start_step']}")
        straight = os.path.join(root, f"w{b}.onnx")
        a_net, b_net = (load_denoiser(path, device="cpu") for path in (straight, resumed))
        diffs = [float((p - q).abs().max()) for p, q in zip(a_net.parameters(), b_net.parameters())]
        if max(diffs) != 0.0:
            raise AssertionError(f"the resumed run's weights differ from the straight run's: max |d| a parameter {diffs}")
        log(f"a run resumed at step {TRAIN_RESUME_AT} of {TRAIN_STEPS} writes the straight run's weights bit for bit "
            f"(.onnx files {'identical' if open(straight, 'rb').read() == open(resumed, 'rb').read() else 'differ'})")
        # (d) the trained weights on the scoring path.
        trained, trained_cpu = load_denoiser(straight, device=dev), load_denoiser(straight, device="cpu")
        feats = torch.from_numpy(np.random.default_rng(16).normal(-3.0, 1.5, (2 * SLICE_STREAMS, 54, 161))
                                 .astype(np.float32))
        with torch.no_grad():
            want = nsnet2_train.apply(trained_cpu, feats)
        with torch.inference_mode():
            err = float((trained(feats.to(dev)).cpu() - want).abs().max())
        if err > GRU_TOL:
            raise AssertionError(f"the trained weights' scoring forward differs from the trainer's: {err}")
        runner = BatchRunner(trained)
        reset_counts(counters)
        t0 = time.perf_counter()
        results = runner.run(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["score"] = check_launches("the slice with the trained weights", counters, gru_stack=1, scan_windows=1)
        host = BatchRunner(trained, use_host_fsm=True).run(audio)
        if [r.segments for r in results] != [r.segments for r in host]:
            raise AssertionError("the trained weights' slice: device-FSM and host-FSM segments differ")
        log(f"the trained weights (.onnx through load_denoiser): scoring forward against the trainer's at "
            f"[{2 * SLICE_STREAMS}, 54] max |dgain| {err:.2e}; the slice in {wall * 1e3:.1f} ms (first run), "
            f"{sum(len(r.segments) for r in results)} segments, identical with the host decoder; launches "
            f"{launches['score']}")
        ev = ["--steps", str(TRAIN_STEPS), "--ckpt-dir", os.path.join(root, f"ck{b}"), "--eval",
              "--eval-pairs", str(QUALITY_PAIRS), "--eval-seconds", str(QUALITY_SECONDS)]
        run, got, _, lines = train_run(ev, counters)
        launches["eval"] = check_launches("the eval-only run", counters,
                                          gru_stack=QUALITY_PAIRS * int(QUALITY_SECONDS / 0.5))
        if run["steps"] != 0:
            raise AssertionError(f"the eval-only run trained {run['steps']} steps")
        quality = json.loads(lines[-1])["denoise_quality"]
        cpu = dq.evaluate(trained_cpu, n_pairs=QUALITY_PAIRS, seconds=QUALITY_SECONDS, device="cpu")
        for g, w in zip(quality["pairs"] + [quality], cpu["pairs"] + [cpu]):
            for key, v in g.items():
                if key.endswith("_db") and not abs(v - w[key]) <= QUALITY_TOL_DB:
                    raise AssertionError(f"--eval on the card differs from the CPU's evaluate: {key} {v} against {w[key]}")
        log(f"apps.train --eval (eval-only, from the step-{TRAIN_STEPS} checkpoint): {lines[-1]}; the CPU's "
            f"evaluate: mean {cpu['mean_si_sdr_impr_db']} dB; launches {launches['eval']}")
    if any(launches["train"].values()):
        raise AssertionError(f"a kernel launched in a training run: {launches['train']}")
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "grads": grads, "runs": runs, "quality": quality, "score_wall_ms": wall * 1e3}


def mesh_slice(net, dev, audio, float_results, float_wall: float, counters, smi: str) -> dict:
    """Phase 18 (a); -> {"launches": by mesh, "walls": by mesh}."""
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib
    from formula_vad_tpu_torch.parallel.runner import BatchRunner
    from formula_vad_tpu_torch.pipeline import offline

    process = offline.process_batch_offline
    seen = []

    def capture(net_, st, x, valid, params):
        win_out, carry = process(net_, st, x, valid, params)
        seen.append({next(net_.parameters()).device, x.device, valid.device, *(t.device for t in win_out)})
        return win_out, carry

    out = {"launches": {}, "walls": {}}
    want = [r.segments for r in float_results]
    for k in MESH_SHARDS:
        mesh = mesh_lib.data_mesh([dev] * k)
        runner = BatchRunner(net, mesh=mesh)
        seen.clear()
        offline.process_batch_offline = capture
        try:
            results, walls, launches = timed_runs(runner, audio, counters)
        finally:
            offline.process_batch_offline = process
        if launches != dict(dict.fromkeys(counters, 0), gru_stack=3 * k, scan_windows=3 * k):
            raise AssertionError(f"the slice over {k} shards launched {launches} in 3 runs, not one of kernels 1 and 2 a shard")
        if len(seen) != 4 * k or any(devs != {mesh.devices[j % k]} for j, devs in enumerate(seen)):
            raise AssertionError(f"a shard's tensors left its device over {k} shards: {seen}")
        if [r.segments for r in results] != want:
            raise AssertionError(f"the slice's segments over {k} shards differ from phase 4's")
        wall = statistics.median(walls)
        out["launches"][f"batch_{k}"], out["walls"][f"batch_{k}"] = launches, wall
        log(f"mesh of {k} on {mesh.devices[0]} ({mesh_lib.pad_batch(SLICE_STREAMS, mesh)} streams with the padding): "
            f"segments identical to phase 4's; launches over 3 runs {launches}; every shard's model, inputs and FSM "
            f"outputs on its device; wall {wall * 1e3:.1f} ms (median of 3, {[round(w * 1e3, 1) for w in walls]}) against "
            f"phase 4's {float_wall * 1e3:.1f} ms unsharded; on {smi}")
    return out


def mesh_slab(net, dev, root: str, slab_segments: list, counters, smi: str) -> dict:
    """Phase 18 (b); -> the sharded slab run's launches and wall."""
    import torch

    from formula_vad_tpu_torch.io_ import AudioSource
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib
    from formula_vad_tpu_torch.parallel.slab_runner import SlabRunner

    srcs = [AudioSource.open_stream(os.path.join(root, "race", f"s{i}.wav")) for i in range(SLAB_STREAMS)]
    try:
        def read_raw16(src):
            def read(start, n):
                src.seek_to_sample(start)
                return src.read_raw16(n)
            return read

        def run(lengths=SLAB_LENGTHS):
            results = runner.run_readers([read_raw16(src) for src in srcs], lengths, raw16=True)
            torch.cuda.synchronize()
            return results

        runner = SlabRunner(net, slab_chunks=SLAB_CHUNKS, mesh=mesh_lib.data_mesh([dev] * 2))
        run([min(n, 2 * SLAB_CHUNKS * 24000) for n in SLAB_LENGTHS])  # the warm-up
        dispatch, fetch = runner._dispatch, runner._fetch
        dispatched, fetched_after = [0], []

        def strict_dispatch(*args):
            out = dispatch(*args)
            dispatched[0] += 1
            torch.cuda.set_sync_debug_mode("error")  # any synchronising call from here raises
            return out

        def relaxed_fetch(slab_outs):
            torch.cuda.set_sync_debug_mode("default")
            fetched_after.append(dispatched[0])
            return fetch(slab_outs)

        runner._dispatch, runner._fetch = strict_dispatch, relaxed_fetch
        reset_counts(counters)
        t0 = time.perf_counter()
        try:
            results = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wall = time.perf_counter() - t0
    finally:
        for src in srcs:
            src.close()
    launches = launches_of(counters)
    if launches != dict(dict.fromkeys(counters, 0), gru_stack=2 * SLAB_COUNT, scan_windows=2 * SLAB_COUNT):
        raise AssertionError(f"the slab run over 2 shards launched {launches}, not one of kernels 1 and 2 a shard a slab")
    if fetched_after != [2 * SLAB_COUNT] * 2:
        raise AssertionError(f"the sharded slab run fetched after {fetched_after} dispatches, not once a shard at the end")
    if [r.segments for r in results] != slab_segments:
        raise AssertionError("the slab run's segments over 2 shards differ from phase 10's")
    log(f"slab run over 2 shards: segments identical to phase 10's, launches {launches}, no synchronising call from "
        f"the first dispatch to the fetches, one fetch a shard after all {2 * SLAB_COUNT} dispatches; wall "
        f"{wall * 1e3:.1f} ms; on {smi}")
    return {"launches": launches, "wall_s": wall}


def mesh_serve(net, dev, audio, big_p50: float, counters, smi: str) -> dict:
    """Phase 18 (c): phase 13's 256-stream fleet over 2 shards x microbatch 2."""
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib

    b, n = SERVE_BIG_STREAMS, SERVE_BIG_TICKS
    src = np.stack([audio[j % SLICE_STREAMS, :, 2 * (j // SLICE_STREAMS) * 24000:][:, : 2 * n * 24000]
                    for j in range(b)])
    chunks = np.ascontiguousarray(src[..., : n * 24000].reshape(b, 2, n, 24000).transpose(2, 0, 1, 3))
    sharded_kw = dict(mesh=mesh_lib.data_mesh([dev] * 2), use_mesh=True, microbatch=2)
    serve_run(net, chunks[:1], record=False)  # warm-ups at this fleet's shapes
    serve_run(net, chunks[:1], record=False, **sharded_kw)
    base = serve_run(net, chunks)
    reset_counts(counters)
    sharded = serve_run(net, chunks, **sharded_kw)
    launches = check_launches(f"the {b}-stream fleet over 2 shards x microbatch 2", counters,
                              gru_stack=4 * n, scan_windows=4 * n)
    err = same_serving(f"the {b}-stream fleet over 2 shards x microbatch 2 against the unsharded fleet", sharded, base,
                       exact=False)
    stats = serve_stats(f"{b} streams over 2 shards x microbatch 2", sharded, smi)
    log(f"  {b} streams over 2 shards x microbatch 2: segments, recordings, decisions and indices bit for bit with the "
        f"unsharded fleet, float outputs within {err:.3e}; launches {launches}; tick p50 {stats['tick_p50_ms']:.3f} ms "
        f"against the unsharded fleet's {base['stats']['p50_ms']:.3f} here and phase 13's {big_p50:.3f}")
    return dict(stats, launches=launches, max_abs_err=err, base_tick_p50_ms=base["stats"]["p50_ms"],
                phase13_tick_p50_ms=big_p50)


def mesh_processes(float_results, one_process_wall: float, smi: str) -> dict:
    """Phase 18 (d): two processes on the card, each of 2 shards."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, outs = [], []
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for rank in range(2):
            outs.append(os.path.join(d, f"w{rank}.json"))
            env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2", PROCESS_ID=str(rank),
                       LOCAL_DEVICES="2", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
            cmd = [sys.executable, "-m", "formula_vad_tpu_torch.testing.distributed", outs[-1], "--device", "cuda",
                   "--corpus", "slice"]
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=MESH_PROCESS_TIMEOUT)[0].decode(errors="replace"))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        elapsed = time.perf_counter() - t0
        for proc, text in zip(procs, logs):
            if proc.returncode != 0:
                raise AssertionError(f"a mesh worker exited {proc.returncode}:\n{text[-4000:]}")
        payloads = []
        for path in outs:
            with open(path) as f:
                payloads.append(json.load(f))
    want = json.loads(json.dumps([r.segments for r in float_results]))
    for pl in payloads:
        if pl["mesh_size"] != 4 or pl["n_processes"] != 2:
            raise AssertionError(f"worker {pl['rank']} saw a mesh of {pl['mesh_size']} over {pl['n_processes']} processes")
        if pl["segments"] != want:
            raise AssertionError(f"worker {pl['rank']}'s segments differ from the one-process run's")
        if pl["launches"] != {"gru_stack": 2, "scan_windows": 2}:
            raise AssertionError(f"worker {pl['rank']} launched {pl['launches']}, not kernels 1 and 2 once a shard")
    walls = [pl["wall_s"] for pl in payloads]
    log(f"two processes x 2 shards on {payloads[0]['devices']}: segments identical to each other's and to the "
        f"one-process run's, kernels 1 and 2 twice in each; wall {max(walls) * 1e3:.1f} ms (ranks "
        f"{[round(w * 1e3, 1) for w in walls]}) against one process over 4 shards {one_process_wall * 1e3:.1f} ms; "
        f"{elapsed:.1f} s with the processes' start; on {smi}")
    return {"launches": [pl["launches"] for pl in payloads], "walls_s": walls}


def phase_mesh(net, dev, audio, float_results, float_wall: float, root: str, slab_segments: list, big_p50: float,
               smi: str) -> dict:
    """Phase 18; -> {"launches": each kernel's launches by sub-phase, and the readings}."""
    t_phase = time.perf_counter()
    counters = path_counters()
    batch = mesh_slice(net, dev, audio, float_results, float_wall, counters, smi)
    slab = mesh_slab(net, dev, root, slab_segments, counters, smi)
    serve = mesh_serve(net, dev, audio, big_p50, counters, smi)
    procs = mesh_processes(float_results, batch["walls"][f"batch_{MESH_SHARDS[-1]}"], smi)
    launches = {name: {**{key: counts[name] for key, counts in batch["launches"].items()}, "slab_2": slab["launches"][name],
                       "serve_2x2": serve["launches"][name],
                       "processes_2x2": [counts.get(name, 0) for counts in procs["launches"]]}
                for name in counters}
    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "batch_walls_s": batch["walls"], "slab": slab, "serve": serve, "processes": procs}


def grid_steps(step, batches, counters, grads) -> dict:
    """``step`` over ``batches`` (on the card) with the launch counters and
    the peak memory reset before; ``grads()`` read after the first step.
    -> losses, step times on CUDA events and the host clock, peak MB,
    launches, the first step's gradients."""
    import torch

    reset_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, host, events, first = [], [], [], None
    for b in batches:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        losses.append(step(b))
        ev[1].record()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(ev)
        if first is None:
            first = {name: g.detach().cpu() for name, g in grads().items()}
    torch.cuda.synchronize()
    return {"losses": torch.stack(losses).tolist(), "event_ms": [a.elapsed_time(b) for a, b in events],
            "host_ms": host, "peak_mb": torch.cuda.max_memory_allocated() / 1e6, "launches": launches_of(counters),
            "grads": first}


def grid_profiled(step, batch) -> dict:
    """One step under torch.profiler tracing the card's activity only (a
    sharded step runs ~33,000 host ops, whose tracing would cost more than
    the step): the device's busy share of the step's span on the host
    clock, and the kernels it ran."""
    import torch

    from formula_vad_tpu_torch.tools import busy_ms

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return {"window_ms": window, "busy_ms": None, "busy_share": None, "kernels_a_step": None}
    busy, _, _ = busy_ms(events)
    n_kernels = sum(1 for e in events if not e.name.lower().startswith(("memcpy", "memset")))
    return {"window_ms": window, "busy_ms": busy, "busy_share": busy / window, "kernels_a_step": n_kernels}


def grid_equivalence(dev, counters, phase16_runs: dict, smi: str) -> dict:
    """Phase 19 (a): the unsharded step and each grid's on the same
    batches from the same weights; -> the readings by batch and grid."""
    import torch

    from formula_vad_tpu_torch.models import nsnet2
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib
    from formula_vad_tpu_torch.train import nsnet2_train

    # Phase 16's runs: apps.train's pool (--synthetic, seed 0) and its draws.
    pool = [x.to(dev) for x in nsnet2_train.synth_batch(torch.Generator().manual_seed(0), TRAIN_POOL, TRAIN_FRAMES)]
    out = {"launches": dict.fromkeys(counters, 0)}
    for b in TRAIN_BATCHES:
        n = GRID_STEPS
        idx = [torch.from_numpy(np.random.default_rng((0, i)).integers(0, TRAIN_POOL, b)).to(dev) for i in range(n + 1)]
        batches = [tuple(c.index_select(0, i) for c in pool) for i in idx]

        def fresh():
            return nsnet2_train.trainable(nsnet2.init_params(torch.Generator().manual_seed(0)).to(dev))

        net = fresh()
        opt = torch.optim.Adam(net.parameters(), lr=1e-4)
        step = nsnet2_train.make_train_step(opt, net)
        names = [name for name, _ in net.named_parameters()]
        t0 = time.perf_counter()
        base = grid_steps(step, batches[:n], counters, lambda: {name: p.grad for name, p in net.named_parameters()})
        base["profiled"] = grid_profiled(step, batches[n])
        base["seconds"] = time.perf_counter() - t0
        runs = {"unsharded": base}
        for rows, cols in GRID_SHAPES:
            t0 = time.perf_counter()
            grid = mesh_lib.data_model_mesh(cols, [dev] * (rows * cols))
            sharded = nsnet2_train.shard_params(fresh(), grid)
            opt = torch.optim.Adam(sharded.parameters(), lr=1e-4)
            step = nsnet2_train.make_train_step(opt, sharded, grid)
            run = grid_steps(step, batches[:n], counters, sharded.gathered_grads)
            what = f"the ({rows}, {cols}) grid at batch {b}"
            scales = [float(base["grads"][name].abs().max()) for name in names]
            errs = [float((run["grads"][name] - base["grads"][name]).abs().max()) / sc
                    for name, sc in zip(names, scales)]
            if min(scales) <= 0 or max(errs) > TRAIN_GRAD_TOL:
                raise AssertionError(f"{what}: the first step's gradients differ from the unsharded step's: {errs}")
            loss_err = max(abs(g - w) / abs(w) for g, w in zip(run["losses"], base["losses"]))
            if loss_err > GRID_LOSS_RTOL:
                raise AssertionError(f"{what}: losses {run['losses']} against unsharded {base['losses']}")
            losses, k = run["losses"], min(5, n // 2)
            if not (all(np.isfinite(losses)) and statistics.mean(losses[-k:]) < statistics.mean(losses[:k])):
                raise AssertionError(f"{what}: the loss did not fall: {losses}")
            run["profiled"] = grid_profiled(step, batches[n])
            run.update(grad_max_rel_err=max(errs), loss_max_rel_err=loss_err, seconds=time.perf_counter() - t0)
            runs[f"{rows}x{cols}"] = run
        for key, run in runs.items():
            if any(run["launches"].values()):
                raise AssertionError(f"{key} at batch {b}: a kernel launched in a step: {run['launches']}")
            for name, count in run["launches"].items():
                out["launches"][name] += count
            run["step_event_ms"] = statistics.median(run["event_ms"][1:])
            run["step_host_ms"] = statistics.median(run["host_ms"][1:])
            prof = run["profiled"]
            busy = ("not measured (no device events)" if prof["busy_ms"] is None else
                    f"busy {100 * prof['busy_share']:.1f}% of a profiled step, {prof['kernels_a_step']:.0f} kernels a step")
            extra = "" if key == "unsharded" else (
                f"; {run['step_event_ms'] / runs['unsharded']['step_event_ms']:.2f}x the unsharded step; first-step "
                f"gradients within {run['grad_max_rel_err']:.2e} of each array's largest (bar {TRAIN_GRAD_TOL:.0e}), "
                f"losses within {run['loss_max_rel_err']:.2e} (rtol {GRID_LOSS_RTOL:.0e}), no kernel launched")
            log(f"train grid {key} at [{b}, {TRAIN_FRAMES}] on {smi}: step {run['step_event_ms']:.2f} ms on CUDA events, "
                f"{run['step_host_ms']:.2f} ms on the host clock (medians of steps 2-{n}); {busy}; peak "
                f"memory {run['peak_mb']:.1f} MB; loss {run['losses'][0]:.5f} -> {run['losses'][-1]:.5f}{extra} "
                f"({run['seconds']:.1f} s with its checks)")
            del run["grads"]
        log(f"  phase 16's unsharded apps.train step at batch {b}: {phase16_runs[b]['step_event_ms']:.2f} ms on CUDA "
            f"events, {phase16_runs[b]['step_host_ms']:.2f} ms on the host clock")
        out[b] = runs
    return out


def grid_resume_and_score(dev, audio, counters, smi: str) -> dict:
    """Phase 19 (b) and (c): apps.train --tp 2 on a 2 x 2 grid of the card
    (``grid_devices`` patched: the CLI takes every visible card), resumed
    from a checkpoint against a straight run; the checkpoint in an
    unsharded --eval run; the weights on the scoring path. -> launches."""
    import io

    import torch

    from formula_vad_tpu_torch.apps import train as train_app
    from formula_vad_tpu_torch.eval import denoise_quality as dq
    from formula_vad_tpu_torch.models.registry import load_denoiser
    from formula_vad_tpu_torch.parallel.runner import BatchRunner

    t_start = time.perf_counter()
    launches = {}
    base = ["--synthetic", str(TRAIN_POOL), "--device-data", "--batch", str(TRAIN_BATCHES[0]), "--frames",
            str(TRAIN_FRAMES), "--tp", "2"]
    with tempfile.TemporaryDirectory() as root:
        straight, resumed, ck = (os.path.join(root, name) for name in ("straight.npz", "resumed.npz", "ck"))
        grid_devices = train_app.grid_devices
        train_app.grid_devices = lambda d: [d] * 4
        try:
            reset_counts(counters)
            for argv in (["--steps", str(GRID_RESUME_STEPS), "--out", straight],
                         ["--steps", str(GRID_RESUME_AT), "--out", resumed, "--ckpt-dir", ck, "--ckpt-every", str(GRID_RESUME_AT)],
                         ["--steps", str(GRID_RESUME_STEPS), "--out", resumed, "--ckpt-dir", ck, "--ckpt-every", str(GRID_RESUME_AT)]):
                with contextlib.redirect_stdout(io.StringIO()):
                    if train_app.main(base + argv) != 0:
                        raise AssertionError(f"apps.train {argv} failed")
                if train_app.main.last_run["grid"] != {"data": 2, "model": 2}:
                    raise AssertionError(f"apps.train --tp 2 over 4 devices ran on {train_app.main.last_run['grid']}")
            launches["train"] = check_launches("apps.train on the 2 x 2 grid", counters)
        finally:
            train_app.grid_devices = grid_devices
        if train_app.main.last_run["start_step"] != GRID_RESUME_AT:
            raise AssertionError(f"the (2, 2) run did not resume at step {GRID_RESUME_AT}")
        a_net, b_net = (load_denoiser(path, device="cpu") for path in (straight, resumed))
        if any(not torch.equal(p, q) for p, q in zip(a_net.parameters(), b_net.parameters())):
            raise AssertionError("the resumed (2, 2) run's weights differ from the straight run's")
        # The (2, 2) checkpoint in an unsharded run (one card: no grid), eval-only.
        unsharded = os.path.join(root, "unsharded.npz")
        ev = ["--steps", str(GRID_RESUME_STEPS), "--ckpt-dir", ck, "--out", unsharded, "--eval",
              "--eval-pairs", str(QUALITY_PAIRS), "--eval-seconds", str(QUALITY_SECONDS)]
        run, got, _, lines = train_run(ev, counters)
        launches["eval"] = check_launches("the eval-only run from the (2, 2) checkpoint", counters,
                                          gru_stack=QUALITY_PAIRS * int(QUALITY_SECONDS / 0.5))
        if run["grid"] is not None or run["steps"] != 0:
            raise AssertionError(f"the eval-only run trained or took a grid: {run}")
        c_net = load_denoiser(unsharded, device="cpu")
        if any(not torch.equal(p, q) for p, q in zip(c_net.parameters(), b_net.parameters())):
            raise AssertionError("the (2, 2) checkpoint loaded unsharded differs from the run's weights")
        log(f"apps.train --tp 2 on a 2 x 2 grid of the card ({GRID_RESUME_STEPS} steps at [{TRAIN_BATCHES[0]}, "
            f"{TRAIN_FRAMES}]): a run resumed at step {GRID_RESUME_AT} writes the straight run's weights bit for bit; "
            f"its checkpoint loads into an unsharded run with identical parameters; no kernel launched")
        quality = json.loads(lines[-1])["denoise_quality"]
        cpu = dq.evaluate(b_net, n_pairs=QUALITY_PAIRS, seconds=QUALITY_SECONDS, device="cpu")
        for g, w in zip(quality["pairs"] + [quality], cpu["pairs"] + [cpu]):
            for key, v in g.items():
                if key.endswith("_db") and not abs(v - w[key]) <= QUALITY_TOL_DB:
                    raise AssertionError(f"--eval of the (2, 2) weights differs from the CPU's evaluate: {key} {v} against {w[key]}")
        log(f"apps.train --eval of the (2, 2) checkpoint: {lines[-1]}; the CPU's evaluate: mean "
            f"{cpu['mean_si_sdr_impr_db']} dB; launches {launches['eval']}")
        trained = load_denoiser(resumed, device=dev)
        reset_counts(counters)
        t0 = time.perf_counter()
        results = BatchRunner(trained).run(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["score"] = check_launches("the slice with the (2, 2) weights", counters, gru_stack=1, scan_windows=1)
        host = BatchRunner(trained, use_host_fsm=True).run(audio)
        if [r.segments for r in results] != [r.segments for r in host]:
            raise AssertionError("the (2, 2) weights' slice: device-FSM and host-FSM segments differ")
        log(f"the (2, 2)-trained weights through load_denoiser: the slice in {wall * 1e3:.1f} ms (first run) on {smi}, "
            f"{sum(len(r.segments) for r in results)} segments, identical with the host decoder; launches {launches['score']} "
            f"((b) and (c) took {time.perf_counter() - t_start:.1f} s)")
    return {"launches": launches, "quality": quality, "score_wall_ms": wall * 1e3}


def phase_train_grid(dev, audio, phase16_runs: dict, smi: str) -> dict:
    """Phase 19: the trainer's ("data", "model") grid on the card."""
    t_phase = time.perf_counter()
    counters = path_counters()
    runs = grid_equivalence(dev, counters, phase16_runs, smi)
    rest = grid_resume_and_score(dev, audio, counters, smi)
    steps = runs.pop("launches")
    rest["launches"]["train"] = {name: n + steps[name] for name, n in rest["launches"]["train"].items()}
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, **rest}


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
    kernels = [phase_gru(net, dev)]
    check_lbr0(dev)
    kernels.append(phase_fsm(runner.st, dev))
    audio = slice_audio()
    launches, float_results, float_wall = phase_slice(runner, audio, smi)
    with tempfile.TemporaryDirectory() as corpus, tempfile.TemporaryDirectory() as root:
        write_corpus(corpus, CORPUS_STREAMS, 20.0, seed=2,
                     plans={**dict.fromkeys(("cuda", "cpu", "int8_cuda", "int8_cpu", "bf16_cuda", "bf16_cpu"), {}),
                            **dict.fromkeys(("stream_cuda", "stream_cpu"), {"batch_streams": False})})
        batched_dir = phase_entry_point(corpus)
        kernels.append(phase_q8_kernel(dev))
        launches["matmul_q8"] = phase_q8_slice(runner, audio, float_results, float_wall, corpus, smi)["matmul_q8"]
        gate_rows, path_a = phase_gates(dev, kernels[0]["ms"])
        kernels += gate_rows
        path_b = phase_bf16_slice(runner, audio, float_results, float_wall, corpus, smi)
        slab_launches, slab_shapes, slab_segments = phase_slab(net, dev, smi, SLICE_STREAMS * SLICE_SECONDS / float_wall,
                                                               root)
        tiers = phase_tiers(runner, audio, smi)
        stream = phase_stream(runner, audio, float_results, float_wall, corpus, batched_dir, smi)
        serve = phase_serve(net, audio, float_results, stream["float_segments"], corpus, smi)
        t14 = time.perf_counter()
        low = phase_lowlatency(net, dev, audio, smi)
        sweep = phase_sweep(net, dev, audio, float_results, float_wall, corpus, smi)
        log(f"phase 14 took {time.perf_counter() - t14:.1f} s")
        registry = phase_registry(net, dev, audio, float_results, float_wall, corpus, batched_dir, smi)
        train = phase_train(dev, audio, smi)
        precision_rows, precision_launches = phase_precision(runner, audio, float_results, tiers["walls"], smi)
        mesh = phase_mesh(net, dev, audio, float_results, float_wall, root, slab_segments,
                          serve["big"]["fleet"]["tick_p50_ms"], smi)
        train_grid = phase_train_grid(dev, audio, train["runs"], smi)
    # Kernels 4 and 6 run on the experiment tool's path only; kernel 5's
    # main path is the bf16 tier (it runs on the tool's path too).
    launches.update(gru_gates=path_a["gru_gates"], gru_gates_f=path_a["gru_gates_f"], gru_gates_p=path_b["gru_gates_p"])
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_slab"] = slab_launches[k["name"]]
        if k["name"] in slab_shapes:
            k["slab"] = slab_shapes[k["name"]]
        if k["name"] == "scan_windows":
            k["launches_by_body"] = launches["scan_windows_by_body"]
        # Phase 11: each tier's 3 slice runs at high and bf16_io, and the campaign.
        k["launches_tiers"] = {t: tiers["slice"][t][k["name"]] for t in ("high", "bf16_io")}
        k["launches_campaign"] = tiers["campaign"][k["name"]]
        if k["name"] == "gru_gates_f":
            k["bf16_io_path"] = tiers["kernel_6_path"]
        # Phase 12: the sum over its streaming runs (3 in each of float, bf16, bf16_io, int8).
        k["launches_stream"] = sum(run[k["name"]] for run in stream["runs"].values())
        if k["name"] in stream["stream_shapes"]:
            k["stream_shapes"] = stream["stream_shapes"][k["name"]]
        # Phase 13: the slice fleet's serving run (40 ticks, float tier, device FSM).
        k["launches_serve"] = serve["launches"][k["name"]]
        if k["name"] in serve["serve_shapes"]:
            k["serve_shapes"] = serve["serve_shapes"][k["name"]]
        # Phase 14: the low-latency run, its chained steps and each tier's
        # step; the sweep's 3 slice runs with 8 alternative machines.
        k["launches_lowlatency"] = low["launches"][k["name"]]
        if k["name"] in low["shapes"]:
            k["lowlatency_shapes"] = low["shapes"][k["name"]]
        k["launches_sweep"] = sweep["launches"][k["name"]]
        if k["name"] == "scan_windows":
            k["sweep_shape"] = sweep["shape"]
        # Phase 15: the imported model's 3 slice runs, the gate's 3 slice
        # runs, its streaming run (40 chunk steps) and its fleet's 8 ticks.
        for path, counts in registry["launches"].items():
            k[f"launches_{path}"] = counts[k["name"]]
        # Phase 16: the training runs' steps (0 for every kernel), the
        # eval-only run and the slice scored with the trained weights.
        for path, counts in train["launches"].items():
            k[f"launches_train{'' if path == 'train' else '_' + path}"] = counts[k["name"]]
    # Phase 17's kernels: their launches on their own paths (the high slice
    # for kernel A, the stage audit for kernel B), and on the earlier paths
    # that run the high tier (phases 11 and 14).
    for k in precision_rows:
        k["launches_tiers"] = {t: tiers["slice"][t][k["name"]] for t in ("high", "bf16_io")}
        k["launches_campaign"] = tiers["campaign"][k["name"]]
        k["launches_lowlatency"] = low["launches"][k["name"]]
        k["launches_phase17"] = {path: counts[k["name"]] for path, counts in precision_launches.items()}
    kernels += precision_rows
    # Phase 18: the mesh's runs (the slice over 2 and 4 shards, 3 runs each;
    # the slab run and the 256-stream fleet over 2 shards; each process of
    # the two-process run).
    # Phase 19: the trainer's grid: its training runs (0), the slice scored
    # with the (2, 2)-trained weights and the eval-only run from its checkpoint.
    for k in kernels:
        k["launches_mesh"] = mesh["launches"][k["name"]]
        k["launches_train_mesh"] = {path: counts[k["name"]] for path, counts in train_grid["launches"].items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
