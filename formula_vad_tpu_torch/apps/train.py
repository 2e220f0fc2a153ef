"""NSNet2 training CLI (port of ``formula_vad_tpu/apps/train.py``).

Trains the denoiser on (noisy, clean) WAV pairs with the DNS-Challenge
compressed-spectral loss (``train/nsnet2_train.py``): autograd and
``torch.optim.Adam``, on one device or over a ("data", "model") grid of
this process's devices, with checkpoint/resume.

Data layout: --data DIR containing ``<name>.noisy.wav`` / ``<name>.clean.wav``
pairs (any sample rate divisible by 16 kHz; decimated like the pipeline).
With --synthetic N, trains on a pool of N generated examples instead (smoke
mode; no fixtures ship with this repo).

Training runs on the card unless ``--device cpu`` is given; without a
visible GPU ``--device cuda`` (the default) raises. Data preparation runs
on the host; only the staged batches (or, with ``--device-data``, the
whole pool once) go to the card. ``FVAD_QUANT=int8`` is refused (no
gradient); ``FVAD_PRECISION`` and ``FVAD_IO_DTYPE`` act as in the JAX
trainer.

The grid follows the JAX CLI's rule: when more than one device is visible
or ``--tp`` > 1, the devices (``grid_devices``: every visible card, or on
``--device cpu`` the one CPU device) form ``parallel/mesh.py::
data_model_mesh(--tp)``, rows of ``--tp`` model columns. The parameters are
laid out Megatron-style over each row's columns and the batch, rounded up
to the number of rows, is split over the rows; ``--tp`` that does not
divide the devices raises the JAX ``ValueError``. Checkpoints and the
weights written are unsharded: a run resumes at another ``--tp``.

Usage:
  python -m formula_vad_tpu_torch.apps.train --steps 1000 --out weights.npz \\
      [--data DIR | --synthetic 64] [--ckpt-dir ckpts] [--tp 1] [--eval] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from .. import device as device_mod
from ..config import NSNET2_N_FFT, NSNET2_N_HOP
from ..io_.wav import read_wav
from ..models import nsnet2
from ..ops import resample, stft
from ..parallel import mesh as mesh_lib
from ..pipeline import denoiser as den_mod
from ..train import nsnet2_train
from ..utils import checkpoint
from ..utils.logging import configure, scoped

log = scoped("main")


def spectra_from_audio(audio: np.ndarray, rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Mono audio -> (re, im) NSNet2-frame spectra at 16 kHz, float32 numpy.
    Runs on the host CPU, as the JAX trainer's data preparation does: only
    the staged examples ever cross to the device."""
    if rate % 16000 != 0:
        raise ValueError(f"sample rate {rate} not divisible by 16000")
    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
    ds_rate = rate // 16000
    if ds_rate > 1:
        x = resample.downsample(x, ds_rate)
    n = (x.shape[-1] // NSNET2_N_HOP) * NSNET2_N_HOP
    prod = stft.segmat_prod(x[..., :n].contiguous(), None, den_mod.WINDOW, NSNET2_N_FFT, 1)
    re, im = stft.segmat_spectra(prod, NSNET2_N_FFT)
    return re.float().numpy(), im.float().numpy()


def load_pairs(data_dir: str, n_frames: int) -> list[tuple]:
    """(feats, n_re, n_im, c_re, c_im) windows of ``n_frames`` from the WAV
    pairs in ``data_dir``."""
    pairs = sorted(glob.glob(os.path.join(data_dir, "*.noisy.wav")))
    if not pairs:
        raise FileNotFoundError(f"no *.noisy.wav files in {data_dir}")
    examples = []
    for noisy_path in pairs:
        clean_path = noisy_path.replace(".noisy.wav", ".clean.wav")
        if not os.path.exists(clean_path):
            log.warning("skipping %s: no clean pair", noisy_path)
            continue
        noisy, rate = read_wav(noisy_path)
        clean, rate_c = read_wav(clean_path)
        if rate != rate_c:
            raise ValueError(f"rate mismatch for {noisy_path}")
        t = min(noisy.shape[1], clean.shape[1])
        n_re, n_im = spectra_from_audio(noisy[0, :t], rate)
        c_re, c_im = spectra_from_audio(clean[0, :t], rate)
        for s in range(0, n_re.shape[0] - n_frames + 1, n_frames):
            sl = slice(s, s + n_frames)
            feats = np.log10(np.maximum(n_re[sl] ** 2 + n_im[sl] ** 2, 1e-12))
            examples.append((feats, n_re[sl], n_im[sl], c_re[sl], c_im[sl]))
    if not examples:
        raise ValueError("no usable training windows found")
    return examples


def _upload(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev``: staged pinned and copied without blocking
    the host on the card."""
    return x.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else x


def grid_devices(dev: torch.device) -> list[torch.device]:
    """The devices a training grid spans, as the JAX CLI takes
    ``jax.devices()``: every visible card when training on the card, the
    one CPU device on the CPU."""
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the NSNet2 denoiser.")
    ap.add_argument("--data", default=None, help="Directory of *.noisy.wav/*.clean.wav pairs")
    ap.add_argument("--synthetic", type=int, default=0, help="Train on N synthetic examples")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=100, help="Frames per example window")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--tp", type=int, default=1,
                    help="Tensor-parallel (\"model\") axis of the training grid: each row of TP devices holds "
                    "the parameters Megatron-style, the rows split the batch (a grid whenever more than one "
                    "device is visible or TP > 1)")
    ap.add_argument(
        "--out", default=None,
        help="Output weights: .npz (the JAX package's format) or .onnx (ONNX-Runtime-ready, loadable by "
        "the original reference). Default nsnet2_weights.npz; an eval-only run (--eval with no training "
        "steps) skips the save unless --out is given explicitly",
    )
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--eval", action="store_true",
        help="After training (or alone with --steps 0 on resumed weights), score the weights' denoising "
        "quality: SI-SDR improvement on held-out synthetic pairs through the chunked pipeline "
        "(eval/denoise_quality.py) on the device; prints one JSON line",
    )
    ap.add_argument("--eval-pairs", type=int, default=3)
    ap.add_argument("--eval-seconds", type=float, default=16.0)
    ap.add_argument(
        "--device-data", action="store_true",
        help="Stage the whole example pool and every step's batch indices in device memory once and "
        "gather each batch there (index_select): no host-to-device copy in the step loop",
    )
    ap.add_argument("--device", choices=device_mod.DEVICES, default="cuda",
                    help="Where to train (default: the card; raises without one)")
    args = ap.parse_args(argv)
    configure()
    dev = device_mod.resolve(args.device)
    nsnet2_train.check_tier()
    devices = grid_devices(dev)
    m = mesh_lib.data_model_mesh(args.tp, devices) if len(devices) > 1 or args.tp > 1 else None
    if m is not None:
        dp = m.shape["data"]
        if args.batch % dp:
            args.batch = mesh_lib.pad_batch(args.batch, m)
            log.info("rounded batch up to %d (data axis %d)", args.batch, dp)
        dev = m.grid[0][0]

    net = nsnet2_train.trainable(nsnet2.init_params(torch.Generator().manual_seed(args.seed)).to(dev))
    if m is not None:
        net = nsnet2_train.shard_params(net, m)
    opt = torch.optim.Adam(net.parameters(), lr=args.lr)
    step_fn = nsnet2_train.make_train_step(opt, net, m)

    start_step = 0
    if args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            checkpoint.load_train_state(args.ckpt_dir, net, opt, latest)
            start_step = latest
            log.info("resumed from step %d", latest)

    if args.data:
        examples = load_pairs(args.data, args.frames)
        pool = tuple(torch.from_numpy(np.stack(c)) for c in zip(*examples))
        log.info("loaded %d training windows", len(examples))
    elif args.synthetic > 0:
        # A fixed pool of N synthetic examples (not fresh data per step).
        pool = nsnet2_train.synth_batch(torch.Generator().manual_seed(args.seed), args.synthetic, args.frames)
        log.info("generated %d synthetic training windows", args.synthetic)
    elif args.eval and args.steps <= start_step:
        pool = None  # eval-only invocation: no training batches needed
    else:
        ap.error("provide --data DIR or --synthetic N")

    def batch_idx(i):
        # Seeded per STEP, as the JAX CLI draws them: a resumed run draws the
        # same batch sequence from start_step on as an uninterrupted run.
        return np.random.default_rng((args.seed, i)).integers(0, pool[0].shape[0], args.batch)

    steps = range(start_step, args.steps)
    # On a grid each data row's examples go to its first device, which
    # computes the row's loss (its other columns get the features in the step).
    homes = [row[0] for row in m.grid] if m is not None else [dev]
    per = args.batch // len(homes)
    if args.device_data and len(steps):
        # One-time staging of the pool and of every step's indices, on each
        # distinct device that takes a row's batch; each step gathers its
        # batch there.
        staged = {d: tuple(x.to(d) for x in pool) for d in dict.fromkeys(homes)}
        order = torch.from_numpy(np.stack([batch_idx(i) for i in steps]))
        orders = [order[:, r * per:(r + 1) * per].contiguous().to(d) for r, d in enumerate(homes)]
        log.info("staged %d windows (%.0f MB) in device memory on %d device(s)", pool[0].shape[0],
                 sum(x.numel() * x.element_size() for x in pool) / 1e6, len(staged))

        def row_batches(i):
            return [tuple(c.index_select(0, o[i - start_step]) for c in staged[d]) for d, o in zip(homes, orders)]

    else:

        def row_batches(i):
            idx = torch.from_numpy(batch_idx(i))
            return [tuple(_upload(c.index_select(0, idx[r * per:(r + 1) * per]), d) for c in pool)
                    for r, d in enumerate(homes)]

    def get_batch(i):
        rows = row_batches(i)
        return rows if m is not None else rows[0]

    # Per step: the host clock from the batch's fetch to the step's return,
    # and on the card CUDA events around it; read once, after the loop. The
    # loop and its final synchronisation are one profiler range, "train_steps".
    losses, host_ms, events = [], [], []
    with torch.profiler.record_function("train_steps"):
        for i in steps:
            t0 = time.perf_counter()
            if dev.type == "cuda":
                events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            loss = step_fn(get_batch(i))
            if dev.type == "cuda":
                events[-1][1].record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            if i % 10 == 0 or i == args.steps - 1:
                log.info("step %d loss %.6f", i, float(loss))
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                checkpoint.save_train_state(args.ckpt_dir, net, opt, i + 1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    main.last_run = {
        "start_step": start_step,
        "steps": len(steps),
        "losses": torch.stack(losses).tolist() if losses else [],
        "host_ms": host_ms,
        "event_ms": [a.elapsed_time(b) for a, b in events],
        "grid": dict(m.shape) if m is not None else None,
        "batch": args.batch,
    }
    if m is not None:
        net = net.gather()  # unsharded, on the grid's first device
    for p in net.parameters():
        p.requires_grad_(False)

    # An eval-only invocation (no training steps ran) is a read-only scoring
    # run: it writes no weights unless --out is given.
    eval_only = args.eval and args.steps <= start_step
    out_path = args.out or (None if eval_only else "nsnet2_weights.npz")
    if out_path is not None:
        if out_path.endswith(".onnx"):
            from ..models import onnx_import

            with open(out_path, "wb") as f:
                f.write(onnx_import.export_nsnet2_onnx(net))
        else:
            nsnet2.save_npz(out_path, net)
        log.info("saved weights to %s", out_path)

    if args.eval:
        from ..eval import denoise_quality

        res = denoise_quality.evaluate(net, n_pairs=args.eval_pairs, seconds=args.eval_seconds, device=dev)
        print(json.dumps({"denoise_quality": res}), flush=True)
        log.info("held-out SI-SDR improvement: %.2f dB (n=%d)", res["mean_si_sdr_impr_db"], args.eval_pairs)
    return 0


main.last_run = None

if __name__ == "__main__":
    sys.exit(main())
