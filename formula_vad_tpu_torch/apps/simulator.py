"""Batch evaluation harness — the port's ``simulator`` executable (port of
``formula_vad_tpu/apps/simulator.py``).

Reads a plan JSON (``{"instances": [{name, audio_path, ref_path}],
"config": {...}}``), scores every recording in one batched device pass
(``parallel.runner.BatchRunner``) or, for ``use_slabs`` plans and batches
above ``SLAB_AUTO_BYTES`` of float32 audio, slab by slab at constant device
memory (``parallel.slab_runner.SlabRunner``), both sharding the streams over
every visible card (``parallel/mesh.py``; ``--device cpu`` keeps the one
CPU); a ``"batch_streams": false``
plan runs the streams one after the other through the host streaming
pipeline (``pipeline.pipeline.AudioPipeline``), whose recorders save the
clips. It compares against the Audacity reference
labels, writes per-instance Audacity txts, per-segment clips and
report.txt into a timestamped output directory, and prints the report.

Usage: python -m formula_vad_tpu_torch.apps.simulator -i plan.json [--device cuda|cpu]
[--precision highest|high|default] [--io-dtype f32|bf16]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .. import device as device_mod
from ..config import SIMULATOR_STAT_CONFIG, PipelineConfig, SimConfig, StatConfig, sim_config_from_dict
from ..eval import SpeechSegment, formats, init_and_run, report
from ..io_ import AudioSource, ogg
from ..io_ import native as io_native
from ..io_.wav import write_wav
from ..models.registry import load_denoiser
from ..ops import precision
from ..parallel.runner import BatchRunner
from ..parallel.slab_runner import SlabRunner
from ..pipeline import offline
from ..pipeline.pipeline import AudioPipeline, Callbacks

log = logging.getLogger("fvad.simulator")
F32 = np.float32
SLAB_AUTO_BYTES = 2 << 30  # above this padded float32 batch size plans run slab by slab


@dataclasses.dataclass
class Instance:
    name: str
    audio_path: str
    ref_path: str
    out_dir: str | None = None
    reference_segments: list | None = None
    vad_segments: list | None = None  # raw dicts from the runner
    alt_vad_segments: list | None = None  # one list an alternative machine config (batched plans)
    evaluator: object | None = None


def load_plan(plan_path: str):
    base = os.path.dirname(os.path.abspath(plan_path)) or "."
    with open(plan_path) as f:
        plan_text = f.read()
    plan = json.loads(plan_text)
    config = sim_config_from_dict(plan.get("config", {}))
    instances = [
        Instance(
            name=inst["name"],
            audio_path=os.path.join(base, inst["audio_path"]),
            ref_path=os.path.join(base, inst["ref_path"]),
        )
        for inst in plan["instances"]
    ]
    return instances, config, base, plan_text


def vad_segments_to_eval(segments: list[dict], sample_rate: int) -> list[SpeechSegment]:
    """Runner segments -> evaluation segments (f32 seconds, debug note)."""
    return [
        SpeechSegment(
            from_sec=float(F32(s["sample_from"]) / F32(sample_rate)),
            to_sec=float(F32(s["sample_to"]) / F32(sample_rate)),
            side="vad",
            debug_info=f"vr:{s['avg_channel_vol_ratio']:.2f} vad:{s['vad_met_sec']:.1f}s",
        )
        for s in segments
    ]


def _clip_writer(config: SimConfig):
    """recording_format -> (extension, write(path, planar, rate)); Ogg Vorbis
    falls back to float32 WAV when the system codec is unavailable."""
    fmt = config.recording_format
    if fmt == "ogg" and not ogg.available():
        log.warning("recording_format=ogg but the Vorbis codec is unavailable; saving WAV")
        fmt = "wav"
    if fmt == "ogg":
        return ".ogg", lambda path, data, rate: ogg.write_ogg(path, data, rate, 1.0)
    return ".wav", lambda path, data, rate: write_wav(path, data, rate)


def _save_clips(
    net: torch.nn.Module, inst: Instance, read_span, total_len: int, n_chunks: int, chunk: int, config: SimConfig
) -> None:
    """Save each segment's original and denoised clip (quietest channel).

    An original clip exists iff the segment ends inside the stream, a
    denoised one iff it ends inside the processed (whole-chunk) part. The
    denoised clip is recomputed by ``offline.denoise_span``."""
    processed_end = n_chunks * chunk
    ext, write = _clip_writer(config)
    for seg in inst.vad_segments or []:
        a, b = seg["sample_from"], seg["sample_to"]
        clips = []
        if b <= total_len:
            clips.append(("original", read_span(a, b)))
        if b <= processed_end:
            ka, kb = a // chunk, (b + chunk - 1) // chunk
            k0 = max(0, ka - offline.WARMUP_CHUNKS)
            span = torch.from_numpy(np.ascontiguousarray(read_span(k0 * chunk, kb * chunk), np.float32))
            with torch.inference_mode():
                den = offline.denoise_span(net, span.to(device_mod.model_device(net)), ka - k0, kb - k0)
            clips.append(("denoised", den.float().cpu().numpy()[:, a - ka * chunk : b - ka * chunk]))
        for kind, data in clips:
            data = np.ascontiguousarray(data, np.float32)
            rms = io_native.rms_per_channel(data)
            if rms is None:
                rms = np.sqrt(np.mean(data.astype(np.float64) ** 2, axis=1))
            best = int(np.argmin(rms))
            write(os.path.join(inst.out_dir, f"{a}-{kind}{ext}"), data[best : best + 1], 48000)


def run_batched(instances: list[Instance], config: SimConfig, device: torch.device) -> None:
    net = load_denoiser(config.vad_config.denoiser_model_path, device=device)
    srcs, lengths = [], []
    try:
        for inst in instances:
            src = AudioSource.open_stream(inst.audio_path)
            srcs.append(src)
            if src.sample_rate != 48000:
                raise ValueError(f"{inst.name}: sample rate {src.sample_rate} != 48000")
            if src.n_channels != 2:
                raise ValueError(f"{inst.name}: {src.n_channels} channels != pipeline's 2")
            lengths.append(src.n_frames)
        _run_batched_srcs(instances, config, net, srcs, lengths)
    finally:
        for src in srcs:
            src.close()


def _run_batched_srcs(instances, config, net, srcs, lengths) -> None:
    max_t = max(lengths)
    n_ch = srcs[0].n_channels
    use_slabs = config.use_slabs
    if use_slabs is None:
        use_slabs = len(srcs) * n_ch * max_t * 4 > SLAB_AUTO_BYTES
    if use_slabs:
        # Constant device memory: the streams stay on disk and the
        # prefetcher's worker pool reads them slab by slab. PCM16 WAV sources
        # travel as raw int16, half the bytes, dequantised on the card exactly.
        runner = SlabRunner(net, config.vad_config, slab_chunks=config.slab_chunks)
        raw16 = all(src.supports_raw16 for src in srcs)

        def mk_reader(src):
            def read(start, n):
                src.seek_to_sample(start)
                return src.read_raw16(n) if raw16 else src.read(n)

            return read

        results = runner.run_readers([mk_reader(s) for s in srcs], lengths, raw16=raw16)
    else:
        runner = BatchRunner(net, config.vad_config)
        chunk = runner.st.chunk_size
        pad_t = ((max_t + chunk - 1) // chunk) * chunk
        batch = np.zeros((len(srcs), n_ch, pad_t), np.float32)
        for i, src in enumerate(srcs):
            a = src.read(lengths[i])
            batch[i, :, : a.shape[1]] = a
        results = runner.run(batch, lengths)
    chunk = runner.st.chunk_size
    for inst, res, src, length in zip(instances, results, srcs, lengths):
        inst.vad_segments = res.segments
        inst.alt_vad_segments = res.alt_segments
        if inst.out_dir:

            def read_span(a, b, src=src):
                src.seek_to_sample(a)
                return src.read(b - a)

            _save_clips(net, inst, read_span, length, length // chunk, chunk, config)


def run_streaming(instances: list[Instance], config: SimConfig, device: torch.device) -> None:
    """The streams one after the other through the host streaming pipeline
    on ``device``; each recording goes to ``{global start frame}-{original
    or denoised}{ext}`` in the instance's output directory."""
    net = load_denoiser(config.vad_config.denoiser_model_path, device=device)
    for inst in instances:
        callbacks = Callbacks()
        if inst.out_dir:
            ext, write = _clip_writer(config)

            def on_rec(buf, kind, out_dir=inst.out_dir):
                write(os.path.join(out_dir, f"{buf.global_start_frame_number}-{kind}{ext}"), buf.channel_pcm, buf.sample_rate)

            callbacks = Callbacks(
                on_original_recording=lambda b: on_rec(b, "original"),
                on_denoised_recording=lambda b: on_rec(b, "denoised"),
            )
        src = AudioSource.preload(inst.audio_path) if config.preload_audio else AudioSource.open_stream(inst.audio_path)
        try:
            pipe = AudioPipeline(
                PipelineConfig(sample_rate=src.sample_rate, n_channels=src.n_channels, vad_config=config.vad_config),
                net, callbacks,
            )
            if config.preload_audio:
                pipe.push_samples(src.read_all())
            else:
                while True:
                    frames = src.read(config.audio_read_frame_count)
                    if frames.shape[1] == 0:
                        break
                    pipe.push_samples(frames)
        finally:
            src.close()
        inst.vad_segments = pipe.segments


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the VAD simulation plan.")
    ap.add_argument("-i", "--input", required=True, help="Simulation plan (path to JSON)")
    ap.add_argument(
        "--device", choices=device_mod.DEVICES, default="cuda",
        help="Device to score on (default cuda; raises when no GPU is visible)",
    )
    ap.add_argument(
        "--precision", choices=("highest", "high", "default"), default=None,
        help="Matmul precision: 'highest' = full-f32 parity (the default); 'high' = bf16_3x products "
        "(~16 bits a product); 'default' = single-pass bf16 operands with float32 sums (the bf16 tier); "
        "both can shift a boundary by a window",
    )
    ap.add_argument(
        "--io-dtype", choices=("f32", "bf16"), default=None,
        help="Activation storage dtype: 'bf16' stores the denoiser's activations in bf16 (the bf16_io "
        "tier; decisions can shift by a window)",
    )
    args = ap.parse_args(argv)
    device = device_mod.resolve(args.device)
    if args.precision:
        precision.set_matmul_precision(args.precision)
    if args.io_dtype:
        precision.set_io_dtype(args.io_dtype)

    instances, config, base, plan_text = load_plan(args.input)

    # Timestamped output dir + verbatim plan copy; a second run in the same
    # second gets a suffix instead of overwriting the first.
    resolved_out = None
    if config.output_dir:
        stamp = int(time.time())
        for suffix in range(1000):
            resolved_out = os.path.join(base, config.output_dir, str(stamp) if suffix == 0 else f"{stamp}-{suffix}")
            try:
                os.makedirs(resolved_out, exist_ok=False)
                break
            except FileExistsError:
                continue
        else:
            raise RuntimeError(f"could not allocate an output dir under {stamp}")
        with open(os.path.join(resolved_out, "plan.json"), "w") as f:
            f.write(plan_text)
        for inst in instances:
            inst.out_dir = os.path.join(resolved_out, inst.name)
            os.makedirs(inst.out_dir, exist_ok=True)

    for inst in instances:
        with open(inst.ref_path) as f:
            inst.reference_segments = formats.parse_audacity_segments(f.read(), side="ref")

    (run_batched if config.batch_streams else run_streaming)(instances, config, device)

    evaluators = []
    for inst in instances:
        inst.evaluator = init_and_run(vad_segments_to_eval(inst.vad_segments or [], 48000), inst.reference_segments)
        evaluators.append(inst.evaluator)
        if resolved_out:
            txt = formats.serialize_evaluator_to_audacity_txt(inst.evaluator)
            with open(os.path.join(resolved_out, f"{inst.name}-audacity.txt"), "w") as f:
                f.write(txt)

    stat_config = StatConfig(
        ignore_shorter_than_sec=config.vad_config.vad_machine_config.min_vad_duration_sec,
        extrude_start=SIMULATOR_STAT_CONFIG.extrude_start,
        extrude_end=SIMULATOR_STAT_CONFIG.extrude_end,
        fill_gaps=SIMULATOR_STAT_CONFIG.fill_gaps,
    )
    txt = report.simulation_report([i.name for i in instances], evaluators, stat_config)
    sys.stdout.write(txt)
    if resolved_out:
        with open(os.path.join(resolved_out, "report.txt"), "w") as f:
            f.write(txt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
