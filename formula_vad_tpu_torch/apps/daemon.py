"""Long-running stdin/stdout JSON daemon — the ``formula-vad`` executable
(port of ``formula_vad_tpu/apps/daemon.py``; src/main.zig:88-419).

Protocol (newline-delimited JSON):

* stdin commands: ``{"action": "segment", "file_path": ..., "playhead_timestamp_ms": ...}``
  pushes a decoded audio file into the pipeline;
  ``{"action": "skip_segment"}`` pushes silence of the previous segment's
  length to keep sample indices continuous (main.zig:283-301).
* stdout events: ``{"action": "recording", "name", "file_path",
  "playhead_timestamp_ms", "duration_ms", "speech_duration_ms"}`` when a
  speech clip has been saved (main.zig:45-52, 328-408), and
  ``{"action": "error", "message", "fatal"}`` for errors (main.zig:54-59).

Recordings are written as ``{start_frame}-original.wav`` /
``{start_frame}-denoised.wav`` (float32 WAV, like the reference's daemon
mode). Hardcoded: 48 kHz stereo, 10 s ring buffers (main.zig:135-142).
``--state PATH`` resumes a checkpoint at start-up and writes one on exit.
The pipeline runs on the card unless ``--device cpu`` is given; without a
visible GPU ``--device cuda`` (the default) raises. ``--denoiser`` takes
NSNet2 weights (``.npz`` or ``.onnx``), ``demo``, ``random`` or the
weights-free ``spectral_gate[:quantile,alpha,floor]``; a spec the port
cannot load (a malformed spec, a missing or unreadable file) is a fatal
start-up error.

Usage: python -m formula_vad_tpu_torch.apps.daemon -o OUTDIR -n NAME [--denoiser MODEL] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import device as device_mod
from ..config import PipelineConfig, VADConfig
from ..io_.audio import AudioBuffer
from ..models.registry import load_denoiser
from ..ops import precision
from ..pipeline.pipeline import AudioPipeline, Callbacks

# A denoiser spec that load_denoiser refuses: malformed or unsupported
# (ValueError), or a weights file it cannot read (OSError).
DENOISER_ERRORS = (ValueError, OSError)


def recording_event(
    name: str,
    buf: AudioBuffer,
    path: str,
    correlated_sample_index: int,
    correlated_timestamp_ms: int,
    extra: dict | None = None,
) -> dict:
    """The reference's OutRecordingJSON (main.zig:45-52, 370-394): playhead
    correlation via signed truncating division, and the approximate
    speech_duration_ms = duration - 3500 ms. Shared by the solo daemon and
    the multiplexed daemon so the math lives in exactly one place."""
    duration_ms = int(buf.duration_seconds * 1000)
    samples_since = buf.global_start_frame_number - correlated_sample_index
    ms_since = (1000 * samples_since) // buf.sample_rate if samples_since >= 0 else -(
        (1000 * -samples_since) // buf.sample_rate
    )
    ev = {
        "action": "recording",
        "name": name,
        "file_path": path,
        "playhead_timestamp_ms": correlated_timestamp_ms + ms_since,
        "duration_ms": duration_ms,
        "speech_duration_ms": duration_ms - min(duration_ms, 3500),
    }
    if extra:
        ev.update(extra)
    return ev


def load_segment_audio(cmd: dict, config, report_error, on_channel_mismatch):
    """Validate and load a ``segment`` command's audio file with the
    reference's exact error semantics (main.zig:216-270): distinct
    missing-field messages, non-fatal load/channel errors (the latter via
    ``on_channel_mismatch`` — a skip_segment for continuity), and a FATAL
    sample-rate mismatch (SystemExit). Returns (AudioBuffer, playhead) or
    (None, None)."""
    file_path = cmd.get("file_path")
    playhead = cmd.get("playhead_timestamp_ms")
    if file_path is None:
        report_error(f"Missing file_path in command: {cmd}", False)
        return None, None
    if playhead is None:
        report_error(f"Missing playhead_timestamp_ms in command: {cmd}", False)
        return None, None
    # Typed-JSON parse errors are non-fatal protocol errors in the reference
    # (main.zig's typed command struct); without these checks a string
    # playhead poisons correlated_timestamp_ms (TypeError hours later inside
    # a recording callback) and an int file_path would make open() treat it
    # as a raw fd.
    if not isinstance(file_path, str):
        report_error(f"file_path must be a string in command: {cmd}", False)
        return None, None
    if isinstance(playhead, bool) or not isinstance(playhead, (int, float)):
        report_error(
            f"playhead_timestamp_ms must be a number in command: {cmd}", False
        )
        return None, None
    try:
        buffer = AudioBuffer.load_from_file(file_path)
    except (OSError, ValueError, RuntimeError) as e:
        # RuntimeError: Ogg input on a host without the Vorbis codec —
        # non-fatal like any other undecodable file (the loop continues).
        report_error(f"Error loading audio file: {e}. Command: {cmd}", False)
        return None, None
    if buffer.n_channels != config.n_channels:
        report_error(
            f"Audio file has {buffer.n_channels} channels, but pipeline has "
            f"{config.n_channels} channels. Command: {cmd}",
            False,
        )
        # Possibly transient: keep continuity (main.zig:242-257).
        on_channel_mismatch()
        return None, None
    if buffer.sample_rate != config.sample_rate:
        report_error(
            f"Audio file has SR of {buffer.sample_rate}, but pipeline has SR of "
            f"{config.sample_rate}. Command: {cmd}",
            True,
        )
        raise SystemExit(1)  # fatal (main.zig:259-270)
    return buffer, playhead


class Daemon:
    def __init__(self, name: str, out_dir: str, denoiser_path: str | None,
                 stdout=None, state_path: str | None = None,
                 device: str | torch.device = "cuda"):
        self.name = name
        self.out_dir = out_dir
        self.state_path = state_path
        self.stdout = stdout or sys.stdout
        self.correlated_sample_index = 0
        self.correlated_timestamp_ms = 0
        self.last_segment_length = 0
        config = PipelineConfig(
            sample_rate=48000,
            n_channels=2,
            buffer_length=48000 * 10,
            vad_config=VADConfig(denoiser_model_path=denoiser_path),
        )
        self.pipeline = AudioPipeline(
            config,
            net=load_denoiser(denoiser_path, device=device),
            callbacks=Callbacks(
                on_original_recording=lambda b: self._on_recording(b, "original"),
                on_denoised_recording=lambda b: self._on_recording(b, "denoised"),
            ),
        )

    # ---- output ------------------------------------------------------------

    def _emit(self, obj: dict) -> None:
        self.stdout.write(json.dumps(obj) + "\n")
        self.stdout.flush()

    def report_error(self, message: str, fatal: bool) -> None:
        self._emit({"action": "error", "message": message, "fatal": fatal})

    def _on_recording(self, buf: AudioBuffer, kind: str) -> None:
        filename = f"{buf.global_start_frame_number}-{kind}.wav"
        path = os.path.join(self.out_dir, filename)
        try:
            buf.save_to_file(path)
        except OSError as e:
            self.report_error(f"Error saving audio file: {e}. Path: {path}", False)
            return
        # Only original recordings are announced (main.zig:367-370).
        if kind != "original":
            return
        self._emit(
            recording_event(
                self.name, buf, path,
                self.correlated_sample_index, self.correlated_timestamp_ms,
            )
        )

    # ---- commands ----------------------------------------------------------

    def process_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        try:
            cmd = json.loads(line)
        except json.JSONDecodeError as e:
            self.report_error(f"Error parsing command JSON: {e}. Line: {line}", False)
            return
        action = cmd.get("action")
        if action == "segment":
            self._process_segment(cmd)
        elif action == "skip_segment":
            self._process_skip()
        else:
            self.report_error(f"Unknown action: {action}", False)

    def _process_segment(self, cmd: dict) -> None:
        buffer, playhead = load_segment_audio(
            cmd, self.pipeline.config, self.report_error, self._process_skip
        )
        if buffer is None:
            return
        first_idx = self.pipeline.push_samples(buffer.channel_pcm)
        self.correlated_sample_index = first_idx
        self.correlated_timestamp_ms = playhead
        self.last_segment_length = buffer.length

    def _process_skip(self) -> None:
        silence = np.zeros(
            (self.pipeline.config.n_channels, self.last_segment_length), np.float32
        )
        self.pipeline.push_samples(silence)

    def run(self, stdin=None) -> int:
        # Resume mid-stream if a state checkpoint exists (no reference
        # equivalent — the reference loses all state on exit, SURVEY.md §5).
        if self.state_path and os.path.exists(self.state_path):
            try:
                self.pipeline.load_state(self.state_path)
            except (ValueError, OSError, KeyError) as e:
                # FATAL (same rule as multidaemon): a checkpoint exists but
                # cannot be resumed (truncated npz, changed --denoiser /
                # --io-dtype template). Serving with fresh state would
                # overwrite it in the finally block below, irrecoverably
                # destroying the state --state exists to preserve.
                self.report_error(f"Could not resume state: {e}", True)
                return 1
        stdin = stdin or sys.stdin
        try:
            for line in stdin:
                self.process_line(line)
        finally:
            if self.state_path:
                try:
                    self.pipeline.save_state(self.state_path)
                except OSError as e:
                    self.report_error(f"Could not save state: {e}", False)
        return 0


def fatal_event(message: str) -> str:
    """The daemon's fatal start-up error line."""
    return json.dumps({"action": "error", "message": message, "fatal": True}) + "\n"


def add_common_arguments(ap: argparse.ArgumentParser) -> None:
    """The arguments both daemons share beyond their own."""
    ap.add_argument(
        "--denoiser",
        default=None,
        help="Denoiser spec: path to NSNet2 weights (.onnx or .npz), 'demo' for the packaged weights "
        "(the default), 'random' for random-init, or 'spectral_gate[:quantile,alpha,floor]' for the "
        "weights-free classical gate",
    )
    ap.add_argument(
        "--precision", choices=("highest", "high", "default"), default=None,
        help="Matmul precision: 'highest' = full-f32 parity (the default); 'high' = bf16_3x; "
        "'default' = the bf16 tier",
    )
    ap.add_argument(
        "--io-dtype", choices=("f32", "bf16"), default=None,
        help="Activation storage dtype: 'bf16' is the bf16_io tier",
    )
    ap.add_argument(
        "--device", choices=device_mod.DEVICES, default="cuda",
        help="Device to serve on (default cuda; raises when no GPU is visible)",
    )


def apply_common_arguments(args) -> torch.device:
    """Resolve the device and set the tiers the arguments ask for."""
    device = device_mod.resolve(args.device)
    if args.precision:
        precision.set_matmul_precision(args.precision)
    if args.io_dtype:
        precision.set_io_dtype(args.io_dtype)
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Formula-VAD streaming daemon.")
    ap.add_argument("-o", "--outdir", required=True, help="Output directory")
    ap.add_argument("-n", "--name", required=True, help="Instance name for logging")
    add_common_arguments(ap)
    ap.add_argument(
        "--state", default=None,
        help="Path to a state checkpoint: resumed at startup, written on exit",
    )
    args = ap.parse_args(argv)
    device = apply_common_arguments(args)

    if not os.path.isdir(args.outdir) or not os.access(args.outdir, os.W_OK):
        sys.stdout.write(fatal_event(f"Output directory {args.outdir} isn't writeable"))
        return 2
    try:
        daemon = Daemon(args.name, args.outdir, args.denoiser, state_path=args.state, device=device)
    except DENOISER_ERRORS as e:
        sys.stdout.write(fatal_event(f"Could not load denoiser {args.denoiser!r}: {e}"))
        return 2
    return daemon.run()


if __name__ == "__main__":
    sys.exit(main())
