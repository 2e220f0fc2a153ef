"""Multiplexed streaming daemon — N radios in one process, one device batch
(port of ``formula_vad_tpu/apps/multidaemon.py``).

The reference daemon (src/main.zig) serves exactly one stream per process.
This daemon multiplexes the same newline-JSON protocol over N named streams
and runs their device compute through ONE batched step per 0.5 s tick
(``parallel.online.OnlineBatchServer.tick_pending``): kernels 1 and 2 once
a tick for the whole fleet.

Protocol (the reference's, plus a required ``stream`` field):

* stdin:  ``{"action": "segment", "stream": NAME, "file_path": ...,
  "playhead_timestamp_ms": ...}`` and
  ``{"action": "skip_segment", "stream": NAME}`` (silence of the previous
  segment's length, preserving sample continuity — main.zig:283-301).
* stdout: the reference's ``recording``/``error`` events, each carrying a
  ``stream`` field; recordings land under ``OUTDIR/<stream>/``.
* ``{"action": "stats"}`` (fleet-level, no ``stream``) emits one ``stats``
  event: tick latencies vs the 0.5 s budget
  (``OnlineBatchServer.tick_stats``), dropped streams, commands processed.

Streams feed at their own pace. Every sample — trailing sub-chunk tails
included — lands in the stream's ring at once (``pipeline.buffer_samples``),
so deferred recording stops finalize at the same sample a solo daemon
would; a device tick then advances exactly the streams holding at least
one full unprocessed chunk, freezing the rest on the card.

Usage:
  python -m formula_vad_tpu_torch.apps.multidaemon -o OUTDIR -n NAME \
      --streams perez,sainz,alonso [--denoiser MODEL] [--precision P] \
      [--state DIR [--checkpoint-every N]] [--device cuda|cpu]

``--state DIR`` persists the whole fleet on exit and resumes it at start-up
(the batched carries, every stream's rings and recorders, playhead
correlation and dropped-stream containment), crash-atomically, in
generations behind a ``LATEST`` pointer; ``--checkpoint-every N`` also
saves every N commands and acknowledges each save once it is durable.
The fleet runs on the card unless ``--device cpu`` is given. ``--denoiser``
takes the solo daemon's specs: NSNet2 weights (``.npz`` or ``.onnx``),
``demo``, ``random`` or ``spectral_gate[:quantile,alpha,floor]``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

from ..config import PipelineConfig, VADConfig
from ..io_.audio import AudioBuffer
from ..models.registry import load_denoiser
from ..parallel.online import OnlineBatchServer
from ..pipeline.pipeline import Callbacks
from .daemon import (
    DENOISER_ERRORS, add_common_arguments, apply_common_arguments, fatal_event, load_segment_audio,
    recording_event,
)


class MultiDaemon:
    def __init__(
        self,
        name: str,
        out_dir: str,
        streams: list[str],
        denoiser_path: str | None = None,
        stdout=None,
        state_dir: str | None = None,
        checkpoint_every: int = 0,
        device: str | torch.device = "cuda",
    ):
        if len(set(streams)) != len(streams) or not streams:
            raise ValueError("streams must be a non-empty list of unique names")
        self.name = name
        self.out_dir = out_dir
        self.stdout = stdout or sys.stdout
        self.streams = list(streams)
        self.index = {s: i for i, s in enumerate(self.streams)}
        b = len(streams)

        config = PipelineConfig(
            sample_rate=48000,
            n_channels=2,
            buffer_length=48000 * 10,
            vad_config=VADConfig(denoiser_model_path=denoiser_path),
        )
        self.config = config
        callbacks = [
            Callbacks(
                on_original_recording=lambda buf, i=i: self._on_recording(i, buf, "original"),
                on_denoised_recording=lambda buf, i=i: self._on_recording(i, buf, "denoised"),
            )
            for i in range(b)
        ]
        for s in streams:
            os.makedirs(os.path.join(out_dir, s), exist_ok=True)
        self.server = OnlineBatchServer(
            config, b, params=load_denoiser(denoiser_path, device=device), callbacks=callbacks
        )
        self.chunk = self.server.chunk_size

        # Per-stream playhead correlation (main.zig ProcessLoopState).
        self.correlated_sample_index = [0] * b
        self.correlated_timestamp_ms = [0] * b
        self.last_segment_length = [0] * b
        # Streams dropped after a per-stream fatal error (sample-rate
        # mismatch). A solo daemon exits there (main.zig:259-270); with N
        # multiplexed streams that would amplify one bad file's blast radius
        # from one stream to all N, so the fatal is contained: the stream is
        # dropped (its state frozen), the other N-1 keep serving.
        self.dropped: set[str] = set()
        self.state_dir = state_dir
        self.checkpoint_every = int(checkpoint_every)
        if self.checkpoint_every and not state_dir:
            raise ValueError("--checkpoint-every requires --state DIR")
        self.commands_processed = 0
        self._generation = 0

    # ---- failover state (beyond the reference, like the solo --state) ------
    #
    # Checkpoints are CRASH-ATOMIC: every save lands in a fresh generation
    # directory (written to a staging dir, renamed when complete) and a
    # LATEST pointer file is flipped last via os.replace. A SIGKILL at any
    # instant leaves either the previous complete generation or the new one
    # — never a torn mix. ``commands_processed`` in the metadata is the
    # durable replay point: a supervisor re-feeds stdin lines from that
    # index on after a crash (tests/test_failover_kill.py).

    def save_state(self) -> None:
        """Persist the batched device carries, every stream's host pipeline
        state, and the multiplexer's per-stream protocol state, so a
        restarted multidaemon resumes all N streams bit-identically —
        including playhead correlation and dropped-stream containment."""
        base = self.state_dir
        stage = os.path.join(base, f".stage-{os.getpid()}")
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        self.server.save_state(stage)
        with open(os.path.join(stage, "multidaemon.json"), "w") as f:
            json.dump(
                {
                    "streams": self.streams,
                    "correlated_sample_index": self.correlated_sample_index,
                    "correlated_timestamp_ms": self.correlated_timestamp_ms,
                    "last_segment_length": self.last_segment_length,
                    "dropped": sorted(self.dropped),
                    "commands_processed": self.commands_processed,
                },
                f,
            )
        self._generation += 1
        gen_name = f"gen-{self._generation:08d}-{os.getpid()}"
        os.rename(stage, os.path.join(base, gen_name))
        tmp_ptr = os.path.join(base, f".latest-{os.getpid()}")
        with open(tmp_ptr, "w") as f:
            f.write(gen_name)
        os.replace(tmp_ptr, os.path.join(base, "LATEST"))  # the commit point
        for entry in os.listdir(base):
            # Prune superseded generations AND orphaned staging dirs: a
            # crash mid-save leaves a full-size .stage-<oldpid> that a
            # restarted process (new PID) would otherwise never clean —
            # each crash/restart cycle would leak a fleet-sized directory
            # in the state dir of the crash-recovery feature itself. Our
            # own in-progress stage was just renamed away, so any .stage-*
            # here is stale (or belongs to a second fleet misconfigured to
            # share a state dir — also safe: it re-stages on its next save).
            if (entry.startswith("gen-") and entry != gen_name) or entry.startswith(
                ".stage-"
            ):
                shutil.rmtree(os.path.join(base, entry), ignore_errors=True)

    def _resume_dir(self) -> str | None:
        """The generation directory the LATEST pointer names, if it holds a
        complete checkpoint."""
        ptr = os.path.join(self.state_dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            gen = os.path.join(self.state_dir, f.read().strip())
        return gen if os.path.exists(os.path.join(gen, "multidaemon.json")) else None

    def load_state(self) -> None:
        directory = self._resume_dir()
        if directory is None:
            raise ValueError(f"no checkpoint found under {self.state_dir}")
        with open(os.path.join(directory, "multidaemon.json")) as f:
            meta = json.load(f)
        if meta["streams"] != self.streams:
            raise ValueError(
                f"state checkpoint serves streams {meta['streams']}, "
                f"this daemon serves {self.streams}"
            )
        self.server.load_state(directory)
        self.correlated_sample_index = list(meta["correlated_sample_index"])
        self.correlated_timestamp_ms = list(meta["correlated_timestamp_ms"])
        self.last_segment_length = list(meta["last_segment_length"])
        self.dropped = set(meta["dropped"])
        self.commands_processed = int(meta.get("commands_processed", 0))
        self._generation = int(os.path.basename(directory).split("-")[1])

    # ---- output ------------------------------------------------------------

    def _emit(self, obj: dict) -> None:
        self.stdout.write(json.dumps(obj) + "\n")
        self.stdout.flush()

    def report_error(self, message: str, fatal: bool, stream: str | None = None) -> None:
        ev = {"action": "error", "message": message, "fatal": fatal}
        if stream is not None:
            ev["stream"] = stream
        self._emit(ev)

    def _on_recording(self, i: int, buf: AudioBuffer, kind: str) -> None:
        stream = self.streams[i]
        path = os.path.join(self.out_dir, stream, f"{buf.global_start_frame_number}-{kind}.wav")
        try:
            buf.save_to_file(path)
        except OSError as e:
            self.report_error(f"Error saving audio file: {e}. Path: {path}", False, stream)
            return
        if kind != "original":  # only originals are announced (main.zig:367-370)
            return
        self._emit(
            recording_event(
                self.name, buf, path,
                self.correlated_sample_index[i], self.correlated_timestamp_ms[i],
                extra={"stream": stream},
            )
        )

    # ---- ingestion ---------------------------------------------------------

    def _buffer_and_tick(self, i: int, samples: np.ndarray) -> int:
        """Feed samples into stream i's ring in the solo path's capacity/2
        slabs, ticking the batched device step between slabs; returns the
        absolute index of the first sample."""
        p = self.server.pipelines[i]
        slab = p.original_ring.capacity // 2
        first_index = None
        pos = 0
        n = samples.shape[1]
        while pos < n or first_index is None:
            part = samples[:, pos : pos + slab]
            pos += part.shape[1]
            idx = p.buffer_samples(part)
            if first_index is None:
                first_index = idx
            while self.server.tick_pending():
                pass
        return first_index

    # ---- commands ----------------------------------------------------------

    def process_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        self._dispatch(line)
        # Every non-blank stdin line counts toward the durable replay point
        # (malformed ones included) so a supervisor's "re-feed lines[k:]"
        # replay is exact. The checkpoint ack is emitted only AFTER the
        # save completes — it is the durability acknowledgement.
        self.commands_processed += 1
        if self.checkpoint_every and (
            self.commands_processed % self.checkpoint_every == 0
        ):
            self.save_state()
            self._emit(
                {"action": "checkpoint",
                 "commands_processed": self.commands_processed}
            )

    def _dispatch(self, line: str) -> None:
        try:
            cmd = json.loads(line)
        except json.JSONDecodeError as e:
            self.report_error(f"Error parsing command JSON: {e}. Line: {line}", False)
            return
        if cmd.get("action") == "stats":
            # Fleet-level observability (beyond the reference's protocol;
            # solo daemon stays byte-exact): tick latencies vs the 0.5 s
            # budget plus multiplexer counters. No "stream" field needed.
            self._emit(
                {
                    "action": "stats",
                    **self.server.tick_stats(),
                    "dropped": sorted(self.dropped),
                    "commands_processed": self.commands_processed,
                }
            )
            return
        stream = cmd.get("stream")
        if stream not in self.index:
            self.report_error(
                f"Unknown or missing stream {stream!r} (serving {self.streams}). "
                f"Command: {cmd}",
                False,
            )
            return
        if stream in self.dropped:
            self.report_error(
                f"Stream {stream!r} was dropped after a fatal error; "
                f"command ignored: {cmd}",
                False,
                stream,
            )
            return
        i = self.index[stream]
        action = cmd.get("action")
        if action == "segment":
            self._process_segment(i, cmd)
        elif action == "skip_segment":
            self._process_skip(i)
        else:
            self.report_error(f"Unknown action: {action}", False, stream)

    def _process_segment(self, i: int, cmd: dict) -> None:
        stream = self.streams[i]
        try:
            buffer, playhead = load_segment_audio(
                cmd,
                self.config,
                lambda m, f: self.report_error(m, f, stream),
                lambda: self._process_skip(i),
            )
        except SystemExit:
            # The fatal error event (fatal=True, stream-tagged) was already
            # emitted by load_segment_audio; contain the exit to this stream.
            self.dropped.add(stream)
            return
        if buffer is None:
            return
        # Reference ordering (main.zig:273-281): the correlation updates
        # AFTER the push completes, so recordings fired while processing
        # THIS file still use the previous correlation point.
        first_idx = self._buffer_and_tick(i, buffer.channel_pcm)
        self.correlated_sample_index[i] = first_idx
        self.correlated_timestamp_ms[i] = playhead
        self.last_segment_length[i] = buffer.length

    def _process_skip(self, i: int) -> None:
        self._buffer_and_tick(
            i, np.zeros((self.config.n_channels, self.last_segment_length[i]), np.float32)
        )

    def run(self, stdin=None) -> int:
        if self.state_dir and self._resume_dir() is not None:
            try:
                self.load_state()
            except (ValueError, OSError, KeyError) as e:
                # FATAL: a checkpoint exists but cannot be resumed (wrong
                # --streams list, truncated npz, ...). Serving with fresh
                # state would clobber the checkpoint with it on exit,
                # irrecoverably destroying the fleet state the --state
                # feature exists to preserve. Refuse instead; the operator
                # fixes the flags (or removes the state dir) and restarts.
                self.report_error(f"Could not resume state: {e}", True)
                return 1
        stdin = stdin or sys.stdin
        try:
            for line in stdin:
                self.process_line(line)
        finally:
            if self.state_dir:
                try:
                    self.save_state()
                except OSError as e:
                    self.report_error(f"Could not save state: {e}", False)
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Multiplexed Formula-VAD daemon.")
    ap.add_argument("-o", "--outdir", required=True, help="Output directory")
    ap.add_argument("-n", "--name", required=True, help="Daemon name for events")
    ap.add_argument(
        "--streams", required=True,
        help="Comma-separated stream names (one VAD state per stream)",
    )
    add_common_arguments(ap)
    ap.add_argument(
        "--state", default=None,
        help="State checkpoint directory: resumed at startup, written on "
             "exit (all N streams, bit-identical — incl. playhead "
             "correlation and dropped-stream containment)",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="Also checkpoint --state crash-atomically every N stdin "
             "commands, emitting a {\"action\": \"checkpoint\", "
             "\"commands_processed\": k} ack once durable; a supervisor "
             "replays stdin from the last acked k after a crash",
    )
    args = ap.parse_args(argv)
    device = apply_common_arguments(args)

    def fatal(message: str) -> int:
        sys.stdout.write(fatal_event(message))
        return 2

    if not os.path.isdir(args.outdir) or not os.access(args.outdir, os.W_OK):
        return fatal(f"Output directory {args.outdir} isn't writeable")
    if args.state:
        os.makedirs(args.state, exist_ok=True)
    try:
        daemon = MultiDaemon(
            args.name, args.outdir, [s for s in args.streams.split(",") if s],
            args.denoiser, state_dir=args.state,
            checkpoint_every=args.checkpoint_every, device=device,
        )
    except DENOISER_ERRORS as e:
        return fatal(f"Could not start multidaemon: {e}")
    return daemon.run()


if __name__ == "__main__":
    sys.exit(main())
