"""Host-side streaming AudioPipeline (port of
``formula_vad_tpu/pipeline/pipeline.py``).

The online counterpart of the batch runner: it wraps ``vad.chunk_step``,
run on the pipeline's device, with host state in numpy: pending-sample
buffering, ring buffers of the original and denoised audio, and
ring-aware recorders.

* ``push_samples`` takes planar PCM of any length, writes it in slabs of at
  most half the ring and runs the step once per complete unread 24,000-sample
  chunk.
* A recording's start may lie up to 2 s in the past (the start margin),
  served from the ring; its end lies 2 s in the future, so it is finalized
  once enough samples have arrived.
* A finalized recording keeps the quietest channel (the least engine
  noise) and goes to the callbacks as a mono AudioBuffer stamped with its
  global start frame.

Each chunk's outputs are read to the host once, for the events
(``_consume_chunk_output``). ``save_state``/``load_state`` checkpoint the
whole stream (carry, rings, counters and the recordings in flight,
``utils/checkpoint.py``).

``alt_vad_machine_configs`` (a parameter sweep) run K more state machines
over the same window stream, as 1 + K (stream, config) rows of the step's
one FSM scan (``vad.machines_of``), the primary machine first. Only their
segments are kept, one list a config in ``alt_segments``: they record
nothing, as in the JAX package. Their carry is part of the FSM carry, so a
checkpoint holds it. A server-managed pipeline takes none: the server runs
one machine a stream.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import model_device
from ..io_.audio import AudioBuffer
from ..utils import checkpoint
from . import fsm, fsm_cuda, vad


class RingBuffer:
    """N-channel ring buffer with monotonic absolute indexing."""

    def __init__(self, n_channels: int, capacity: int):
        self.data = np.zeros((n_channels, capacity), np.float32)
        self.capacity = capacity
        self.total_written = 0

    def write(self, samples: np.ndarray) -> None:
        n = samples.shape[1]
        if n >= self.capacity:
            # Keep only the tail, placed so absolute indexing stays aligned.
            tail = samples[:, -self.capacity :]
            pos = (self.total_written + n - self.capacity) % self.capacity
            k = self.capacity - pos
            self.data[:, pos:] = tail[:, :k]
            self.data[:, :pos] = tail[:, k:]
            self.total_written += n
            return
        pos = self.total_written % self.capacity
        end = pos + n
        if end <= self.capacity:
            self.data[:, pos:end] = samples
        else:
            k = self.capacity - pos
            self.data[:, pos:] = samples[:, :k]
            self.data[:, : end - self.capacity] = samples[:, k:]
        self.total_written += n

    def read(self, abs_from: int, abs_to: int) -> np.ndarray:
        """Read [abs_from, abs_to) by absolute sample index (must be resident)."""
        if abs_from < self.total_written - self.capacity or abs_to > self.total_written:
            raise IndexError(
                f"range [{abs_from}, {abs_to}) not resident (written {self.total_written}, capacity {self.capacity})"
            )
        idx = np.arange(abs_from, abs_to) % self.capacity
        return self.data[:, idx]


class StreamRecorder:
    """Ring-aware recorder with deferred finalization."""

    def __init__(self, ring: RingBuffer, sample_rate: int):
        self.ring = ring
        self.sample_rate = sample_rate
        self.recording = False
        self.start_index = 0
        self.buffer: Optional[np.ndarray] = None  # [C, n] accumulated
        self.stop_at: Optional[int] = None
        self.keep = True

    def start(self, from_sample: int) -> None:
        from_sample = max(from_sample, self.ring.total_written - self.ring.capacity)
        self.recording = True
        self.start_index = from_sample
        self.buffer = self.ring.read(from_sample, self.ring.total_written)
        self.stop_at = None

    def on_new_samples(self, samples: np.ndarray) -> Optional[AudioBuffer]:
        """Called after each ring write; appends and maybe finalizes."""
        if not self.recording:
            return None
        self.buffer = np.concatenate([self.buffer, samples], axis=1)
        if self.stop_at is not None and self.ring.total_written >= self.stop_at:
            return self._finalize()
        return None

    def stop(self, to_sample: int, keep: bool) -> Optional[AudioBuffer]:
        """Request stop at a (possibly future) absolute index."""
        if not self.recording:
            return None
        self.keep = keep
        if not keep:
            self.recording = False
            self.buffer = None
            return None
        self.stop_at = to_sample
        if self.ring.total_written >= to_sample:
            return self._finalize()
        return None  # deferred until the ring reaches to_sample

    def _finalize(self) -> Optional[AudioBuffer]:
        from ..io_ import native

        n_keep = self.stop_at - self.start_index
        data = np.ascontiguousarray(self.buffer[:, :n_keep], np.float32)
        self.recording = False
        self.buffer = None
        rms = native.rms_per_channel(data)
        if rms is None:
            rms = np.sqrt(np.mean(data.astype(np.float64) ** 2, axis=1))
        best = int(np.argmin(rms))  # the quietest channel: the least engine noise
        return AudioBuffer(
            channel_pcm=data[best : best + 1].copy(),
            sample_rate=self.sample_rate,
            global_start_frame_number=self.start_index,
        )


@dataclasses.dataclass
class Callbacks:
    on_original_recording: Optional[Callable[[AudioBuffer], None]] = None
    on_denoised_recording: Optional[Callable[[AudioBuffer], None]] = None
    on_segment: Optional[Callable[[dict], None]] = None  # each completed segment


def _to_host(out: vad.ChunkOutput) -> tuple:
    """(windows, window_valid, denoised) of one chunk as numpy: from the
    card, copied without waiting one by one and then waited for once."""
    tensors = (*out.windows, out.window_valid, out.denoised)
    cuda = [x for x in tensors if torch.is_tensor(x) and x.is_cuda]
    host = [x.to("cpu", non_blocking=True) if torch.is_tensor(x) and x.is_cuda else x for x in tensors]
    if cuda:
        torch.cuda.current_stream(cuda[0].device).synchronize()
    host = [x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in host]
    return fsm.WindowOutput(*host[:7]), host[7], host[8]


class AudioPipeline:
    """Streaming host pipeline for one audio stream."""

    def __init__(
        self,
        config: PipelineConfig,
        net=None,
        callbacks: Optional[Callbacks] = None,
        *,
        statics: Optional[vad.VADStatics] = None,
        server_managed: bool = False,
        device: str | torch.device = "cuda",
    ):
        """``net`` defaults to ``load_denoiser`` of the config's model on
        ``device`` (the card unless the caller asks for the CPU); a given
        net sets the device. ``server_managed=True`` keeps no carry of its
        own: the stream's device work runs in a shared batched step and its
        results arrive through ``ingest_processed_chunk`` or
        ``complete_chunk``. ``statics`` shares one VADStatics across many
        pipelines."""
        if server_managed and config.vad_config.alt_vad_machine_configs:
            raise ValueError("a server-managed pipeline runs one machine a stream: no alt_vad_machine_configs")
        self.config = config
        self.callbacks = callbacks or Callbacks()
        if net is None:
            from ..models.registry import load_denoiser

            net = load_denoiser(config.vad_config.denoiser_model_path, device=device)
        self.net = net
        self.device = model_device(net)
        self.st = statics if statics is not None else vad.statics_from_config(
            config.vad_config, config.sample_rate, config.n_channels
        )
        self.chunk_size = self.st.chunk_size
        # The primary machine and the alternatives stacked, or None.
        self._machines = vad.machines_of(self.st, config.vad_config)
        self.alt_segments: list[list[dict]] = [[] for _ in config.vad_config.alt_vad_machine_configs or ()]
        cap = config.resolved_buffer_length
        self.original_ring = RingBuffer(config.n_channels, cap)
        self.denoised_ring = RingBuffer(config.n_channels, cap)
        self.original_recorder = StreamRecorder(self.original_ring, config.sample_rate)
        self.denoised_recorder = StreamRecorder(self.denoised_ring, config.sample_rate)
        self._read_count = 0  # samples consumed by the VAD so far
        self._carry = None if server_managed else vad.init_carry(self.st, device=self.device)
        # The FSM carry is the previous step's own, so the next scan may
        # continue it unchecked (vad.chunk_step's ``chained``); not so for
        # a fresh or a just-loaded carry.
        self._chained = False
        self.server_managed = server_managed
        self.segments: list[dict] = []
        self._margin = 2 * config.sample_rate

    @property
    def total_write_count(self) -> int:
        return self.original_ring.total_written

    def push_samples(self, channel_pcm: np.ndarray) -> int:
        """Push planar [C, n] samples; runs the step per full unread chunk.
        All samples land in the original ring at once, in slabs of at most
        half the ring so that the VAD never falls a full ring behind the
        writer. Returns the absolute index of the first pushed sample."""
        channel_pcm = np.asarray(channel_pcm, np.float32)
        if channel_pcm.shape[0] != self.config.n_channels:
            raise ValueError(f"expected {self.config.n_channels} channels, got {channel_pcm.shape[0]}")
        first_index = self.original_ring.total_written
        slab = self.original_ring.capacity // 2
        pos = 0
        n = channel_pcm.shape[1]
        while pos < n:
            part = channel_pcm[:, pos : pos + slab]
            pos += part.shape[1]
            self._write_and_record(self.original_ring, self.original_recorder, part, "original")
            self._maybe_run_pipeline()
        return first_index

    def _maybe_run_pipeline(self) -> None:
        if self.config.skip_processing:
            self._read_count = self.original_ring.total_written
            return
        while self.original_ring.total_written - self._read_count >= self.chunk_size:
            chunk = self.original_ring.read(self._read_count, self._read_count + self.chunk_size)
            self._process_chunk(chunk)

    def _process_chunk(self, chunk: np.ndarray) -> None:
        if self.server_managed:
            raise RuntimeError("pipeline is server-managed: feed it through the server, not push_samples")
        # The framing offset is arithmetic of the chunks read so far, and the
        # FSM carry is this pipeline's own after its first step.
        fill = self._read_count % self.st.fft_size
        self._read_count += self.chunk_size
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        with torch.inference_mode():
            self._carry, out = vad.chunk_step(
                self.net, self.st, self._carry, x, fsm_params=self._machines, shared_start=self.st.fft_size - fill,
                chained=self._chained,
            )
        self._chained = True
        self._consume_chunk_output(out)

    def ingest_processed_chunk(self, chunk: np.ndarray, out: vad.ChunkOutput) -> None:
        """Server mode: the ring write and the host's event handling for one
        chunk whose device work already ran in a shared batched step; the
        counters, recorders and segments end as ``push_samples`` leaves them."""
        chunk = np.asarray(chunk, np.float32)
        self._write_and_record(self.original_ring, self.original_recorder, chunk, "original")
        self._read_count += chunk.shape[1]
        self._consume_chunk_output(out)

    # Server mode with ring-buffered ingestion: buffer_samples is the write
    # phase of push_samples, peek_pending_chunk/complete_chunk its process
    # phase, driven by a shared batched step.

    def buffer_samples(self, channel_pcm: np.ndarray) -> int:
        """Write samples into the original ring and recorder without running
        the step; returns the absolute index of the first sample. Callers
        tick between writes so that no more than a ring of samples is ever
        unprocessed."""
        channel_pcm = np.asarray(channel_pcm, np.float32)
        unread = self.original_ring.total_written - self._read_count
        if unread + channel_pcm.shape[1] > self.original_ring.capacity:
            raise ValueError("buffer_samples would overwrite unprocessed audio: tick the server between slabs")
        first_index = self.original_ring.total_written
        self._write_and_record(self.original_ring, self.original_recorder, channel_pcm, "original")
        return first_index

    @property
    def pending_chunks(self) -> int:
        """Full unprocessed chunks sitting in the original ring."""
        return (self.original_ring.total_written - self._read_count) // self.chunk_size

    def peek_pending_chunk(self) -> np.ndarray:
        """The next unprocessed chunk (does not advance the read count)."""
        return self.original_ring.read(self._read_count, self._read_count + self.chunk_size)

    def complete_chunk(self, out: vad.ChunkOutput) -> None:
        """Advance past the chunk last peeked and consume its outputs."""
        self._read_count += self.chunk_size
        self._consume_chunk_output(out)

    def _consume_chunk_output(self, out: vad.ChunkOutput) -> None:
        windows, valid, denoised = _to_host(out)
        if self._machines is not None:  # [1 + K, W]: the primary machine, then the alternatives
            for k, segs in enumerate(self.alt_segments, 1):
                for w in np.nonzero(windows.seg_valid[k])[0]:
                    segs += vad.segments_from_outputs(self.st, fsm.WindowOutput(*(x[k, w : w + 1] for x in windows)))
            windows = fsm.WindowOutput(*(x[0] for x in windows))
        # Without collect_denoised the denoised audio never left the device:
        # the denoised ring and recorder stay idle for this stream.
        has_denoised = denoised.size > 0
        if has_denoised:
            # Written before the events, so that a started recording can read its pre-roll.
            self._write_and_record(self.denoised_ring, self.denoised_recorder, denoised, "denoised")
        for w in range(windows.event.shape[0]):
            if not valid[w]:
                continue
            ev = int(windows.event[w])
            if ev == fsm.EV_STARTED:
                start = max(0, int(windows.event_win[w]) * self.st.fft_size - self._margin)
                self.original_recorder.start(start)
                if has_denoised:
                    self.denoised_recorder.start(start)
            elif ev == fsm.EV_COMPLETED:
                stop = int(windows.event_win[w]) * self.st.fft_size + self._margin
                self._emit(self.original_recorder.stop(stop, True), "original")
                if has_denoised:
                    self._emit(self.denoised_recorder.stop(stop, True), "denoised")
                if windows.seg_valid[w]:
                    seg = vad.segments_from_outputs(self.st, fsm.WindowOutput(*(x[w : w + 1] for x in windows)))
                    self.segments.append(seg[0])
                    if self.callbacks.on_segment:
                        self.callbacks.on_segment(seg[0])
            elif ev == fsm.EV_ABORTED:
                self.original_recorder.stop(0, False)
                self.denoised_recorder.stop(0, False)

    def _write_and_record(self, ring: RingBuffer, recorder: StreamRecorder, samples: np.ndarray, kind: str) -> None:
        ring.write(samples)
        self._emit(recorder.on_new_samples(samples), kind)

    # ---- checkpoint / resume (the reference loses all state on exit) ------

    def save_state(self, path: str) -> None:
        """Serialize the whole streaming state (the carry, the rings, the
        int64 counters and the recorders) so that a restarted process
        resumes bit-identically, recordings in flight included: their
        accumulated buffers go to a ``<path>.rec.npz`` sidecar, since they
        are of any length and may outlive the ring's history. A carry whose
        FSM has not scanned yet is saved as a fresh packed carry with its
        Kahan slots seeded, so the file's layout is fixed; a server-managed
        pipeline saves a fresh placeholder carry (the server's batched
        carries are authoritative)."""
        rec = {}
        for prefix, r in (("orig", self.original_recorder), ("den", self.denoised_recorder)):
            rec[f"{prefix}_recording"] = np.bool_(r.recording)
            rec[f"{prefix}_start"] = np.int64(r.start_index)
            rec[f"{prefix}_stop_at"] = np.int64(-1 if r.stop_at is None else r.stop_at)
            rec[f"{prefix}_keep"] = np.bool_(r.keep)
            rec[f"{prefix}_buffer"] = (
                r.buffer if r.buffer is not None else np.zeros((self.config.n_channels, 0), np.float32)
            )
        np.savez(path + ".rec.npz", **rec)
        carry = self._carry if self._carry is not None else vad.init_carry(self.st, device=self.device)
        checkpoint.save_carry(path, {
            "carry": self._with_fsm(carry),
            "read_count": np.int64(self._read_count),
            "orig_ring": self.original_ring.data,
            "orig_written": np.int64(self.original_ring.total_written),
            "den_ring": self.denoised_ring.data,
            "den_written": np.int64(self.denoised_ring.total_written),
        })

    def _with_fsm(self, carry: dict) -> dict:
        """``carry`` with a fresh seeded FSM carry where it has none yet (a
        row a machine)."""
        if carry["fsm"] is not None:
            return carry
        dev = carry["win_base"].device
        if self._machines is None:
            params, rows = self.st.fsm_params, 1
        else:
            params, rows = fsm.tile_rows(self._machines, 1), len(self.alt_segments) + 1
        return {**carry, "fsm": fsm_cuda.seeded_fresh_carry(self.st.fsm_shape, params, rows, dev)}

    def load_state(self, path: str) -> None:
        """Restore a ``save_state`` checkpoint. The next step checks the
        loaded FSM carry, the alternative machines' rows included (it did
        not come from the previous step)."""
        template = {
            "carry": self._with_fsm(vad.init_carry(self.st, device=self.device)),
            "read_count": np.int64(0),
            "orig_ring": np.zeros_like(self.original_ring.data),
            "orig_written": np.int64(0),
            "den_ring": np.zeros_like(self.denoised_ring.data),
            "den_written": np.int64(0),
        }
        state = checkpoint.load_carry(path, template)
        if not self.server_managed:
            self._carry = state["carry"]
            self._chained = False
        self._read_count = int(state["read_count"])
        self.original_ring.data = np.array(state["orig_ring"])  # writable copies
        self.original_ring.total_written = int(state["orig_written"])
        self.denoised_ring.data = np.array(state["den_ring"])
        self.denoised_ring.total_written = int(state["den_written"])
        rec_path = path + ".rec.npz"
        if os.path.exists(rec_path):
            with np.load(rec_path, allow_pickle=False) as z:
                for prefix, r in (("orig", self.original_recorder), ("den", self.denoised_recorder)):
                    r.recording = bool(z[f"{prefix}_recording"])
                    r.start_index = int(z[f"{prefix}_start"])
                    stop_at = int(z[f"{prefix}_stop_at"])
                    r.stop_at = None if stop_at < 0 else stop_at
                    r.keep = bool(z[f"{prefix}_keep"])
                    r.buffer = np.array(z[f"{prefix}_buffer"]) if r.recording else None

    def _emit(self, buf: Optional[AudioBuffer], kind: str) -> None:
        if buf is None:
            return
        cb = self.callbacks.on_original_recording if kind == "original" else self.callbacks.on_denoised_recording
        if cb:
            cb(buf)
