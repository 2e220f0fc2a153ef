"""Online multi-stream serving: one batched device step for B live streams
(port of ``formula_vad_tpu/parallel/online.py``).

The reference serves exactly one radio stream per daemon process. This
server holds B carried VAD states on the card and runs ONE batched
``vad.chunk_step`` per 0.5 s tick for all streams in lockstep: kernel 1
(the GRU recurrence, or the tier's) at 2·B rows and kernel 2 (the FSM scan)
at [B, 24], once a tick. Recordings, segment assembly, callbacks and
checkpoints stay per-stream host objects (``AudioPipeline`` in server mode,
fed through ``ingest_processed_chunk`` / ``complete_chunk``).

Streams without data this tick pass ``valid=False``: their carried state
is frozen on the card (``chunk_step``'s ``chunk_valid``), unlike the
reference's ``skip_segment``, which pushes silence through the pipeline;
a frozen stream resumes exactly where it left off.

The FSM runs on the card by default (kernel 2, as the port's
``BatchRunner`` does), where the JAX server's default decodes it on the
host. ``use_host_fsm=True`` selects the port's native host decoder
(``fsm_host``) and raises if it cannot be built. The two are bit for bit
the same and share the packed carry layout of ``pipeline/fsm.py``, so the
default changes no result and a checkpoint loads under either backend.

With ``use_mesh=True`` (or a ``mesh``, ``parallel/mesh.py``) each
microbatch shard is split over the mesh's devices, each part with its own
carry on its device and the model's copy there, and a tick dispatches every
device's step before it fetches any. The mesh must lie in this process: the
B ``AudioPipeline``s are one process's host objects, and neither package
has a daemon across processes. Alternative machine configs are refused:
the server runs one machine a stream, as the JAX server does.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import model_device
from ..pipeline import fsm, fsm_cuda, fsm_host, vad
from ..pipeline.pipeline import AudioPipeline, Callbacks
from ..utils import checkpoint
from . import mesh as mesh_lib

# The ChunkOutput fields a tick fetches to the host ("windows" is the
# FSM's seven outputs, absent in host-FSM mode).
_FETCHED = ("window_valid", "denoised", "min_vol", "ratios", "win_indices")


def _rows(carry, rows):
    """The rows ``rows`` of every leaf of a (nested) carry."""
    if isinstance(carry, dict):
        return {k: _rows(v, rows) for k, v in carry.items()}
    return None if carry is None else carry[rows]


def _join(carries: list) -> dict:
    """Shards' host carries joined along the stream axis."""
    first = carries[0]
    if isinstance(first, dict):
        return {k: _join([c[k] for c in carries]) for k in first}
    return None if first is None else np.concatenate(carries, axis=0)


def _to_device(carry, device):
    if isinstance(carry, dict):
        return {k: _to_device(v, device) for k, v in carry.items()}
    return None if carry is None else torch.from_numpy(np.ascontiguousarray(carry)).to(device)


def _to_host(carry):
    if isinstance(carry, dict):
        return {k: _to_host(v) for k, v in carry.items()}
    return None if carry is None else carry.cpu().numpy()


def _where_row(mask, fresh, carry):
    """``carry`` with the rows under ``mask`` [shard] taken from ``fresh``
    (one row, broadcast), on the card, with no read-back."""
    if isinstance(carry, dict):
        return {k: _where_row(mask, fresh[k], v) for k, v in carry.items()}
    m = mask.reshape((-1,) + (1,) * (carry.dim() - 1))
    return torch.where(m, fresh.to(carry.dtype), carry)


class OnlineBatchServer:
    """Lockstep online VAD over B streams with one batched device step."""

    def __init__(
        self,
        config: PipelineConfig,
        n_streams: int,
        params=None,
        callbacks: Optional[Sequence[Optional[Callbacks]]] = None,
        mesh=None,
        use_mesh: bool = False,
        use_host_fsm: bool | None = None,
        collect_denoised: bool = True,
        use_shared_fill: bool = True,
        microbatch: int = 1,
        device: str | torch.device = "cuda",
    ):
        """``params`` is the denoiser (default: ``load_denoiser`` of the
        config's model on ``device``, the card unless the caller asks for
        the CPU); a given one sets the device.

        ``collect_denoised=False`` is the events-only tier: the denoised
        batch never leaves the card. Decisions, segments, callbacks and
        original recordings are unchanged; denoised recordings are not made.

        ``microbatch=m`` splits each tick into m sequential shard steps of
        B/m streams, each with its own carry: the step's transient memory
        shrinks by m and shard k's host work (its fetch, events and, in
        host-FSM mode, its FSM decode) runs while shards k+1.. compute.
        Rows are independent: segments, decisions, indices and original
        recordings equal microbatch=1's bit for bit; the float outputs
        (denoised audio, window volumes) may round otherwise where a GEMM
        takes another kernel at the shard's row count.

        ``mesh`` (or ``use_mesh=True``: every visible card, or the model's
        CPU) splits each microbatch shard over the mesh's devices, which
        must divide it; the same holds of the results as of microbatches."""
        if config.vad_config.alt_vad_machine_configs:
            raise ValueError("the server runs one machine a stream, as the JAX server: no alt_vad_machine_configs")
        if params is None:
            from ..models.registry import load_denoiser

            params = load_denoiser(config.vad_config.denoiser_model_path, device=device)
        self.params = params
        self.device = model_device(params)
        self.mesh = mesh_lib.default_mesh(mesh, use_mesh, self.device)
        if self.mesh.n_processes > 1:
            raise ValueError(
                "the server's mesh must lie in one process: its AudioPipelines are this process's host objects"
            )
        self.config = config
        self.n_streams = n_streams
        cbs = list(callbacks) if callbacks is not None else [None] * n_streams
        if len(cbs) != n_streams:
            raise ValueError("callbacks must have one entry per stream")
        if microbatch < 1 or n_streams % microbatch:
            raise ValueError(
                f"n_streams={n_streams} must be a positive multiple of microbatch={microbatch}"
            )
        self.st = vad.statics_from_config(config.vad_config, config.sample_rate, config.n_channels)
        self.pipelines = [self._pipeline(cb) for cb in cbs]
        self.chunk_size = self.st.chunk_size
        self.microbatch = microbatch
        n_dev = len(self.mesh.devices)
        if (n_streams // microbatch) % n_dev:
            raise ValueError(
                f"microbatch shard {n_streams // microbatch} must be divisible by the mesh's {n_dev} devices "
                "(pad with always-invalid streams)"
            )
        # The tick's device shards: microbatch shard s's part d is shard
        # s * n_dev + d, of ``_shard`` rows, on the mesh's device d.
        self._shard = n_streams // (microbatch * n_dev)
        self._devices = [self.mesh.devices[k % n_dev] for k in range(microbatch * n_dev)]
        self._nets = mesh_lib.replicate(params, self.mesh)
        self._on_card = self.mesh.devices[0].type == "cuda"
        self.use_host_fsm = bool(use_host_fsm)
        self.collect_denoised = collect_denoised
        # Host-tracked window-fill phases (fill' = (fill + chunk) mod fft for
        # each valid tick) select the shared-start framing whenever all live
        # fills agree: true from t = 0 in lockstep serving until valid-mask
        # freezes desynchronize streams.
        self._fills = np.zeros(n_streams, np.int64)
        self._use_shared_fill = use_shared_fill
        # Tick-latency observability (runtime-only; not checkpointed).
        self._tick_times: collections.deque = collections.deque(maxlen=512)
        self._ticks_total = 0
        # One carry per device shard, on its device. Its FSM part is None
        # until the shard's first scan (a fresh scan), then the scan's own
        # carry, which the next tick continues unchecked (``chained``)
        # unless it was loaded from a checkpoint.
        self._carries = [vad.init_carry(self.st, (self._shard,), d) for d in self._devices]
        self._chained = [False] * len(self._devices)
        self._host_fsm_carry = (
            fsm_host.fresh_host_carry(self.st.fsm_shape, self.st.fsm_params, n_streams)
            if self.use_host_fsm else None
        )
        # Pinned host buffers a shard's outputs are copied into, and the
        # tick's inputs are staged in (card only).
        self._pinned: list[dict | None] = [None] * len(self._devices)
        self._staging: dict[str, torch.Tensor] = {}
        # A fresh stream's carry row a device, made once: a reset copies
        # nothing to the card.
        self._fresh_rows = {}
        for d in dict.fromkeys(self.mesh.devices):
            row = self._fresh_rows[d] = vad.init_carry(self.st, (1,), d)
            row["fsm"] = fsm_cuda.seeded_fresh_carry(self.st.fsm_shape, self.st.fsm_params, 1, d)

    def _pipeline(self, callbacks) -> AudioPipeline:
        return AudioPipeline(self.config, self.params, callbacks, statics=self.st, server_managed=True)

    def reset_stream(self, i: int, callbacks=None) -> None:
        """Reassign slot ``i`` to a fresh stream without touching the fleet.

        The slot's carry row (on the card, with a row mask and
        ``torch.where``: no copy and no read-back; its FSM row gets a fresh
        machine with seeded Kahan slots), its host FSM row, its fill
        phase and its host pipeline return to the fresh-stream state; every
        other slot is bit for bit untouched. The new stream starts at
        window-fill 0, so ticks use the per-row framing until its phase
        realigns with the fleet's.

        callbacks: new Callbacks for the slot (default: keep the old ones).
        """
        if not 0 <= i < self.n_streams:
            raise ValueError(f"stream index {i} out of range [0, {self.n_streams})")
        s, r = divmod(i, self._shard)
        fresh = self._fresh_rows[self._devices[s]]
        mask = torch.arange(self._shard, device=self._devices[s]) == r
        carry = self._carries[s]
        new = _where_row(mask, fresh, {k: v for k, v in carry.items() if k != "fsm"})
        new["fsm"] = carry["fsm"]
        if carry["fsm"] is not None:  # None: the shard's first scan starts every row fresh
            new["fsm"] = _where_row(mask, fresh["fsm"], carry["fsm"])
        self._carries[s] = new
        if self._host_fsm_carry is not None:
            one = fsm_host.fresh_host_carry(self.st.fsm_shape, self.st.fsm_params, 1)
            for k, v in one.items():
                self._host_fsm_carry[k][i] = v[0]
        self._fills[i] = 0
        cb = callbacks if callbacks is not None else self.pipelines[i].callbacks
        self.pipelines[i] = self._pipeline(cb)

    def _run_step(self, chunks: np.ndarray, valid_np: np.ndarray) -> dict:
        """Dispatch one tick as a step a device shard (``microbatch`` of
        them a mesh device), taking the shared-fill framing when every
        valid stream's fill phase agrees. Every shard is dispatched before
        any is read: shard k's outputs are copied to pinned host buffers
        behind its step and waited for by its CUDA event alone, so its host
        work runs while the card computes the shards after it. Returns the tick's outputs as
        host arrays [B, ...], the FSM's seven outputs under "windows" (in
        host-FSM mode decoded here, shard by shard)."""
        t0 = time.perf_counter()
        live = self._fills[valid_np]
        shared = self._use_shared_fill and (live.size == 0 or bool((live == live[0]).all()))
        start = (self.st.fft_size - int(live[0]) if live.size else self.st.fft_size) if shared else None
        all_valid = bool(valid_np.all())
        x_all, v = self._upload_source(chunks, None if all_valid else valid_np)
        cv_all = None if v is None else {d: v.to(d, non_blocking=True) for d in dict.fromkeys(self.mesh.devices)}
        sh = self._shard
        pending = []
        for s, dev in enumerate(self._devices):
            rows = slice(s * sh, (s + 1) * sh)
            with mesh_lib.on(dev):
                x = x_all[rows].to(dev, non_blocking=True)
                if x.dtype == torch.int16:
                    # Raw PCM16 shipped at half the upload bytes; i / 32768 is
                    # exact in float32, so bit for bit the host's dequantization.
                    x = x.float() / 32768.0
                cv = True if cv_all is None else cv_all[dev][rows]
                with torch.inference_mode():
                    self._carries[s], out = vad.chunk_step(
                        self._nets[dev], self.st, self._carries[s], x, chunk_valid=cv,
                        run_fsm=not self.use_host_fsm, collect_denoised=self.collect_denoised,
                        shared_start=start, chained=self._chained[s],
                    )
                self._chained[s] = True
                pending.append(self._start_fetch(s, out))
        self._fills[valid_np] = (self._fills[valid_np] + self.chunk_size) % self.st.fft_size
        host = [self._finish_fetch(s, *p) for s, p in enumerate(pending)]
        result = host[0] if len(host) == 1 else _join(host)
        # Everything is on the host here: a true tick latency (dispatch,
        # compute, fetch and host-FSM decode).
        self._tick_times.append(time.perf_counter() - t0)
        self._ticks_total += 1
        return result

    def _upload_source(self, chunks: np.ndarray, valid_np: Optional[np.ndarray]):
        """The tick's chunks and valid mask (None: all valid) as host
        tensors each shard uploads its rows from. On the card both pass
        through pinned buffers, reused every tick (the last tick waited for
        its shards, and so for their uploads), so every upload is
        asynchronous: a copy from pageable memory would wait for the shards
        before it and run the shards in series. The mask goes up once a
        tick a device."""
        if not self._on_card:
            v = None if valid_np is None else torch.from_numpy(valid_np.copy())
            return torch.from_numpy(np.ascontiguousarray(chunks)), v
        x = self._staged(f"chunks {chunks.dtype}", chunks)
        v = None if valid_np is None else self._staged("valid", valid_np)
        return x, v

    def _staged(self, name: str, src: np.ndarray) -> torch.Tensor:
        """``src`` copied into the pinned buffer ``name`` by numpy, on this
        thread. torch's copy of a batch this size runs on its intra-op
        threads; ticks staged that way stalled by ~5 ms now and then on an
        H100 host (``scripts/serve_tick_ab.py``)."""
        buf = self._staging.get(name)
        if buf is None or tuple(buf.shape) != src.shape:
            buf = self._staging[name] = torch.empty(src.shape, dtype=torch.from_numpy(src[:0]).dtype, pin_memory=True)
        np.copyto(buf.numpy(), src, casting="no")
        return buf

    def _start_fetch(self, s: int, out: vad.ChunkOutput):
        """Start shard ``s``'s outputs on their way to the host: on the
        card, one non-blocking copy a field into the shard's pinned buffers
        and a CUDA event behind them; on the CPU they are there already."""
        fields = {f: getattr(out, f) for f in _FETCHED}
        if out.windows is not None:
            fields.update(out.windows._asdict())
        if not self._on_card:
            return fields, None
        bufs = self._pinned[s]
        if bufs is None or any(bufs[k].shape != v.shape or bufs[k].dtype != v.dtype for k, v in fields.items()):
            bufs = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in fields.items()}
            self._pinned[s] = bufs
        for k, v in fields.items():
            bufs[k].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return bufs, event

    def _finish_fetch(self, s: int, fields: dict, event) -> dict:
        """Wait for shard ``s``'s copies (its event only) and return numpy
        views; in host-FSM mode decode the shard's windows here and write
        its rows of the fleet's host carry back."""
        if event is not None:
            event.synchronize()
        host = {k: v.numpy() for k, v in fields.items()}
        if self.use_host_fsm:
            rows = slice(s * self._shard, (s + 1) * self._shard)
            win_out, new_carry = fsm_host.scan_windows_host(
                self.st.fsm_shape, self.st.fsm_params, host["min_vol"], host["ratios"], host["window_valid"],
                carry={k: v[rows] for k, v in self._host_fsm_carry.items()},
                win_base=host["win_indices"][:, 0],
            )
            for k, v in new_carry.items():
                self._host_fsm_carry[k][rows] = v
            host.update(win_out._asdict())
        return host

    @staticmethod
    def _stream_output(out: dict, i: int) -> vad.ChunkOutput:
        """Stream ``i``'s ChunkOutput as numpy views of the tick's arrays."""
        return vad.ChunkOutput(
            windows=fsm.WindowOutput(*(out[f][i] for f in fsm.WindowOutput._fields)),
            **{f: out[f][i] for f in _FETCHED},
        )

    def push(self, chunks: np.ndarray, valid: Optional[np.ndarray] = None) -> None:
        """Advance every valid stream by one chunk.

        Args:
          chunks: [B, C, chunk_size] float32, or int16 PCM (rows of invalid
            streams are ignored; pass zeros). An int16 batch goes to the
            card raw, at half the bytes, and is dequantized there (i / 32768,
            exact in float32): bit for bit the float32 push of the same
            samples; rings and recordings hold the same float32 samples.
          valid: [B] bool mask; default all true.
        """
        chunks = np.asarray(chunks)
        if chunks.dtype != np.int16:
            chunks = np.asarray(chunks, np.float32)
        want = (self.n_streams, self.config.n_channels, self.chunk_size)
        if chunks.shape != want:
            raise ValueError(f"expected chunks of shape {want}, got {chunks.shape}")
        i16 = chunks.dtype == np.int16
        host_chunks = chunks.astype(np.float32) / np.float32(32768.0) if i16 else chunks
        valid = np.ones((self.n_streams,), bool) if valid is None else np.asarray(valid, bool)
        if valid.shape != (self.n_streams,):
            raise ValueError(f"valid mask must have shape ({self.n_streams},), got {valid.shape}")
        # Streams whose ring holds unprocessed samples (buffer_samples mixed
        # with push) are routed through the ring: the pushed chunk lands
        # after the buffered tail and the card serves the ring's head, so the
        # sample order stays exact.
        ring_routed = np.zeros(self.n_streams, bool)
        for i, p in enumerate(self.pipelines):
            if valid[i] and p.original_ring.total_written != p._read_count:
                ring_routed[i] = True
                p.buffer_samples(host_chunks[i])
        if i16 and not ring_routed.any():
            dev_chunks = chunks  # raw int16
        else:
            # A tick's batch is one dtype: ring-routed rows come back from
            # the ring as float32, so such ticks upload the exactly
            # dequantized float32.
            dev_chunks = np.array(host_chunks)
            for i in np.nonzero(ring_routed)[0]:
                dev_chunks[i] = self.pipelines[i].peek_pending_chunk()
        out = self._run_step(dev_chunks, valid)
        for i in np.nonzero(valid)[0]:
            out_i = self._stream_output(out, i)
            if ring_routed[i]:
                self.pipelines[i].complete_chunk(out_i)
            else:
                self.pipelines[i].ingest_processed_chunk(host_chunks[i], out_i)

    def tick_pending(self) -> bool:
        """Advance every stream holding at least one full chunk in its ring
        (fed through ``pipeline.buffer_samples``) by one batched step.
        Returns False when no stream had a full chunk."""
        valid = np.array([p.pending_chunks >= 1 for p in self.pipelines])
        if not valid.any():
            return False
        zeros = np.zeros((self.config.n_channels, self.chunk_size), np.float32)
        chunks = np.stack([p.peek_pending_chunk() if v else zeros for p, v in zip(self.pipelines, valid)])
        out = self._run_step(chunks, valid)
        for i in np.nonzero(valid)[0]:
            self.pipelines[i].complete_chunk(self._stream_output(out, i))
        return True

    @property
    def segments(self) -> list[list[dict]]:
        return [p.segments for p in self.pipelines]

    def tick_stats(self) -> dict:
        """Wall time per tick (dispatch, compute, fetch, host-FSM decode)
        over the last <= 512 ticks, against the real-time budget.
        Runtime-only: a restored fleet reports its own process's ticks."""
        budget_ms = 1e3 * self.chunk_size / self.config.sample_rate
        stats = {
            "ticks": self._ticks_total,
            "window": len(self._tick_times),
            "budget_ms": float(budget_ms),
            "streams": self.n_streams,
        }
        if self._tick_times:
            ts = np.asarray(self._tick_times, np.float64) * 1e3
            stats.update(
                last_ms=round(float(ts[-1]), 3),
                p50_ms=round(float(np.percentile(ts, 50)), 3),
                p95_ms=round(float(np.percentile(ts, 95)), 3),
                max_ms=round(float(ts.max()), 3),
                over_budget=int(np.sum(ts > budget_ms)),
            )
        return stats

    # ---- checkpoint / resume (serving failover) ---------------------------

    def _full_carries(self) -> dict:
        """The fleet's [B, ...] carry on the host, shards fetched one at a
        time and joined there (a join on the card would hold a second
        fleet-sized carry). Its FSM part is the authoritative one: the host
        decoder's carry in host-FSM mode, a fresh seeded carry where no
        scan has run yet."""
        shards = []
        for carry in self._carries:
            host = _to_host({k: v for k, v in carry.items() if k != "fsm"})
            if not self.use_host_fsm:
                fsm_carry = carry["fsm"]
                if fsm_carry is None:
                    fsm_carry = fsm_cuda.seeded_fresh_carry(self.st.fsm_shape, self.st.fsm_params, self._shard, "cpu")
                host["fsm"] = _to_host(fsm_carry)
            shards.append(host)
        full = _join(shards)
        if self.use_host_fsm:
            full["fsm"] = self._host_fsm_carry
        return full

    def save_state(self, directory: str) -> None:
        """Persist the fleet's carries and every stream's host state so that
        a restarted server resumes all B streams bit-identically."""
        os.makedirs(directory, exist_ok=True)
        checkpoint.save_carry(os.path.join(directory, "carries.npz"), self._full_carries())
        for i, p in enumerate(self.pipelines):
            # The per-pipeline carry in this file is a placeholder in server
            # mode: the carries file above is authoritative.
            p.save_state(os.path.join(directory, f"stream{i:04d}.npz"))

    def load_state(self, directory: str) -> None:
        """Resume a ``save_state`` checkpoint, written under either FSM
        backend and at any microbatch (both backends share the packed FSM
        layout). The carries are uploaded shard by shard, each replacing
        its old shard, so the card never holds two fleet-sized carries; the
        next tick checks the loaded FSM carry."""
        template = self._full_carries()
        full = checkpoint.load_carry(os.path.join(directory, "carries.npz"), template)
        sh = self._shard
        for s, dev in enumerate(self._devices):
            part = _rows({k: v for k, v in full.items() if k != "fsm"}, slice(s * sh, (s + 1) * sh))
            self._carries[s] = None
            carry = _to_device(part, dev)
            carry["fsm"] = None if self.use_host_fsm else _to_device(_rows(full["fsm"], slice(s * sh, (s + 1) * sh)), dev)
            self._carries[s] = carry
            self._chained[s] = False
        if self.use_host_fsm:
            host = {k: np.ascontiguousarray(v) for k, v in full["fsm"].items()}
            fsm.check_carry(self.st.fsm_shape, host, self.n_streams)
            self._host_fsm_carry = host
        for i, p in enumerate(self.pipelines):
            p.load_state(os.path.join(directory, f"stream{i:04d}.npz"))
        # Re-sync the host-tracked fill phases from the restored carries.
        self._fills = np.asarray(full["fft_fill"], np.int64)
