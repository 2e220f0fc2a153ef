"""Slab-wise batched VAD for streams of any length over a data mesh (port
of ``formula_vad_tpu/parallel/slab_runner.py::SlabRunner``).

The one-shot runner (``parallel.runner.BatchRunner``) holds whole streams on
the device: a 21-stream, 90-minute race is ~58 GB of float32. This runner
scores the batch in fixed slabs (64 s by default) with exact carried state,
so device memory does not grow with stream length, and keeps the
chunk-parallel front end inside each slab:

* a slab is a multiple of lcm(24000, 1024) = 768,000 samples (16 s), so no
  FSM window straddles a slab edge and window indices simply continue;
* the denoiser's boundary state (raw tail, 4 feature-context frames, OLA
  tail, last 16 kHz sample) is carried through
  ``offline.window_inputs_carry``, as copies, so one slab's intermediates
  are freed before the next is computed;
* the FSM carry, Kahan sums included, continues across slabs on the card
  (``fsm_cuda``), or in the host decoder with ``use_host_fsm=True``.

Segments equal the one-shot runner's.

``alt_vad_machine_configs`` run as the one-shot runner's do: the primary
machine and the K alternatives are 1 + K (stream, config) rows a stream,
stream-major, of one FSM scan a slab behind the one front end, their
carry chained on the card from slab to slab with the primary's (or in the
host decoder with ``use_host_fsm=True``).

Each slab goes host to device through a fixed pair of pinned buffers
(int16 for PCM16 readers, ``raw16=True``: half the bytes, dequantised on the
card exactly), copied on a side stream while the card computes the previous
slab. Between the first slab's dispatch and the final fetch the host waits
only on those buffers' copy events, never on the compute stream: every
slab's FSM outputs stay on the card until one fetch at the end.

The streams are sharded over the mesh as ``BatchRunner``'s are
(``parallel/mesh.py``; padded with all-invalid streams). Each of this
process's shards has its own staging (pinned buffers and copy stream on its
device) and its own denoiser and FSM carries, chained on its device; every
shard's slab is dispatched before the next slab is read, each shard's
outputs are fetched once at the end and gathered across processes. Each
process's prefetcher reads only its own rows, where the JAX prefetcher
reads all padded rows on every host: a change of schedule, not of
function.

Not ported: ``pipeline_fe`` "on", "deep" and "flat" (cross-slab overlap of
the front end) are measured dead ends of the JAX package whose outputs
equal "off" (ROADMAP: measured dead ends); this is the "off" form.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import VADConfig
from ..device import model_device
from ..io_.prefetch import Reader, SlabPrefetcher
from ..pipeline import fsm, fsm_cuda, fsm_host, offline, vad
from . import mesh as mesh_lib
from .runner import StreamResult, results

SLAB_ALIGN_CHUNKS = 32  # 16 s: lcm(chunk=24000, fft=1024) / 24000
STAGING_BUFFERS = 2


class _Staging:
    """Host-to-device staging of (slab, chunk_valid) pairs through
    ``STAGING_BUFFERS`` pinned host buffers and as many device buffers,
    allocated once. Pair s is copied into pinned buffer s % n on the host
    (after that buffer's last copy has completed), then to the card on a
    side stream (after the compute that read its device buffer), and the
    compute stream waits for the copy. On the CPU the arrays are used as
    they are."""

    def __init__(self, slab_shape: tuple, dtype: np.dtype, cv_shape: tuple, device: torch.device):
        self.device = device
        if device.type == "cpu":
            return
        tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        self.host = [
            (torch.empty(slab_shape, dtype=tdtype, pin_memory=True), torch.empty(cv_shape, dtype=torch.bool, pin_memory=True))
            for _ in range(STAGING_BUFFERS)
        ]
        self.dev = [
            (torch.empty(slab_shape, dtype=tdtype, device=device), torch.empty(cv_shape, dtype=torch.bool, device=device))
            for _ in range(STAGING_BUFFERS)
        ]
        self.copied = [None] * STAGING_BUFFERS
        self.read = [None] * STAGING_BUFFERS
        self.copy_stream = torch.cuda.Stream(device)

    def put(self, s: int, slab: np.ndarray, cv: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage pair ``s``; -> its (audio, chunk_valid) on the device."""
        if self.device.type == "cpu":
            return torch.from_numpy(slab), torch.from_numpy(cv)
        i = s % STAGING_BUFFERS
        if self.copied[i] is not None:
            self.copied[i].synchronize()  # the pinned buffer's last copy is done
        host, dev = self.host[i], self.dev[i]
        for dst, src in zip(host, (slab, cv)):
            np.copyto(dst.numpy(), src)
        with torch.cuda.stream(self.copy_stream):
            if self.read[i] is not None:
                self.copy_stream.wait_event(self.read[i])  # the compute that read dev[i] is done
            for dst, src in zip(dev, host):
                dst.copy_(src, non_blocking=True)
            self.copied[i] = torch.cuda.Event()
            self.copied[i].record(self.copy_stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied[i])
        return dev

    def done(self, s: int) -> None:
        """Pair ``s``'s compute has been dispatched: its device buffer may
        be refilled once the compute stream gets past this point."""
        if self.device.type != "cpu":
            self.read[s % STAGING_BUFFERS] = torch.cuda.current_stream(self.device).record_event()


class _Shard:
    """One of this process's shards of a slab run: its rows of the
    process's slabs, its device and model copy, its staging, carries and
    outputs."""

    def __init__(self, runner: "SlabRunner", device: torch.device, rows: slice, dtype: np.dtype):
        st = runner.st
        n = rows.stop - rows.start
        self.device, self.rows, self.net = device, rows, runner.nets[device]
        self.n_rows, self.expand, self.params = runner._rows(n)
        self.staging = _Staging((n, st.n_channels, runner.slab_samples), dtype, (n, runner.slab_chunks), device)
        self.den_carry = offline.init_slab_carry((n, st.n_channels), st.downsample_rate, device)
        self.outs = []  # each slab's FSM outputs
        self.fsm_carry = self.win_base = None  # the device FSM's
        self.host_carry = self.pinned = self.pending = None  # the host decoder's


class SlabRunner:
    """Constant-memory batched VAD over streams of any length."""

    def __init__(
        self,
        net: nn.Module,
        vad_config: VADConfig | None = None,
        n_channels: int = 2,
        sample_rate: int = 48000,
        slab_chunks: int = 128,  # 64 s
        mesh: mesh_lib.DataMesh | None = None,
        use_mesh: bool = True,
        use_host_fsm: bool = False,
        # Decode threads (default min(8, B, cpu_count)) and pipeline depth:
        # host RAM holds ~(depth + 2) slabs beside the pinned buffers.
        prefetch_workers: int | None = None,
        prefetch_depth: int = 1,
    ):
        if slab_chunks <= 0 or slab_chunks % SLAB_ALIGN_CHUNKS != 0:
            raise ValueError(f"slab_chunks must be a positive multiple of {SLAB_ALIGN_CHUNKS}")
        vad_config = vad_config or VADConfig()
        self.net = net
        self.device = model_device(net)
        self.mesh = mesh_lib.default_mesh(mesh, use_mesh, self.device)
        self.nets = mesh_lib.replicate(net, self.mesh)
        self.use_host_fsm = use_host_fsm
        self.st = vad.statics_from_config(vad_config, sample_rate, n_channels)
        self.alt_configs = tuple(vad_config.alt_vad_machine_configs or ())
        self.machines = vad.machines_of(self.st, vad_config)
        self.slab_chunks = slab_chunks
        self.slab_samples = slab_chunks * self.st.chunk_size
        self.windows_per_slab = self.slab_samples // self.st.fft_size
        self.prefetch_workers = prefetch_workers
        self.prefetch_depth = prefetch_depth

    def run(self, audio_batch: np.ndarray, lengths: Optional[Sequence[int]] = None) -> list[StreamResult]:
        """Score [B, C, T] float32 audio (any T), slab by slab."""
        audio_batch = np.asarray(audio_batch, np.float32)
        b, _, t = audio_batch.shape
        if lengths is None:
            lengths = [t] * b
        return self.run_readers([lambda s, n, i=i: audio_batch[i, :, s : s + n] for i in range(b)], lengths)

    def run_readers(self, readers: Sequence[Reader], lengths: Sequence[int], raw16: bool = False) -> list[StreamResult]:
        """Score streams served by reader callables.

        Args:
          readers: one ``read(start_sample, n_samples) -> [C, m]`` a stream
            (m may be short at the end; the slab is zero-padded).
          lengths: each stream's sample count; whole chunks are scored.
          raw16: the readers return planar int16 PCM, which travels to the
            card at half the bytes and is dequantised there, bit for bit as
            the host's PCM16 decode.
        Returns:
          one StreamResult a stream.
        """
        if self.use_host_fsm and self.mesh.n_processes > 1:
            raise ValueError(
                "use_host_fsm requires a single process: multi-process outputs are sharded across hosts "
                "(leave use_host_fsm unset to get the device-FSM path)"
            )
        b = len(readers)
        st = self.st
        valid_chunks = np.asarray([n // st.chunk_size for n in lengths], np.int64)
        max_chunks = int(valid_chunks.max(initial=0))
        if max_chunks == 0:
            return [StreamResult([], [[] for _ in self.alt_configs]) for _ in range(b)]
        n_slabs = -(-max_chunks // self.slab_chunks)
        dtype = np.int16 if raw16 else np.float32
        b_pad = mesh_lib.pad_batch(b, self.mesh)
        placed = mesh_lib.local_shards(self.mesh, b_pad)
        lo, hi = placed[0][1].start, placed[-1][1].stop
        shards = [_Shard(self, dev, slice(r.start - lo, r.stop - lo), dtype) for dev, r in placed]
        prefetcher = SlabPrefetcher(
            readers[lo:hi], valid_chunks[lo:hi], n_slabs=n_slabs, slab_chunks=self.slab_chunks,
            chunk_size=st.chunk_size, n_channels=st.n_channels, b_pad=hi - lo, workers=self.prefetch_workers,
            depth=self.prefetch_depth, dtype=dtype,
        )
        try:
            with torch.inference_mode():
                loop = self._host_fsm_loop if self.use_host_fsm else self._device_fsm_loop
                outs = loop(prefetcher, shards, n_slabs)
        finally:
            prefetcher.close()
        outs = mesh_lib.gather_rows(outs, self.mesh)  # [rows, n_slabs * W] each
        k = len(self.alt_configs)
        outs = fsm.WindowOutput(*(x.reshape(b_pad, k + 1, -1)[:b] if k else x[:b] for x in outs))
        return results(st, outs, k)

    def _rows(self, b: int):
        """The FSM's rows for ``b`` streams (``fsm.machine_rows``): one a
        stream, or 1 + K (stream, config) rows with alternative machines."""
        return fsm.machine_rows(self.st.fsm_params if self.machines is None else self.machines, b)

    def _front_end(self, net: nn.Module, audio: torch.Tensor, cv: torch.Tensor, den_carry: dict):
        """One slab's window inputs -> (den_carry, min_vol, ratios, valid) [B, W]."""
        if audio.dtype == torch.int16:
            audio = audio.float() / 32768.0  # exact: a 16-bit integer over a power of two
        return offline.window_inputs_carry(net, self.st, audio, den_carry, cv.sum(1))

    def _dispatch(self, shard: _Shard, s: int, slab: np.ndarray, cv: np.ndarray):
        """Stage the shard's rows of slab ``s`` and queue their front end."""
        audio, cv = shard.staging.put(s, slab[shard.rows], cv[shard.rows])
        out = self._front_end(shard.net, audio, cv, shard.den_carry)
        shard.staging.done(s)
        return out

    def _device_fsm_loop(self, prefetcher, shards: list[_Shard], n_slabs: int) -> list[fsm.WindowOutput]:
        """The FSM on each shard's card, its carry chained from slab to slab;
        every slab's outputs stay on the card until one fetch a shard at
        the end. -> each shard's seven outputs."""
        st = self.st
        for sh in shards:
            sh.win_base = torch.zeros((sh.n_rows,), dtype=torch.int32, device=sh.device)
        for s in range(n_slabs):
            slab, cv = prefetcher.get()
            for sh in shards:
                with mesh_lib.on(sh.device):
                    sh.den_carry, *inputs = self._dispatch(sh, s, slab, cv)
                    mv, rt, va = (sh.expand(x) for x in inputs)
                    if sh.fsm_carry is None:
                        out, sh.fsm_carry = fsm_cuda.scan_windows(st.fsm_shape, sh.params, mv, rt, va, win_base=sh.win_base)
                    else:
                        out, sh.fsm_carry = fsm_cuda._scan_chained(
                            st.fsm_shape, sh.params, mv, rt, va, sh.fsm_carry, sh.win_base
                        )
                    sh.win_base = sh.win_base + self.windows_per_slab
                    sh.outs.append(out)
        return [self._fetch(sh.outs) for sh in shards]

    def _fetch(self, slab_outs: list) -> fsm.WindowOutput:
        """A shard's outputs of every slab, joined along the windows on the
        card and fetched once -> numpy [rows, n_slabs * W]."""
        return fsm.WindowOutput(*(torch.cat(xs, dim=1).cpu().numpy() for xs in zip(*slab_outs)))

    def _host_fsm_loop(self, prefetcher, shards: list[_Shard], n_slabs: int) -> list[list[np.ndarray]]:
        """The FSM in the native host decoder: a shard's window inputs of
        slab s go to its pinned host buffers while its slab s-1 is decoded,
        its carry (Kahan state included) chained exactly. -> each shard's
        seven outputs."""
        st = self.st
        w = self.windows_per_slab
        for sh in shards:
            sh.host_carry = fsm_host.fresh_host_carry(st.fsm_shape, sh.params, sh.n_rows)
            n = sh.rows.stop - sh.rows.start
            if sh.device.type != "cpu":
                sh.pinned = [
                    [torch.empty((n, w), dtype=dt, pin_memory=True) for dt in (torch.float32, torch.float32, torch.bool)]
                    for _ in range(2)
                ]

        def decode(sh, s, inputs, copied):
            if copied is not None:
                copied.synchronize()
            win_base = np.full((sh.n_rows,), s * w, np.int32)
            out, sh.host_carry = fsm_host.scan_windows_host(
                st.fsm_shape, sh.params, *(sh.expand(x.numpy()) for x in inputs), carry=sh.host_carry, win_base=win_base
            )
            sh.outs.append(out)

        for s in range(n_slabs):
            slab, cv = prefetcher.get()
            for sh in shards:
                with mesh_lib.on(sh.device):
                    sh.den_carry, *inputs = self._dispatch(sh, s, slab, cv)
                    copied = None
                    if sh.device.type != "cpu":
                        for dst, src in zip(sh.pinned[s % 2], inputs):
                            dst.copy_(src, non_blocking=True)
                        inputs, copied = sh.pinned[s % 2], torch.cuda.current_stream(sh.device).record_event()
                if sh.pending is not None:
                    decode(sh, *sh.pending)  # slab s-1, while the card computes slab s
                sh.pending = (s, inputs, copied)
        for sh in shards:
            decode(sh, *sh.pending)
        return [[np.concatenate(xs, axis=1) for xs in zip(*sh.outs)] for sh in shards]
