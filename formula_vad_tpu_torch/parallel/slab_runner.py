"""Slab-wise batched VAD for streams of any length on one device (port of
``formula_vad_tpu/parallel/slab_runner.py::SlabRunner``, one GPU, no mesh).

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

Not ported, and why:

* ``pipeline_fe`` "on", "deep" and "flat" (cross-slab overlap of the front
  end) are measured dead ends of the JAX package whose outputs equal "off"
  (ROADMAP: measured dead ends); this is the "off" form.
* ``mesh`` and ``use_mesh`` wait on the multi-GPU port (ROADMAP: port
  queue, multi-GPU).
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


class SlabRunner:
    """Constant-memory batched VAD over streams of any length."""

    def __init__(
        self,
        net: nn.Module,
        vad_config: VADConfig | None = None,
        n_channels: int = 2,
        sample_rate: int = 48000,
        slab_chunks: int = 128,  # 64 s
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
        b = len(readers)
        st = self.st
        valid_chunks = np.asarray([n // st.chunk_size for n in lengths], np.int64)
        max_chunks = int(valid_chunks.max(initial=0))
        if max_chunks == 0:
            return [StreamResult([], [[] for _ in self.alt_configs]) for _ in range(b)]
        n_slabs = -(-max_chunks // self.slab_chunks)
        dtype = np.int16 if raw16 else np.float32
        prefetcher = SlabPrefetcher(
            readers, valid_chunks, n_slabs=n_slabs, slab_chunks=self.slab_chunks, chunk_size=st.chunk_size,
            n_channels=st.n_channels, b_pad=b, workers=self.prefetch_workers, depth=self.prefetch_depth, dtype=dtype,
        )
        staging = _Staging((b, st.n_channels, self.slab_samples), dtype, (b, self.slab_chunks), self.device)
        try:
            with torch.inference_mode():
                loop = self._host_fsm_loop if self.use_host_fsm else self._device_fsm_loop
                outs = loop(prefetcher, staging, n_slabs, b)
        finally:
            prefetcher.close()
        k = len(self.alt_configs)
        if k:
            outs = fsm.WindowOutput(*(x.reshape(b, k + 1, -1) for x in outs))
        return results(st, outs, k)

    def _rows(self, b: int):
        """The FSM's rows for ``b`` streams (``fsm.machine_rows``): one a
        stream, or 1 + K (stream, config) rows with alternative machines."""
        return fsm.machine_rows(self.st.fsm_params if self.machines is None else self.machines, b)

    def _front_end(self, audio: torch.Tensor, cv: torch.Tensor, den_carry: dict):
        """One slab's window inputs -> (den_carry, min_vol, ratios, valid) [B, W]."""
        if audio.dtype == torch.int16:
            audio = audio.float() / 32768.0  # exact: a 16-bit integer over a power of two
        return offline.window_inputs_carry(self.net, self.st, audio, den_carry, cv.sum(1))

    def _dispatch(self, staging: _Staging, s: int, slab: np.ndarray, cv: np.ndarray, den_carry: dict):
        """Stage slab ``s`` and queue its front end."""
        audio, cv = staging.put(s, slab, cv)
        out = self._front_end(audio, cv, den_carry)
        staging.done(s)
        return out

    def _device_fsm_loop(self, prefetcher, staging, n_slabs: int, b: int) -> fsm.WindowOutput:
        """The FSM on the card, its carry chained from slab to slab; every
        slab's outputs stay on the card until one fetch at the end."""
        st = self.st
        rows, expand, params = self._rows(b)
        den_carry = offline.init_slab_carry((b, st.n_channels), st.downsample_rate, self.device)
        fsm_carry = None
        win_base = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        slab_outs = []
        for s in range(n_slabs):
            den_carry, *inputs = self._dispatch(staging, s, *prefetcher.get(), den_carry)
            mv, rt, va = (expand(x) for x in inputs)
            if fsm_carry is None:
                out, fsm_carry = fsm_cuda.scan_windows(st.fsm_shape, params, mv, rt, va, win_base=win_base)
            else:
                out, fsm_carry = fsm_cuda._scan_chained(st.fsm_shape, params, mv, rt, va, fsm_carry, win_base)
            win_base = win_base + self.windows_per_slab
            slab_outs.append(out)
        return self._fetch(slab_outs)

    def _fetch(self, slab_outs: list) -> fsm.WindowOutput:
        """Every slab's outputs, joined along the windows on the card and
        fetched once -> numpy [B, n_slabs * W]."""
        return fsm.WindowOutput(*(torch.cat(xs, dim=1).cpu().numpy() for xs in zip(*slab_outs)))

    def _host_fsm_loop(self, prefetcher, staging, n_slabs: int, b: int) -> fsm.WindowOutput:
        """The FSM in the native host decoder: slab s's window inputs go to
        pinned host buffers while slab s-1's are decoded, its carry (Kahan
        state included) chained exactly."""
        st = self.st
        on_card = self.device.type != "cpu"
        rows, expand, params = self._rows(b)
        den_carry = offline.init_slab_carry((b, st.n_channels), st.downsample_rate, self.device)
        host_carry = fsm_host.fresh_host_carry(st.fsm_shape, params, rows)
        w = self.windows_per_slab
        if on_card:
            pinned = [
                [torch.empty((b, w), dtype=dt, pin_memory=True) for dt in (torch.float32, torch.float32, torch.bool)]
                for _ in range(2)
            ]
        slab_outs = []

        def decode(s, inputs, copied):
            nonlocal host_carry
            if copied is not None:
                copied.synchronize()
            win_base = np.full((rows,), s * w, np.int32)
            out, host_carry = fsm_host.scan_windows_host(
                st.fsm_shape, params, *(expand(x.numpy()) for x in inputs), carry=host_carry, win_base=win_base
            )
            slab_outs.append(out)

        pending = None
        for s in range(n_slabs):
            den_carry, *inputs = self._dispatch(staging, s, *prefetcher.get(), den_carry)
            copied = None
            if on_card:
                for dst, src in zip(pinned[s % 2], inputs):
                    dst.copy_(src, non_blocking=True)
                inputs, copied = pinned[s % 2], torch.cuda.current_stream(self.device).record_event()
            if pending is not None:
                decode(*pending)  # slab s-1, while the card computes slab s
            pending = (s, inputs, copied)
        decode(*pending)
        return fsm.WindowOutput(*(np.concatenate(xs, axis=1) for xs in zip(*slab_outs)))
