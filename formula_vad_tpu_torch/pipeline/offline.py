"""Offline (whole-stream) scoring, chunk-parallel (port of the materialize-16k
path of ``formula_vad_tpu/pipeline/offline.py``).

The reference runs NSNet2 statelessly per 0.5 s chunk, and every buffer it
carries from chunk to chunk is a function of the input audio or a local
overlap. So everything except the speech FSM is computed for all chunks of
all streams at once: a decimating STFT, features, one stateless model run
over (streams x channels x chunks) rows of 54 frames, the gained iSTFT with
overlap-add, the band volumes and the channel ratios. Only the FSM stays
serial (``fsm_cuda.scan_windows``).

Tensors carry any leading batch shape; the stream axis of a batch is an
ordinary leading dimension. Carries are dicts of tensors whose leading
shape matches the audio's (without the sample axis).

Under bf16 activation storage (``ops/precision.set_io_dtype``) the spectra,
features, gains and the 16 kHz stream are bf16, cast at the JAX package's
cast points (``ops/stft.py``, ``models/nsnet2.py``); the carries stay in
their float32 storage dtype and are cast at each join, as there, and so do
the band volumes, ratios and validity the FSM reads.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..config import (
    NSNET2_CHUNK_16K,
    NSNET2_CONTEXT_FRAMES,
    NSNET2_N_BINS,
    NSNET2_N_FFT,
    NSNET2_N_FRAMES,
    NSNET2_N_HOP,
)
from ..ops import resample, stft, volume
from . import denoiser as den_mod
from . import fsm, fsm_cuda, vad

T_SCAN = NSNET2_N_FRAMES + NSNET2_CONTEXT_FRAMES  # GRU steps per chunk (54)
WARMUP_CHUNKS = 2


def init_slab_carry(lead: tuple, downsample_rate: int = 3, device="cpu") -> dict[str, torch.Tensor]:
    """Zero denoiser boundary state for audio of leading shape ``lead``
    (e.g. (B, C)): the previous slab's final raw hop, 4 feature frames, OLA
    tail and last 16 kHz sample, float32 under every storage tier."""
    z = lambda *s: torch.zeros(tuple(lead) + s, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "raw_tail": z(NSNET2_N_HOP * downsample_rate),
        "feat_ctx": z(NSNET2_CONTEXT_FRAMES, NSNET2_N_BINS),
        "out_tail": z(NSNET2_N_HOP),
        "last_sample": z(),
    }


def segmat_prod(audio: torch.Tensor, raw_tail: torch.Tensor | None, downsample_rate: int = 3) -> torch.Tensor:
    """The slab's raw segment-basis product [..., S + 1, 4 * 161] (predecim form)."""
    return stft.segmat_prod(audio, raw_tail, den_mod.WINDOW, NSNET2_N_FFT, downsample_rate)


def _model_input(feats: torch.Tensor, feat_ctx: torch.Tensor, k: int) -> torch.Tensor:
    """Per-chunk model input [..., K, 54, 161]: chunk k's 4 context frames are
    chunk k-1's last 4 frames (the carry's for chunk 0), then its 50 frames."""
    lead = feats.shape[:-2]
    main = feats.reshape(lead + (k, NSNET2_N_FRAMES, NSNET2_N_BINS))
    prev_tail = torch.cat(
        [feat_ctx[..., None, :, :].to(feats.dtype), main[..., :-1, NSNET2_N_FRAMES - NSNET2_CONTEXT_FRAMES :, :]],
        dim=-3,
    )
    return torch.cat([prev_tail, main], dim=-2)


def _gained_spectra(net: nn.Module, audio: torch.Tensor, carry: dict, downsample_rate: int = 3):
    """Decimating STFT, features, the stateless per-chunk model run and the
    clipped gains of a slab [..., C, S]. Returns (re, im, g, feats), each
    [..., C, K*50, 161]."""
    chunk48 = NSNET2_CHUNK_16K * downsample_rate
    if audio.shape[-1] % chunk48:
        raise ValueError(f"audio length {audio.shape[-1]} is not a multiple of the {chunk48}-sample chunk")
    prod = segmat_prod(audio, carry["raw_tail"], downsample_rate)
    lead = prod.shape[:-2]
    k = (prod.shape[-2] - 1) // NSNET2_N_FRAMES
    re, im = stft.segmat_spectra(prod, NSNET2_N_FFT)
    feats = den_mod.compute_features(re, im)
    model_in = _model_input(feats, carry["feat_ctx"], k)
    gains = net(model_in.reshape((-1, T_SCAN, NSNET2_N_BINS)), out_frames=NSNET2_N_FRAMES)
    gains = gains.reshape(lead + (k * NSNET2_N_FRAMES, NSNET2_N_BINS))
    g = torch.clamp(gains, den_mod.GAIN_MIN, den_mod.GAIN_MAX)
    return re, im, g, feats


def denoise_offline_16k(net: nn.Module, audio: torch.Tensor, carry: dict, downsample_rate: int = 3):
    """Chunk-parallel denoise of one slab [..., C, S], stopping at 16 kHz.

    Returns (completed16 [..., C, S / rate], prev16 [..., C] — the 16 kHz
    sample before the slab, new_carry)."""
    k = audio.shape[-1] // (NSNET2_CHUNK_16K * downsample_rate)
    re, im, g, feats = _gained_spectra(net, audio, carry, downsample_rate)
    ola = stft.istft_segmat(re * g, im * g, den_mod.WINDOW, NSNET2_N_FFT)
    head = ola[..., :NSNET2_N_HOP] + carry["out_tail"].to(ola.dtype)
    ola = torch.cat([head, ola[..., NSNET2_N_HOP:]], dim=-1)
    completed = ola[..., : k * NSNET2_CHUNK_16K]
    # Copies, not views: a view would keep the slab's audio, features and
    # OLA alive until the next slab is done with the carry. Each keeps the
    # carry's storage dtype (float32 under bf16 storage too).
    cdt = carry["feat_ctx"].dtype
    new_carry = {
        "raw_tail": audio[..., -NSNET2_N_HOP * downsample_rate :].clone(),
        "feat_ctx": feats[..., -NSNET2_CONTEXT_FRAMES:, :].to(cdt, copy=True),
        "out_tail": ola[..., k * NSNET2_CHUNK_16K :].to(cdt, copy=True),
        "last_sample": completed[..., -1].to(cdt, copy=True),
    }
    return completed, carry["last_sample"].to(completed.dtype), new_carry


def denoise_offline_carry(net: nn.Module, audio: torch.Tensor, carry: dict, downsample_rate: int = 3):
    """Denoise one slab [..., C, S] with explicit boundary state -> (denoised
    [..., C, S], new_carry). Chaining slabs matches one whole-stream run up
    to the matmuls' batch-shape-dependent rounding (tests hold it at 1e-6)."""
    completed, prev16, new_carry = denoise_offline_16k(net, audio, carry, downsample_rate)
    up, _ = resample.upsample(completed, prev16, downsample_rate)
    return up, new_carry


def denoise_offline(net: nn.Module, audio: torch.Tensor, downsample_rate: int = 3) -> torch.Tensor:
    """Denoise whole streams [..., C, T] (T a multiple of the chunk)."""
    carry = init_slab_carry(audio.shape[:-1], downsample_rate, audio.device)
    up, _ = denoise_offline_carry(net, audio, carry, downsample_rate)
    return up


def denoise_span(
    net: nn.Module, audio: torch.Tensor, start_chunk: int, end_chunk: int, downsample_rate: int = 3
) -> torch.Tensor:
    """Recompute the denoised audio of chunks [start_chunk, end_chunk).

    Chunk k's output depends on input chunks k-2..k only, so a zero-state run
    starting WARMUP_CHUNKS earlier reproduces the span of a whole-stream run
    (up to the matmuls' batch-shape-dependent rounding)."""
    chunk48 = NSNET2_CHUNK_16K * downsample_rate
    k0 = max(0, start_chunk - WARMUP_CHUNKS)
    den = denoise_offline(net, audio[..., k0 * chunk48 : end_chunk * chunk48], downsample_rate)
    return den[..., (start_chunk - k0) * chunk48 :]


@functools.lru_cache(maxsize=32)
def _window_chunks(k: int, n_windows: int, chunk: int, fft_size: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Which chunks each of ``n_windows`` windows overlaps, on ``device``:
    (first chunk, last chunk (both clipped to the K chunks), samples in the
    first, samples in the last (float32), whether both are one, end sample).
    Made once per shape and device, so a slab loop copies nothing to the
    card for them."""
    w_start = np.arange(n_windows) * fft_size
    w_end = w_start + fft_size
    c0 = w_start // chunk
    c1 = (w_end - 1) // chunk
    n_in_c0 = np.minimum((c0 + 1) * chunk - w_start, fft_size)
    host = (
        np.clip(c0, 0, k - 1), np.clip(c1, 0, k - 1), n_in_c0.astype(np.float32),
        (fft_size - n_in_c0).astype(np.float32), c0 == c1, w_end,
    )
    return tuple(torch.from_numpy(x).to(device) for x in host)


def _ratios_valid(st: vad.VADStatics, audio: torch.Tensor, n_valid_chunks: torch.Tensor, n_windows: int):
    """Per-window channel-volume ratios and validity from the raw audio
    [B, C, T]: (ratios [B, W] f32, valid [B, W] bool)."""
    b, c, t = audio.shape
    chunk = st.chunk_size
    k = t // chunk
    ratio_chunk, _, _ = volume.volume_analysis(audio.reshape(b, c, k, chunk).transpose(1, 2))  # [B, K]
    c0, c1, w0, w1, one_chunk, w_end = _window_chunks(k, n_windows, chunk, st.fft_size, audio.device)
    r0, r1 = ratio_chunk[:, c0], ratio_chunk[:, c1]
    weighted = (w0 * r0 + w1 * r1) / np.float32(st.fft_size)
    # Windows inside one chunk take that chunk's ratio verbatim (the weighted
    # form rounds differently), so seg_ratio stays a sum of chunk ratios.
    ratios = torch.where(one_chunk, r0, weighted)
    valid = w_end[None, :] <= n_valid_chunks[:, None].long() * chunk
    return ratios, valid


def window_inputs_carry(
    net: nn.Module, st: vad.VADStatics, audio: torch.Tensor, den_carry: dict, n_valid_chunks: torch.Tensor
):
    """The FSM's per-window inputs for a batch of slabs [B, C, T], threading
    the denoiser boundary carry (materialize-16k form: the 16 kHz denoised
    stream feeds the upsample-folded band DFT).

    Returns (new_den_carry, min_vol [B, W], ratios [B, W], valid [B, W])."""
    k = audio.shape[-1] // st.chunk_size
    audio = audio[..., : k * st.chunk_size]
    n_windows = (k * st.chunk_size) // st.fft_size
    completed16, prev16, den_carry = denoise_offline_16k(net, audio, den_carry, st.downsample_rate)
    band = stft.band_volume_16k(
        completed16, prev16, vad.hann(st.fft_size), st.fft_size, st.norm_factor,
        st.min_bin, st.max_bin, n_windows, rate=st.downsample_rate,
    )  # [B, C, W]
    min_vol = torch.amin(band, dim=1)
    ratios, valid = _ratios_valid(st, audio, n_valid_chunks, n_windows)
    return den_carry, min_vol.contiguous(), ratios.contiguous(), valid.contiguous()


def window_inputs_batch(
    net: nn.Module, st: vad.VADStatics, audio: torch.Tensor, n_valid_chunks: torch.Tensor | None = None
):
    """Everything but the FSM, for B fresh streams.

    Args:
      audio: [B, C, T] float32, T a multiple of the chunk.
      n_valid_chunks: [B] real chunk counts (ragged batches); default all.
    Returns:
      (min_vol, ratios [B, W] f32, valid [B, W] bool) — the FSM's inputs.
    """
    b, c, t = audio.shape
    if n_valid_chunks is None:
        n_valid_chunks = torch.full((b,), t // st.chunk_size, dtype=torch.int32, device=audio.device)
    carry = init_slab_carry((b, c), st.downsample_rate, audio.device)
    _, min_vol, ratios, valid = window_inputs_carry(net, st, audio, carry, n_valid_chunks)
    return min_vol, ratios, valid


def window_inputs(net: nn.Module, st: vad.VADStatics, audio: torch.Tensor, n_valid_chunks: int):
    """``window_inputs_batch`` for one stream [C, T] -> (min_vol, ratios, valid) [W]."""
    nv = torch.tensor([n_valid_chunks], dtype=torch.int32, device=audio.device)
    return tuple(x[0] for x in window_inputs_batch(net, st, audio[None], nv))


def process_batch_offline(
    net: nn.Module,
    st: vad.VADStatics,
    audio: torch.Tensor,
    n_valid_chunks: torch.Tensor | None = None,
    fsm_params: fsm.FSMParams | None = None,
):
    """Batched whole-stream VAD: the front end, then one FSM scan over the
    [B, W] windows (the device kernel for CUDA tensors, its plain version on
    the CPU) with ``fsm_params`` (default ``st.fsm_params``; the FSM's shape
    is always ``st.fsm_shape``). K machines a stream
    (``vad.stack_machine_params``) share the one front end: its window
    inputs repeated K times a stream make one scan at [B * K, W] over
    (stream, config) rows (``fsm.tile_rows``).

    Returns (WindowOutput [B, W] or, for K machines, [B, K, W]; valid [B, W])."""
    min_vol, ratios, valid = window_inputs_batch(net, st, audio, n_valid_chunks)
    params = st.fsm_params if fsm_params is None else fsm_params
    b, w = min_vol.shape
    _, expand, row_params = fsm.machine_rows(params, b)
    win_out, _ = fsm_cuda.scan_windows(st.fsm_shape, row_params, *(expand(x) for x in (min_vol, ratios, valid)))
    if fsm.n_machines(params):
        win_out = type(win_out)(*(x.reshape(b, -1, w) for x in win_out))
    return win_out, valid


def process_stream_offline(
    net: nn.Module,
    st: vad.VADStatics,
    audio: torch.Tensor,
    n_valid_chunks: int | None = None,
    fsm_params: fsm.FSMParams | None = None,
):
    """Whole-stream VAD of one stream [C, T] (T a multiple of the chunk;
    ``n_valid_chunks`` real chunks, default all): ``process_batch_offline``
    on a batch of one.

    Returns (WindowOutput [W] ([K, W] for K machines), valid [W]), flat over
    windows."""
    k = audio.shape[-1] // st.chunk_size
    nv = torch.tensor([k if n_valid_chunks is None else n_valid_chunks], dtype=torch.int32, device=audio.device)
    win_out, valid = process_batch_offline(net, st, audio[None, :, : k * st.chunk_size], nv, fsm_params)
    return type(win_out)(*(x[0] for x in win_out)), valid[0]


def segments_from_offline(st: vad.VADStatics, win_out: fsm.WindowOutput) -> list[dict]:
    """One stream's segments from ``process_stream_offline``'s outputs (on
    any device; fetched to the host here)."""
    return vad.segments_from_outputs(st, type(win_out)(*(x.cpu() for x in win_out)))
