"""The VAD a 0.5 s chunk at a time, its statics and segment assembly (port
of ``formula_vad_tpu/pipeline/vad.py``).

``chunk_step(net, st, carry, chunk)`` is one pipeline chunk [..., C,
24000] of any leading batch shape: the stereo volume ratio, the denoiser
chunk (``denoiser.denoise_chunk``), the re-chunking of the denoised audio
into 1024-sample windows across chunk edges (each chunk finishes 23 or 24
of ``max_windows`` = 24 slots), their speech-band volume and the FSM window
scan continuing its carry (``fsm_cuda.scan_windows``: the kernel on the
card, the plain version on the CPU). ``process_stream`` steps it over whole
streams. A chunk's host work is arithmetic of the valid chunk count, so
the loop reads nothing back from the card.

``run_fsm=False`` skips the scan and returns its inputs for a host decode
(the host-FSM serving tier, ``parallel/online.py``).

K machines a stream (the reference's ``alt_vad_machine_configs``, a
parameter sweep): ``stack_machine_params`` stacks K configs that share the
rings' sizes and the speech band, and a ``fsm_params`` so stacked runs the
scan over (stream, config) rows, stream-major (``fsm.tile_rows``): one
scan at [B * K, max_windows] behind one front end, the FSM carry holding
B * K rows and the windows' outputs [..., K, max_windows].
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import VADConfig, VADMachineConfig
from ..ops import dft, stft, volume, windows
from . import denoiser, fsm, fsm_cuda


class VADStatics(NamedTuple):
    sample_rate: int
    n_channels: int
    fft_size: int
    chunk_size: int  # denoiser chunk at the pipeline rate (24000 at 48 kHz)
    max_windows: int  # most complete FFT windows a chunk can finish
    min_bin: int  # speech band lower bin (inclusive)
    max_bin: int  # speech band upper bin (inclusive)
    norm_factor: float  # magnitude normalization (1/512 for the periodic Hann at 1024)
    downsample_rate: int
    fsm_shape: fsm.FSMShape
    fsm_params: fsm.FSMParams


def statics_from_config(
    vad_config: VADConfig, sample_rate: int = 48000, n_channels: int = 2
) -> VADStatics:
    if sample_rate != 48000:
        raise ValueError("only 48000 Hz input is supported")
    fft_size = vad_config.fft_size
    chunk = 24000
    cfg = vad_config.vad_machine_config
    w = windows.hann_periodic(fft_size)
    nf = float(windows.window_norm_factor(w) / np.float32(fft_size))
    shape, params = fsm.statics_from_config(cfg, sample_rate, fft_size)
    return VADStatics(
        sample_rate=sample_rate,
        n_channels=n_channels,
        fft_size=fft_size,
        chunk_size=chunk,
        max_windows=chunk // fft_size + 1,
        min_bin=dft.freq_to_bin(cfg.speech_min_freq, fft_size, sample_rate),
        max_bin=dft.freq_to_bin(cfg.speech_max_freq, fft_size, sample_rate),
        norm_factor=nf,
        downsample_rate=sample_rate // 16000,
        fsm_shape=shape,
        fsm_params=params,
    )


@functools.lru_cache(maxsize=None)
def hann(fft_size: int) -> np.ndarray:
    return windows.hann_periodic(fft_size)


def stack_machine_params(st: VADStatics, configs) -> fsm.FSMParams:
    """K machine configs as one FSMParams of [K] leaves. They must share the
    rings' sizes (``st.fsm_shape``) and the speech band; thresholds and
    durations may differ."""
    stacked = []
    for cfg in configs:
        shape, params = fsm.statics_from_config(cfg, st.sample_rate, st.fft_size)
        if shape != st.fsm_shape:
            raise ValueError(
                "alt machine config changes ring-buffer sizes; run it as a "
                f"separate group (got {shape}, expected {st.fsm_shape})"
            )
        if (
            dft.freq_to_bin(cfg.speech_min_freq, st.fft_size, st.sample_rate) != st.min_bin
            or dft.freq_to_bin(cfg.speech_max_freq, st.fft_size, st.sample_rate) != st.max_bin
        ):
            raise ValueError("alt machine config changes the speech band")
        stacked.append(params)
    return fsm.FSMParams(*(np.stack(xs).astype(dt) for xs, dt in zip(zip(*stacked), fsm.PARAM_DTYPES)))


def machines_of(st: VADStatics, vad_config: VADConfig) -> fsm.FSMParams | None:
    """The primary machine and the ``alt_vad_machine_configs`` stacked,
    the primary first, or None without alternatives."""
    alt = tuple(vad_config.alt_vad_machine_configs or ())
    return stack_machine_params(st, (vad_config.vad_machine_config,) + alt) if alt else None


def _machines(fsm_params: fsm.FSMParams) -> int:
    """K of a stacked ``fsm_params``, 0 for one machine a stream; refuses
    leaves of other shapes."""
    k = fsm.n_machines(fsm_params)
    if any(np.shape(x) != ((k,) if k else ()) for x in fsm_params):
        raise ValueError(f"fsm_params: every leaf must be a scalar or [K], got {[np.shape(x) for x in fsm_params]}")
    return k


def init_carry(st: VADStatics, lead: tuple = (), device="cpu", fsm_params: fsm.FSMParams | None = None) -> dict:
    """Fresh carry for streams of leading shape ``lead``: the JAX carry's
    fields (the denoiser's, the window re-chunking buffer ``fft_buf``, its
    fill ``fft_fill`` and ``win_base`` as int32, ``prev_ratio``), float32
    copies, and ``fsm`` None: the first scan starts fresh machines (K a
    stream for a stacked ``fsm_params``) and returns the kernel's packed
    carry (``fsm.fresh_carry``'s layout)."""
    _machines(st.fsm_params if fsm_params is None else fsm_params)
    lead = tuple(lead)
    return {
        "denoiser": denoiser.init_carry(st.n_channels, device, lead),
        "fft_buf": torch.zeros(lead + (st.n_channels, st.fft_size), dtype=torch.float32, device=device),
        "fft_fill": torch.zeros(lead, dtype=torch.int32, device=device),
        "prev_ratio": torch.zeros(lead, dtype=torch.float32, device=device),
        "win_base": torch.zeros(lead, dtype=torch.int32, device=device),
        "fsm": None,
    }


class ChunkOutput(NamedTuple):
    # The FSM's outputs a window slot, each [..., max_windows] ([..., K,
    # max_windows] for K machines a stream); None without run_fsm.
    windows: fsm.WindowOutput | None
    window_valid: torch.Tensor  # [..., max_windows] bool
    denoised: torch.Tensor  # [..., C, chunk] (zero-width without collect_denoised)
    min_vol: torch.Tensor  # [..., max_windows] speech-band volume (FSM input)
    ratios: torch.Tensor  # [..., max_windows] weighted channel ratio (FSM input)
    win_indices: torch.Tensor  # [..., max_windows] global window indices (int32)


@functools.lru_cache(maxsize=None)
def _slots(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _accumulate_windows(st: VADStatics, carry: dict, denoised: torch.Tensor, shared_start: int | None = None):
    """Re-chunk denoised audio [..., C, chunk] into fft_size windows across
    chunk edges -> (new_buf, new_fill, frames [..., C, max_windows, fft],
    n_windows, win_indices, valid [..., max_windows]).

    The framing reads ``max_windows`` windows from offset fft_size - fill of
    the carried tail and the chunk, zero-padded: a valid window never
    reaches the padding, and invalid slots are masked downstream.
    ``shared_start`` is that offset when every valid row shares it, as the
    callers know from their chunk counts (the JAX package's lockstep fast
    path): then the framing is one slice. Without it each row's offset is
    read from the carry on the card, a per-row gather."""
    fft = st.fft_size
    fill = carry["fft_fill"]
    ext = torch.cat([carry["fft_buf"].to(denoised.dtype), denoised], dim=-1)  # [..., C, fft + chunk]
    span = st.max_windows * fft
    ext_p = torch.nn.functional.pad(ext, (0, max(0, span + fft - ext.shape[-1])))
    if shared_start is None:
        start = (fft - fill).long()[..., None, None] + _slots(span, ext.device)
        frames = torch.gather(ext_p, -1, start.expand(ext.shape[:-1] + (span,)))
    else:
        frames = ext_p[..., shared_start : shared_start + span]
    frames = frames.reshape(ext.shape[:-1] + (st.max_windows, fft))
    n_windows = torch.div(fill + st.chunk_size, fft, rounding_mode="floor")
    slots = _slots(st.max_windows, ext.device)
    valid = slots < n_windows[..., None]
    win_indices = carry["win_base"][..., None] + slots
    new_fill = fill + st.chunk_size - n_windows * fft
    return ext[..., -fft:].clone(), new_fill, frames, n_windows, win_indices, valid


def chunk_step(
    net,
    st: VADStatics,
    carry: dict,
    chunk: torch.Tensor,
    chunk_valid: bool | torch.Tensor = True,
    fsm_params: fsm.FSMParams | None = None,
    run_fsm: bool = True,
    collect_denoised: bool = True,
    shared_start: int | None = None,
    chained: bool = False,
) -> tuple[dict, ChunkOutput]:
    """One pipeline chunk [..., C, chunk_size] -> (new carry, ChunkOutput).

    ``chunk_valid`` (a bool, or a bool tensor of the leading shape) False
    marks padding chunks of ragged batches: their carry is frozen and every
    output masked. ``collect_denoised=False`` returns a zero-width
    ``denoised``. ``run_fsm=False`` skips the FSM scan: ``windows`` is None,
    the carry's FSM part passes through untouched, and ``min_vol``,
    ``ratios``, ``win_indices`` and ``window_valid`` are the inputs of a
    host decode (``fsm_host.scan_windows_host``).
    ``shared_start``: see ``_accumulate_windows``.
    ``chained=True`` says the carry's FSM part was returned by the previous
    step and nothing has written it since, so the scan continues it without
    reading its ring indices back (``fsm_cuda._scan_chained``: no sync on the
    card); a carry from elsewhere is checked. The first scan (``fsm`` None)
    starts fresh machines at ``win_base``. A stacked ``fsm_params`` runs K
    machines a stream as (stream, config) rows of the one scan."""
    params = st.fsm_params if fsm_params is None else fsm_params
    k = _machines(params)
    lead = chunk.shape[:-2]
    cv = None if chunk_valid is True else torch.as_tensor(chunk_valid, dtype=torch.bool, device=chunk.device)

    cur_ratio, _, _ = volume.volume_analysis(chunk)
    den_carry, denoised = denoiser.denoise_chunk(net, carry["denoiser"], chunk, st.downsample_rate)
    fill = carry["fft_fill"]
    new_buf, new_fill, frames, n_windows, win_indices, valid = _accumulate_windows(st, carry, denoised, shared_start)
    mags = stft.magnitude_windows(frames, hann(st.fft_size), st.fft_size, st.norm_factor)
    # The speech band's volume is the SUM of its magnitude bins, then the
    # smallest over the channels.
    min_vol = torch.amin(torch.sum(mags[..., st.min_bin : st.max_bin + 1], dim=-1), dim=-2)
    # Window 0 may straddle the previous chunk: its ratio is weighted by the
    # samples it takes from each.
    f32fill = fill.float()
    w0_ratio = (f32fill * carry["prev_ratio"] + (st.fft_size - f32fill) * cur_ratio) / np.float32(st.fft_size)
    ratios = torch.where(_slots(st.max_windows, chunk.device) == 0, w0_ratio[..., None], cur_ratio[..., None])
    if cv is not None:
        valid = valid & cv[..., None]

    b, w = math.prod(lead), st.max_windows
    if not run_fsm:
        win_out, fsm_carry = None, carry["fsm"]
    else:
        _, expand, params = fsm.machine_rows(params, b)
        flat = [expand(x.reshape(b, w).contiguous()) for x in (min_vol, ratios, valid)]
        win_base = expand(carry["win_base"].reshape(b))
        if carry["fsm"] is not None and chained:
            win_out, fsm_carry = fsm_cuda._scan_chained(st.fsm_shape, params, *flat, carry["fsm"], win_base)
        else:
            win_out, fsm_carry = fsm_cuda.scan_windows(st.fsm_shape, params, *flat, carry["fsm"], win_base)

    new_carry = {
        "denoiser": den_carry,
        "fft_buf": new_buf,
        "fft_fill": new_fill,
        "prev_ratio": cur_ratio,
        "win_base": carry["win_base"] + n_windows,
    }
    if cv is not None:  # padding chunks freeze the carry; their windows already froze the FSM's
        def freeze(new, old):
            if isinstance(new, dict):
                return {k: freeze(new[k], old[k]) for k in new}
            return torch.where(cv.reshape(lead + (1,) * (new.dim() - len(lead))), new, old)

        new_carry = freeze(new_carry, {k: carry[k] for k in new_carry})
    new_carry["fsm"] = fsm_carry
    machine_shape = lead + ((k,) if k else ()) + (w,)
    out = ChunkOutput(
        windows=None if win_out is None else fsm.WindowOutput(*(x.reshape(machine_shape) for x in win_out)),
        window_valid=valid,
        denoised=denoised if collect_denoised else denoised[..., :0],
        min_vol=min_vol,
        ratios=ratios,
        win_indices=win_indices,
    )
    return new_carry, out


def _host_mask(chunk_valids, lead: tuple, n_chunks: int) -> np.ndarray | None:
    if chunk_valids is None:
        return None
    mask = chunk_valids.cpu().numpy() if torch.is_tensor(chunk_valids) else np.asarray(chunk_valids)
    return np.broadcast_to(mask.astype(bool), lead + (n_chunks,))


def process_stream(
    net,
    st: VADStatics,
    audio: torch.Tensor,
    carry: dict | None = None,
    chunk_valids=None,
    collect_denoised: bool = False,
    fsm_params: fsm.FSMParams | None = None,
) -> tuple[dict, ChunkOutput]:
    """Step ``chunk_step`` over whole streams [..., C, T] (only whole chunks;
    the reference never processes a partial one).

    ``chunk_valids`` [..., T // chunk_size] bool (numpy or a tensor, read
    once before the loop) masks padding chunks. Every framing offset follows
    from the valid chunk counts, so the loop passes it as ``shared_start``
    whenever the valid rows share it, and chains the FSM carry: between the
    uploads before the loop and the caller's fetch after it nothing is read
    back from the card. Returns (final carry, ChunkOutput with every field
    stacked over chunks after the leading shape: [..., n_chunks, ...]; the
    windows [..., n_chunks, K, max_windows] for K machines a stream)."""
    lead = tuple(audio.shape[:-2])
    n_chunks = audio.shape[-1] // st.chunk_size
    dev = audio.device
    if carry is None:
        carry = init_carry(st, lead, dev, fsm_params)
        fills = np.zeros(lead, np.int64)
    else:
        fills = carry["fft_fill"].cpu().numpy().astype(np.int64)
    mask = _host_mask(chunk_valids, lead, n_chunks)
    mask_dev = None if mask is None else torch.from_numpy(mask.copy()).to(dev)
    outs = []
    for k in range(n_chunks):
        rows = np.ones(lead, bool) if mask is None else mask[..., k]
        cv = True if rows.all() else mask_dev[..., k]
        shared = set(fills[rows].tolist())
        start = st.fft_size - shared.pop() if len(shared) == 1 else (st.fft_size if not shared else None)
        chunk = audio[..., k * st.chunk_size : (k + 1) * st.chunk_size]
        carry, out = chunk_step(
            net, st, carry, chunk, cv, fsm_params, collect_denoised=collect_denoised,
            shared_start=start, chained=k > 0,
        )
        fills = np.where(rows, (fills + st.chunk_size) % st.fft_size, fills)
        outs.append(out)
    d = len(lead)
    stacked = ChunkOutput(
        windows=fsm.WindowOutput(*(torch.stack(xs, dim=d) for xs in zip(*(o.windows for o in outs)))),
        **{f: torch.stack([getattr(o, f) for o in outs], dim=d) for f in ChunkOutput._fields[1:]},
    )
    return carry, stacked


def segments_from_outputs(st: VADStatics, windows_out: fsm.WindowOutput) -> list[dict]:
    """One stream's per-window FSM outputs (numpy or CPU tensors, any shape,
    read in order) -> speech segments with the reference's +/-2 s recording
    margins."""
    margin = VADMachineConfig().recording_margin_samples(st.sample_rate)
    valid = np.asarray(windows_out.seg_valid).reshape(-1)
    starts = np.asarray(windows_out.seg_start_win).reshape(-1)
    ends = np.asarray(windows_out.seg_end_win).reshape(-1)
    ratios = np.asarray(windows_out.seg_ratio).reshape(-1)
    mets = np.asarray(windows_out.seg_met_sec).reshape(-1)
    segs = []
    for i in np.nonzero(valid)[0]:
        s = int(starts[i]) * st.fft_size
        e = int(ends[i]) * st.fft_size
        segs.append(
            {
                "sample_from": max(0, s - margin),
                "sample_to": e + margin,
                "avg_channel_vol_ratio": float(ratios[i]),
                "vad_met_sec": float(mets[i]),
            }
        )
    return segs
