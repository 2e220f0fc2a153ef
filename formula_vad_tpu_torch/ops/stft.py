"""Half-overlap STFT / iSTFT and the speech-band volumes, as matmuls.

Port of the live parts of ``formula_vad_tpu/ops/stft.py``. The bases are
built in numpy exactly as there (float64, then float32), so they are
bit-identical to the JAX package's; the products run in torch.

Two families: the per-chunk forms of the streaming step (``frame_signal``,
``stft``, ``istft_overlap_add``, ``magnitude_windows``: frames, then the
DFT of ``ops/dft.py``), and the offline path's segment-basis forms
(``segmat_prod``, ``istft_segmat``, ``band_volume_16k``), which fold the
window and the framing into one basis.

Dropped TPU layout tricks: the 768-lane column padding of the segment basis
(consumers only read the first 4*n_bins columns) and the iSTFT lane pad.

Under bf16 activation storage (``precision.io_cast``) the products' operands
are cast where the JAX package casts them, so the spectra, the OLA product
and the 16 kHz superframes are bf16; the band magnitude sums stay float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import dft, precision


# ---------------------------------------------------------------------------
# Bases (numpy)
# ---------------------------------------------------------------------------


def segmat_basis(window: np.ndarray, n_fft: int) -> np.ndarray:
    """Combined (window + rDFT) basis for the half-overlap STFT:
    [hop, 4 * n_bins], columns [re | im] x [top | bottom].

    Frame f = [seg_f | seg_{f+1}] (hop-sized blocks), so its windowed rDFT is
    seg_f @ top + seg_{f+1} @ bottom (see ``segmat_spectra``)."""
    cos_m, sin_m = dft.rdft_matrices(n_fft)
    hop = n_fft // 2
    wc = window[:, None] * cos_m
    ws = window[:, None] * sin_m
    return np.concatenate([wc[:hop], ws[:hop], wc[hop:], ws[hop:]], axis=1).astype(np.float32)


def inv_segmat_basis(window: np.ndarray, n_fft: int) -> np.ndarray:
    """Inverse basis [2 * n_bins, n_fft] mapping [re | im] to the windowed
    time frame (kissfft's 1/n_fft folded in); columns [0:hop] are the
    frame's top half, [hop:] its bottom half."""
    cos_i, sin_i = dft.irdft_matrices(n_fft)
    scale = window.astype(np.float64) / n_fft
    return np.concatenate([cos_i * scale, -sin_i * scale], axis=0).astype(np.float32)


def band16_basis(
    window: np.ndarray, n_fft: int, min_bin: int, max_bin: int, rate: int
) -> np.ndarray:
    """Upsample-folded band DFT basis [n_fft + 1, rate * 2 * n_band], built
    in float64 and rounded to float32.

    One superframe of n_fft 16 kHz samples, plus the sample before it (the
    lerp carry, row 0), covers ``rate`` adjacent n_fft-sample windows at
    48 kHz; the lerp upsample is linear, so it folds into the windowed band
    DFT. Column blocks per window w: [re(n_band) | im(n_band)]."""
    window = np.asarray(window, np.float32).astype(np.float64)
    n_band = max_bin - min_bin + 1
    u = np.zeros((rate * n_fft, n_fft + 1))
    i = np.arange(n_fft)
    for j in range(rate):
        f = (j + 1) / rate
        rows = i * rate + j
        if j == rate - 1:
            u[rows, i + 1] = 1.0
        else:
            u[rows, i] = 1.0 - f
            u[rows, i + 1] = f
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(min_bin, max_bin + 1, dtype=np.float64)[None, :]
    phase = -2.0 * np.pi * n * k / n_fft
    wd = np.concatenate(
        [window[:, None] * np.cos(phase), window[:, None] * np.sin(phase)], axis=1
    )
    blocks = []
    for w in range(rate):
        a = np.zeros((rate * n_fft, 2 * n_band))
        a[w * n_fft : (w + 1) * n_fft, :] = wd
        blocks.append(u.T @ a)
    return np.concatenate(blocks, axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, window_bytes: bytes, args: tuple, device: torch.device) -> torch.Tensor:
    window = np.frombuffer(window_bytes, np.float32)
    basis_fns = {"segmat": segmat_basis, "inv": inv_segmat_basis, "band16": band16_basis, "window": np.copy}
    return torch.from_numpy(basis_fns[kind](window, *args)).to(device)


def _basis(kind: str, window: np.ndarray, args: tuple, device: torch.device) -> torch.Tensor:
    return _on_device(kind, np.asarray(window, np.float32).tobytes(), args, torch.device(device))


# ---------------------------------------------------------------------------
# Per-chunk STFT (the streaming step)
# ---------------------------------------------------------------------------


def _half_overlap(what: str, n_fft: int, hop: int) -> None:
    if n_fft != 2 * hop:
        raise ValueError(f"{what}: only half overlap (hop = n_fft / 2) is ported, got n_fft {n_fft}, hop {hop}")


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Slice ``x[..., T]`` into half-overlapping frames [..., n_frames,
    n_fft], n_frames = (T - n_fft) // hop + 1 (no padding): two shifted
    reshapes joined, as in the JAX package. Other hops raise ValueError."""
    _half_overlap("frame_signal", n_fft, hop)
    n_frames = (x.shape[-1] - n_fft) // hop + 1
    segs = x[..., : (n_frames + 1) * hop].reshape(x.shape[:-1] + (n_frames + 1, hop))
    return torch.cat([segs[..., :-1, :], segs[..., 1:, :]], dim=-1)


def stft_frames(frames: torch.Tensor, window: np.ndarray, n_fft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed forward DFT of pre-gathered frames [..., n_fft]."""
    return dft.rdft(frames * _basis("window", window, (), frames.device), n_fft)


def stft(x: torch.Tensor, window: np.ndarray, n_fft: int, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed forward STFT at half overlap: x[..., T] -> (re, im), each
    [..., n_frames, n_bins]."""
    return stft_frames(frame_signal(x, n_fft, hop), window, n_fft)


def istft_overlap_add(
    re: torch.Tensor, im: torch.Tensor, window: np.ndarray, n_fft: int, hop: int, out_len: int
) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add, kissfft's 1/n_fft folded into
    the synthesis window: frame f of [..., n_frames, n_bins] adds at offset
    f * hop of an ``out_len`` buffer. At half overlap the even and the odd
    frames are each one contiguous stream, added in two shifted adds (no
    scatter). Other hops raise ValueError."""
    _half_overlap("istft_overlap_add", n_fft, hop)
    frames = dft.irdft_kiss(re, im, n_fft)
    scale = np.asarray(window, np.float32) * np.float32(1.0 / n_fft)
    frames = frames * _basis("window", scale, (), frames.device).to(frames.dtype)
    lead = frames.shape[:-2]
    out = frames.new_zeros(lead + (out_len,))
    even = frames[..., 0::2, :].reshape(lead + (-1,))
    odd = frames[..., 1::2, :].reshape(lead + (-1,))
    out[..., : even.shape[-1]] += even
    out[..., hop : hop + odd.shape[-1]] += odd
    return out


def magnitude_windows(frames: torch.Tensor, window: np.ndarray, n_fft: int, norm_factor: float) -> torch.Tensor:
    """Magnitude bins |X| * norm_factor [..., n_bins] of non-overlapping
    analysis windows [..., n_fft]. The magnitudes feed the FSM's decisions,
    so they are taken in float32 under every storage tier."""
    re, im = dft.rdft(frames * _basis("window", window, (), frames.device).to(frames.dtype), n_fft)
    return dft.magnitude(re.float(), im.float()) * np.float32(norm_factor)


# ---------------------------------------------------------------------------
# Products (torch)
# ---------------------------------------------------------------------------


def segmat_prod(
    audio: torch.Tensor,
    raw_tail: torch.Tensor | None,
    window: np.ndarray,
    n_fft: int,
    downsample_rate: int = 3,
) -> torch.Tensor:
    """Raw segment-basis product [..., S + 1, 4 * n_bins] of 48 kHz audio
    [..., T] (T a multiple of hop * rate), decimated first.

    The JAX package decimates with a 0/1 select matmul at HIGH precision,
    which is exact (one 1.0 * x term per output); the strided slice reads
    the same samples, so the decimated segments are bit-identical. (At the
    'default' level its select matmul rounds the samples to bf16, which the
    basis product here does anyway.) The prepended initial segment is the
    previous slab's final raw hop (``raw_tail``, [..., hop * rate]), or
    zeros at stream start.

    Under bf16 storage the JAX package casts the 48 kHz segments before its
    select matmul; the cast of the selected samples is the same value as
    the select of the cast samples, so only the samples read are cast."""
    hop = n_fft // 2
    t = audio.shape[-1]
    x16 = precision.io_cast(audio[..., ::downsample_rate])
    segs16 = x16.reshape(audio.shape[:-1] + (t // (hop * downsample_rate), hop))
    if raw_tail is None:
        tail16 = segs16.new_zeros(segs16.shape[:-2] + (1, hop))
    else:
        tail16 = precision.io_cast(raw_tail[..., None, ::downsample_rate]).to(segs16.dtype)
    segs = torch.cat([tail16, segs16], dim=-2)
    basis = precision.io_cast(_basis("segmat", window, (n_fft,), audio.device))
    return precision.matmul(segs, basis, "stft")


def segmat_spectra(prod: torch.Tensor, n_fft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Finish the segment STFT: frame f = top half of segment f + bottom
    half of segment f + 1. Returns (re, im), each [..., S, n_bins]."""
    n_bins = n_fft // 2 + 1
    z = prod[..., :-1, : 2 * n_bins] + prod[..., 1:, 2 * n_bins : 4 * n_bins]
    return z[..., :n_bins], z[..., n_bins : 2 * n_bins]


def istft_segmat(
    re: torch.Tensor, im: torch.Tensor, window: np.ndarray, n_fft: int
) -> torch.Tensor:
    """Half-overlap windowed iSTFT + overlap-add as one matmul and a
    shift-add: output segment s = top half of frame s + bottom half of
    frame s - 1. Returns [..., (n_frames + 1) * hop]; the final hop is the
    dangling OLA tail."""
    hop = n_fft // 2
    z = torch.cat([precision.io_cast(re), precision.io_cast(im)], dim=-1)
    prod = precision.matmul(z, precision.io_cast(_basis("inv", window, (n_fft,), re.device)), "istft")
    top = prod[..., :hop]
    bot = prod[..., hop:]
    lead = prod.shape[:-2]
    zero = prod.new_zeros(lead + (1, hop))
    segs = torch.cat([top, zero], dim=-2) + torch.cat([zero, bot], dim=-2)
    return segs.reshape(lead + (-1,))


def band_volume_16k(
    x16: torch.Tensor,
    prev: torch.Tensor,
    window: np.ndarray,
    n_fft: int,
    norm_factor: float,
    min_bin: int,
    max_bin: int,
    n_windows: int,
    rate: int = 3,
) -> torch.Tensor:
    """Speech-band volumes of ``n_windows`` 48 kHz analysis windows straight
    from the 16 kHz denoised stream ``x16`` [..., T16], with the lerp upsample
    folded into the DFT basis. ``prev`` [...] is the 16 kHz sample before
    ``x16`` (0 at stream start). Returns [..., n_windows] float32."""
    basis = _basis("band16", window, (n_fft, min_bin, max_bin, rate), x16.device)
    n_band = max_bin - min_bin + 1
    nsw = -(-n_windows // rate)
    need = nsw * n_fft
    t = x16.shape[-1]
    if t < need:
        x16 = torch.nn.functional.pad(x16, (0, need - t))
    main = precision.io_cast(x16[..., :need].reshape(x16.shape[:-1] + (nsw, n_fft)))
    # The carried sample before each superframe enters as a rank-1 term on
    # the basis's row 0, as in the JAX package. That term is an elementwise
    # product there (not a matmul), so no precision level rounds it; bf16
    # storage does. The magnitude sums that feed the FSM stay float32.
    prevs = torch.cat([prev.to(main.dtype)[..., None], main[..., :-1, -1]], dim=-1)
    basis = precision.io_cast(basis)
    prod = (precision.matmul(main, basis[1:], "band") + prevs[..., None] * basis[0]).float()
    prod = prod.reshape(prod.shape[:-1] + (rate, 2, n_band))
    mags = torch.sqrt(prod[..., 0, :] ** 2 + prod[..., 1, :] ** 2)
    band = torch.sum(mags, dim=-1) * np.float32(norm_factor)
    band = band.reshape(band.shape[:-2] + (nsw * rate,))
    return band[..., :n_windows]
