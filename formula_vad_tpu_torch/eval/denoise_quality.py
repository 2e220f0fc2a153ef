"""Denoising quality: the SI-SDR improvement of a gain model (port of
``formula_vad_tpu/eval/denoise_quality.py``).

Held-out synthetic (noisy, clean) pairs (``testing/synth.synth_stream(
components=True)`` at seeds far from the packaged training run's) go
through the shipping chunked pipeline (``pipeline/denoiser.denoise_chunk``
over 0.5 s chunks, carry chained), and are scored as

    si_sdr(denoised, clean_ref) - si_sdr(passthrough, clean_ref)

where ``passthrough`` and ``clean_ref`` are the noisy and clean signals run
through the same pipeline with a unity gain model. Both references see the
pipeline's linear artifacts (48k->16k decimation, OLA latency, lerp
upsample), so they cancel and the score isolates the gain model.

Not one of the byte-for-byte copies in ``eval/``: the JAX module imports
jax (a ``lax.scan`` of the chunk step). Here the chunk step runs as a loop
on an explicit device, the card unless the caller asks for the CPU, so on
the card NSNet2 steps kernel 1 once a chunk and the gate runs its tensor
ops there.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import device as device_mod
from ..config import NSNET2_CHUNK_16K
from ..pipeline import denoiser
from ..testing import synth

# Held-out seed base, far from the packaged weights' training seeds and the
# example corpus's small seeds.
HELD_OUT_SEED = 20_000


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR in dB (Le Roux et al. 2019), in float64: project
    ``est`` onto ``ref`` (both zero-mean) and compare target against
    residual energy. Multi-channel inputs are flattened: one score a
    signal."""
    est = np.asarray(est, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    est = est - est.mean()
    ref = ref - ref.mean()
    denom = float(np.dot(ref, ref))
    if denom == 0.0:
        raise ValueError("si_sdr: reference signal is all zeros")
    alpha = float(np.dot(est, ref)) / denom
    target = alpha * ref
    resid = est - target
    eps = 1e-12
    return float(10.0 * np.log10((np.dot(target, target) + eps) / (np.dot(resid, resid) + eps)))


class IdentityGains(nn.Module):
    """Unity gain model: the pipeline's linear passthrough (decimate ->
    STFT -> gain 1 -> OLA -> upsample), used to build aligned references."""

    def forward(self, features: torch.Tensor, out_frames: int | None = None) -> torch.Tensor:
        t = features.shape[-2] if out_frames is None else min(out_frames, features.shape[-2])
        return torch.ones(features.shape[:-2] + (t, features.shape[-1]), dtype=features.dtype, device=features.device)


def make_pipeline_runner(net: nn.Module, downsample_rate: int = 3, device: str | torch.device = "cuda"):
    """A chunked-denoise function for ``net`` (on ``device``): [C, N] 48 kHz
    numpy in (trimmed to whole 0.5 s chunks), [C, N'] float32 numpy out."""
    dev = device if isinstance(device, torch.device) else device_mod.resolve(device)
    chunk = NSNET2_CHUNK_16K * downsample_rate

    def denoise(audio48: np.ndarray) -> np.ndarray:
        n_ch = audio48.shape[0]
        n_chunks = audio48.shape[1] // chunk
        x = torch.from_numpy(np.ascontiguousarray(audio48[:, : n_chunks * chunk], np.float32)).to(dev)
        carry = denoiser.init_carry(n_ch, dev)
        outs = []
        with torch.inference_mode():
            for k in range(n_chunks):
                carry, out = denoiser.denoise_chunk(net, carry, x[:, k * chunk : (k + 1) * chunk], downsample_rate)
                outs.append(out)
            if not outs:
                return np.zeros((n_ch, 0), np.float32)
            return torch.cat(outs, dim=-1).cpu().numpy()

    return denoise


def pipeline_denoise(net: nn.Module, audio48: np.ndarray, downsample_rate: int = 3,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """One-shot convenience wrapper around make_pipeline_runner."""
    return make_pipeline_runner(net, downsample_rate, device)(audio48)


def held_out_pairs(n_pairs: int, seconds: float, seed: int = HELD_OUT_SEED):
    """(noisy, clean) stereo 48 kHz pairs from held-out corpus seeds.

    A seed whose draw places no speech burst (an all-zero clean reference
    has no SI-SDR) is redrawn, at most 20 times a pair: below ~6.5 s no
    draw can place one, and such a window is refused."""
    if seconds <= 6.5:
        raise ValueError(
            f"seconds={seconds} is too short for the corpus generator to "
            "place a speech burst (needs > ~6.5 s); use a longer window"
        )
    pairs = []
    s = seed
    attempts_left = 20 * n_pairs
    while len(pairs) < n_pairs:
        if attempts_left <= 0:
            raise RuntimeError(f"could not draw {n_pairs} pairs with speech at seconds={seconds} (seed base {seed})")
        attempts_left -= 1
        rng = np.random.default_rng(s)
        s += 1
        noisy, _labels, clean = synth.synth_stream(rng, seconds, components=True)
        if not np.any(clean):
            continue
        pairs.append((noisy, clean))
    return pairs


def evaluate(net: nn.Module, *, n_pairs: int = 4, seconds: float = 20.0, seed: int = HELD_OUT_SEED,
             device: str | torch.device = "cuda") -> dict:
    """SI-SDR improvement of ``net`` (on ``device``) over the unity-gain
    pipeline on held-out pairs: per-pair and mean numbers in dB, rounded to
    0.01 as the JAX package reports them."""
    run_model = make_pipeline_runner(net, device=device)
    run_ident = make_pipeline_runner(IdentityGains(), device=device)
    rows = []
    for noisy, clean in held_out_pairs(n_pairs, seconds, seed):
        est = run_model(noisy)
        passthrough = run_ident(noisy)
        clean_ref = run_ident(clean)
        before = si_sdr(passthrough, clean_ref)
        after = si_sdr(est, clean_ref)
        rows.append(
            {
                "si_sdr_noisy_db": round(before, 2),
                "si_sdr_denoised_db": round(after, 2),
                "si_sdr_impr_db": round(after - before, 2),
            }
        )
    mean = sum(r["si_sdr_impr_db"] for r in rows) / len(rows)
    return {
        "pairs": rows,
        "n_pairs": n_pairs,
        "seconds": seconds,
        "seed": seed,
        "mean_si_sdr_impr_db": round(mean, 2),
    }
