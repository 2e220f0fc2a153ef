"""Precision-tier boundary-shift fuzz campaign (port of
``formula_vad_tpu/testing/tier_fuzz.py``; PARITY.md deviation 2).

The throughput tiers (``high`` = bf16_3x, ``bf16``, ``bf16_io``) change the
FSM's *inputs*: every product in the denoise and band-volume chain, and the
NSNet2 recurrence. Their decision deviations are measured on engineered
marginal cases, not only on a synthetic sweep.

The campaign: per case, bursts are PLANNED (durations just past the case's
min_open + min_duration, spacing > max_gap, room to close before EOF), then
CALIBRATED: a probe pass at ``highest`` measures each burst's delivered
window volume, and the burst is re-scaled so its volume lands AT a chosen
multiple of the case's open threshold (0.95x-6x, mostly near 1x). That
pins the decisions at the edge whatever the denoiser weights do to the
band. Segments at each throughput tier are then compared to ``highest``
boundary by boundary.

The case generator (``_case_config``, ``_burst_plan``, ``_render``,
``_burst_windows``) keeps the JAX module's names, values and seeds, so both
packages build the same plans and probe audio from ``seed_base + case``.
There is no jit and no compile step: ``run_campaign`` sets each tier's
precision switches and calls the port's entry points once per case and
tier (``pipeline/offline.process_stream_offline``, the FSM through
``fsm_cuda.scan_windows`` with the case's parameters), on the network's
device: the CUDA kernels on the card, their plain versions on the CPU.

Consumers: ``tests/test_torch_tier_fuzz.py`` (the envelope on the CPU,
against the JAX campaign) and ``chip_smoke.py`` (the envelope on the card).

Reference decision chain: VADMachine.zig:166-178 (threshold factor 10, the
margin these cases deliberately erase).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import VADConfig, VADMachineConfig
from ..device import model_device

SR, FFT = 48000, 1024
PROBE_AMP = 0.1

# One shape class for every case (window counts and band bins fixed); the
# FSMParams fields are fuzzed per case. The long-term window must be LONG
# relative to a burst: the noise-floor average absorbs the burst until the
# threshold is met (the freeze only starts then, VADMachine.zig:176-178),
# so a short ring raises its own bar faster than the short window can
# clear it and the FSM never opens. 10 s (469 windows) keeps absorption
# under ~10% of a burst's volume.
_SHAPE = dict(
    long_term_speech_avg_sec=10.0,
    initial_long_term_avg=0.005,
    short_term_speech_avg_sec=0.2,
    channel_vol_ratio_avg_sec=0.5,
    speech_min_freq=500.0,
    speech_max_freq=2000.0,
)

TIERS = (
    ("high", "high", "f32"),
    ("bf16", "default", "f32"),
    ("bf16_io", "default", "bf16"),
)


def _case_config(rng) -> VADMachineConfig:
    return VADMachineConfig(
        **_SHAPE,
        speech_threshold_factor=float(rng.uniform(2.0, 20.0)),
        channel_vol_ratio_threshold=float(rng.uniform(0.2, 0.7)),
        min_consecutive_sec_to_open=float(rng.uniform(0.05, 0.5)),
        max_speech_gap_sec=float(rng.uniform(0.3, 2.5)),
        min_vad_duration_sec=float(rng.uniform(0.2, 1.5)),
    )


def _burst_plan(rng, cfg: VADMachineConfig, n_chunks: int):
    """Burst schedule with closable-segment geometry and edge targets."""
    T = n_chunks * 24000 / SR
    plan = []
    cursor = float(rng.uniform(0.1, 0.4))
    while True:
        d = (
            cfg.min_consecutive_sec_to_open
            + cfg.min_vad_duration_sec
            + float(rng.uniform(0.05, 0.6))
        )
        if cursor + d + cfg.max_speech_gap_sec + 0.6 > T:
            break
        plan.append(
            dict(
                a=cursor,
                d=d,
                f=float(rng.uniform(cfg.speech_min_freq, cfg.speech_max_freq)),
                mult=float(rng.choice([0.95, 1.05, 1.2, 1.6, 3.0, 6.0])),
                chan=float(rng.uniform(0.5, 1.0)),
            )
        )
        cursor += d + cfg.max_speech_gap_sec + float(rng.uniform(0.3, 0.8))
    return plan


def _render(noise_seed: int, plan, amps, n_chunks: int) -> np.ndarray:
    t_total = n_chunks * 24000
    t = np.arange(t_total) / SR
    rng = np.random.default_rng(noise_seed)
    audio = (0.004 * rng.standard_normal((2, t_total))).astype(np.float32)
    for b, amp in zip(plan, amps):
        sl = slice(int(b["a"] * SR), int((b["a"] + b["d"]) * SR))
        burst = (amp * np.sin(2 * np.pi * b["f"] * t[sl])).astype(np.float32)
        audio[0, sl] += burst
        audio[1, sl] += b["chan"] * burst
    return audio


def _burst_windows(b) -> tuple[int, int]:
    """Fully-inside FFT-window range [w0, w1) of a burst (1024-sample
    windows of the 48 kHz denoised stream, hop == fft)."""
    w0 = int(np.ceil(b["a"] * SR / FFT))
    w1 = int((b["a"] + b["d"]) * SR // FFT)
    return w0, max(w1, w0 + 1)


@dataclasses.dataclass
class TierStats:
    """Per-tier deviation envelope over the campaign."""

    tier: str
    n_cases: int = 0
    seg_count_mismatch_cases: int = 0  # cases where #segments changed
    shifted_cases: int = 0             # same #segments, >=1 boundary moved
    n_boundaries: int = 0              # boundaries compared (matched cases)
    n_shifted_boundaries: int = 0
    max_shift_windows: int = 0
    total_shift_windows: int = 0

    @property
    def deviated_cases(self) -> int:
        return self.seg_count_mismatch_cases + self.shifted_cases

    def row(self) -> str:
        rate = self.deviated_cases / max(self.n_cases, 1)
        brate = self.n_shifted_boundaries / max(self.n_boundaries, 1)
        return (
            f"| {self.tier} | {self.n_cases} | {self.deviated_cases} "
            f"({100 * rate:.1f}%) | {self.seg_count_mismatch_cases} "
            f"| {self.n_shifted_boundaries}/{self.n_boundaries} "
            f"({100 * brate:.2f}%) | {self.max_shift_windows} |"
        )


def _set_tier(level: str, io: str) -> None:
    from ..ops import precision

    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)


def run_campaign(net, n_cases: int = 40, n_chunks: int = 16,
                 tiers=TIERS, seed_base: int = 600_000) -> dict[str, TierStats]:
    """Run the calibrated-marginal campaign with ``net`` on its device:
    segments at each tier vs ``highest``. Each tier is set through the
    global precision switches before its run (there is nothing to compile:
    one eager run per case and tier, plus one probe run at ``highest``);
    ``highest`` and f32 storage are restored on the way out. Returns
    per-tier TierStats keyed by tier name, plus a "highest" entry carrying
    the campaign size and total boundary count (its deviation fields are
    zero by construction)."""
    from ..pipeline import offline, vad

    dev = model_device(net)
    st0 = vad.statics_from_config(
        VADConfig(vad_machine_config=_case_config(np.random.default_rng(0)))
    )
    runs = (("highest", "highest", "f32"),) + tuple(tiers)
    stats = {t: TierStats(tier=t) for t, _, _ in runs}
    try:
        with torch.inference_mode():
            for case in range(n_cases):
                rng = np.random.default_rng(seed_base + case)
                cfg = _case_config(rng)
                st = vad.statics_from_config(VADConfig(vad_machine_config=cfg))
                assert st.fsm_shape == st0.fsm_shape
                plan = _burst_plan(rng, cfg, n_chunks)
                if not plan:
                    continue

                # Calibration probe at `highest`: measure each burst's
                # delivered window volume at PROBE_AMP, then scale so it
                # lands at mult x the open threshold.
                _set_tier("highest", "f32")
                noise_seed = seed_base + 7_000_000 + case
                probe_audio = _render(noise_seed, plan, [PROBE_AMP] * len(plan), n_chunks)
                mv, _, _ = offline.window_inputs_batch(net, st0, torch.from_numpy(probe_audio)[None].to(dev))
                mv = mv[0].cpu().numpy()
                thresh = (cfg.initial_long_term_avg or 0.005) * cfg.speech_threshold_factor
                amps = []
                for b in plan:
                    w0, w1 = _burst_windows(b)
                    measured = float(np.median(mv[w0:w1])) if w1 > w0 else 0.0
                    if measured <= 1e-9:
                        amps.append(PROBE_AMP)
                        continue
                    # Delivered volume is ~linear in amplitude (the gain
                    # mask drifts with input level, but the probe anchors
                    # the right decade and the mult mix covers the rest).
                    amps.append(min(PROBE_AMP * b["mult"] * thresh / measured, 0.9))
                audio = torch.from_numpy(_render(noise_seed, plan, amps, n_chunks)).to(dev)

                def segs(level, io):
                    _set_tier(level, io)
                    win_out, _ = offline.process_stream_offline(net, st0, audio, fsm_params=st.fsm_params)
                    return [
                        (int(s["sample_from"]), int(s["sample_to"]))
                        for s in offline.segments_from_offline(st, win_out)
                    ]

                want = segs("highest", "f32")
                stats["highest"].n_cases += 1
                stats["highest"].n_boundaries += 2 * len(want)
                for tier, level, io in tiers:
                    got = segs(level, io)
                    ts = stats[tier]
                    ts.n_cases += 1
                    if len(got) != len(want):
                        ts.seg_count_mismatch_cases += 1
                        continue
                    ts.n_boundaries += 2 * len(want)
                    moved = [
                        s
                        for g, w in zip(got, want)
                        for s in (abs(g[0] - w[0]) // FFT, abs(g[1] - w[1]) // FFT)
                        if s > 0
                    ]
                    ts.n_shifted_boundaries += len(moved)
                    ts.total_shift_windows += sum(moved)
                    if moved and max(moved) > ts.max_shift_windows:
                        ts.max_shift_windows = max(moved)
                    if moved:
                        ts.shifted_cases += 1
    finally:
        _set_tier("highest", "f32")
    return stats


def format_table(stats: dict[str, TierStats]) -> str:
    lines = [
        "| tier | cases | deviated cases | seg-count changes "
        "| shifted boundaries | max shift (windows) |",
        "|---|---|---|---|---|---|",
    ]
    lines += [s.row() for s in stats.values()]
    return "\n".join(lines)
