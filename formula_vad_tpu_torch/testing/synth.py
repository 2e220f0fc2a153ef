"""Synthetic radio streams, corpora and FSM window inputs (numpy).

``synth_stream`` is a copy of ``formula_vad_tpu/testing/synth.py::
synth_stream``: the same rng draws in the same order, so one seed gives the
same audio, labels and (``components=True``) clean speech in both packages
(``tests/test_torch_slice.py`` and ``tests/test_torch_denoise_quality.py``
check this). ``write_corpus`` lays such streams out as the simulator reads
them (``write_ragged_corpus``: long streams of ragged lengths, made on
threads). ``fsm_inputs`` and ``fsm_per_row_params`` feed the FSM scans
directly, on windows that visit every state and event.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..io_.wav import write_wav
from ..pipeline import fsm

SR = 48000


def synth_stream(rng: np.random.Generator, seconds: float, components: bool = False) -> tuple:
    """One stereo stream [2, seconds * SR] float32 + its (from_sec, to_sec)
    speech labels: engine-like noise (white noise and drifting low
    harmonics) with speech-band bursts correlated across the channels.

    With ``components=True`` also the bursts alone (the "clean speech"
    [2, seconds * SR] float32) as a third value: the (noisy, clean) pair of
    ``eval/denoise_quality.py``. The rng draws are the same either way."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rpm = 90.0 + 40.0 * np.sin(2 * np.pi * 0.05 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(rpm) / SR
    audio = rng.standard_normal((2, n)).astype(np.float32) * 0.015
    for harmonic, amp in ((1, 0.10), (2, 0.06), (3, 0.03)):
        audio += (amp * np.sin(harmonic * phase)).astype(np.float32)
    clean = np.zeros((2, n), np.float32) if components else None
    labels = []
    pos = rng.uniform(3.0, 8.0)
    while pos + 1.0 < seconds - 2.0:
        dur = float(rng.uniform(1.2, 5.0))
        if pos + dur > seconds - 2.0:
            break
        sl = slice(int(pos * SR), int((pos + dur) * SR))
        tt = t[sl]
        burst = np.zeros(sl.stop - sl.start, np.float32)
        for _ in range(4):
            f = rng.uniform(500.0, 2000.0)
            burst += np.sin(2 * np.pi * f * tt + rng.uniform(0, 6.28)).astype(np.float32)
        syllable = 0.55 + 0.45 * np.sign(np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * tt))
        burst *= 0.12 * syllable.astype(np.float32)
        audio[0, sl] += burst
        audio[1, sl] += 0.85 * burst
        if components:
            clean[0, sl] += burst
            clean[1, sl] += 0.85 * burst
        labels.append((round(pos, 3), round(pos + dur, 3)))
        pos += dur + float(rng.uniform(6.0, 15.0))
    if components:
        return audio.astype(np.float32), labels, clean
    return audio.astype(np.float32), labels


def write_corpus(root: str, n: int, seconds: float, seed: int, plans: dict, fmt: str = "float32") -> None:
    """``n`` streams from one rng (``s{i}.wav`` stereo 48 kHz in ``fmt``,
    "float32" or "pcm16", and Audacity labels ``s{i}.txt``) under ``root``,
    plus the simulator plans ``plans`` (``write_plans``)."""
    rng = np.random.default_rng(seed)
    instances = [_write_stream(root, i, *synth_stream(rng, seconds), fmt) for i in range(n)]
    write_plans(root, instances, plans)


def write_ragged_corpus(root: str, lengths: list[int], seed: int) -> None:
    """PCM16 streams of ``lengths[i]`` samples each (``synth_stream`` from
    the rng of seed ``(seed, i)``, cut to length; labels past the cut
    dropped), made 8 at a time on threads, written as ``write_corpus``
    writes them, with no plan."""

    def one(i):
        n = lengths[i]
        audio, labels = synth_stream(np.random.default_rng((seed, i)), n / SR + 1.0)
        _write_stream(root, i, audio[:, :n], [(a, b) for a, b in labels if b * SR <= n], "pcm16")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(len(lengths))))


def _write_stream(root: str, i: int, audio: np.ndarray, labels: list, fmt: str) -> dict:
    write_wav(os.path.join(root, f"s{i}.wav"), audio, SR, fmt=fmt)
    with open(os.path.join(root, f"s{i}.txt"), "w") as f:
        f.writelines(f"{a}\t{b}\tspeech\n" for a, b in labels)
    return {"name": f"s{i}", "audio_path": f"s{i}.wav", "ref_path": f"s{i}.txt"}


def write_plans(root: str, instances: list[dict], plans: dict) -> None:
    """One simulator plan ``plan_{name}.json`` per name of ``plans``,
    writing to ``out_{name}``, with the config keys ``plans[name]`` adds
    (``{"use_slabs": True}``, or ``{}``)."""
    for name, extra in plans.items():
        with open(os.path.join(root, f"plan_{name}.json"), "w") as f:
            json.dump({"instances": instances, "config": {"output_dir": f"out_{name}", **extra}}, f)


def fsm_inputs(rows: int, windows: int, seed: int, ratio_lead: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FSM window inputs (min_volumes, volume_ratios, valids), each
    [rows, windows]: noise-floor windows with loud, correlated bursts of
    several lengths (segments, aborted short ones, blips, gaps either side
    of the 2 s limit) and invalid trailing windows on odd rows.

    ``ratio_lead`` windows of each burst's channel correlation come before
    its volume rises (the same rng draws for any lead). A machine without
    an initial long-term average needs a lead of about the ratio window: a
    loud window whose ratio average has not yet crossed the threshold
    enters the long-term ring and raises the speech threshold, and a short
    ring (3 s) then misses the later bursts."""
    rng = np.random.default_rng(seed)
    mv = (0.004 + 0.002 * rng.random((rows, windows))).astype(np.float32)
    vr = (0.2 + 0.1 * rng.random((rows, windows))).astype(np.float32)
    valid = np.ones((rows, windows), bool)
    for r in range(rows):
        pos = int(rng.integers(5, 60))
        for i in range(windows):
            length, gap = ((5, 60), (16, 150), (40, 30), (120, 150))[i % 4]
            if pos + length >= windows - 20:
                break
            mv[r, pos : pos + length] = rng.uniform(0.1, 0.4)
            vr[r, max(0, pos - ratio_lead) : pos + length] = rng.uniform(0.6, 0.95)
            pos += length + gap
        if r % 2 == 1:
            valid[r, windows - int(rng.integers(1, 120)) :] = False
    return mv, vr, valid


def fsm_per_row_params(params: fsm.FSMParams, rows: int, seed: int) -> fsm.FSMParams:
    """[rows] parameters: a different machine on every row."""
    rng = np.random.default_rng(seed)
    return fsm.FSMParams(
        threshold_factor=rng.uniform(5.0, 15.0, rows).astype(np.float32),
        ratio_threshold=rng.uniform(0.3, 0.6, rows).astype(np.float32),
        min_consecutive_samples=rng.integers(4000, 20000, rows).astype(np.int32),
        max_gap_samples=rng.integers(30000, 120000, rows).astype(np.int32),
        min_duration_sec=rng.uniform(0.4, 1.0, rows).astype(np.float32),
        initial_long_term_avg=np.full(rows, params.initial_long_term_avg, np.float32),
    )
