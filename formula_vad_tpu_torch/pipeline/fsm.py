"""Speech-FSM statics and carry (port of ``formula_vad_tpu/pipeline/fsm.py``
:40-130 without jax).

The FSM is the reference's VADMachine: three rolling averages (long-term,
short-term and channel-ratio rings) and a 4-state hysteresis machine over
1024-sample windows. Window inputs come from the front end; the scan itself
lives in ``fsm_cuda`` (device kernel and plain version) and ``fsm_host``
(the native host decoder). All three share the packed carry built here:

* ``long_buf [B, L]``, ``short_buf [B, S]``, ``ratio_buf [B, R]`` — the rings;
* ``ireg [B, NI]`` int32 and ``freg [B, NF]`` float32 — the registers,
  in the layout of ``native/fvadfsm.cpp`` and ``fsm_pallas.py``;
* ``kahan [B, NK]`` float32 — the rings' compensated running sums
  (sum, comp) x (long, short, ratio), which chain exactly across calls.

K machines a stream (the reference's ``alt_vad_machine_configs``) are K
machines' parameters stacked into [K] leaves (``vad.stack_machine_params``)
and run as (stream, config) rows, stream-major: row r = stream * K + k,
the inputs repeated K times a stream (``repeat_rows``) and the parameters
tiled (``tile_rows``), as the JAX slab runner lays them out. Every scan
takes per-row parameters, so K machines are K times the rows of one scan.

States: 0 closed, 1 opening, 2 open, 3 closing.
Events: 0 none, 1 started, 2 completed, 3 aborted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import VADMachineConfig

CLOSED, OPENING, OPEN, CLOSING = 0, 1, 2, 3
EV_NONE, EV_STARTED, EV_COMPLETED, EV_ABORTED = 0, 1, 2, 3

(I_LONG_IDX, I_LONG_CNT, I_SHORT_IDX, I_SHORT_CNT, I_RATIO_IDX, I_RATIO_CNT,
 I_STATE, I_START, I_END, I_SEG_CNT) = range(10)
NI = 10
F_LONG_LAST, F_SEG_SUM, F_MET_SEC = range(3)
NF = 3
NK = 6


class FSMShape(NamedTuple):
    """Ring sizes and other per-config constants."""

    long_window: int
    short_window: int
    ratio_window: int
    has_initial_avg: bool
    fft_size: int
    sample_rate: int
    window_sec: float  # fft_size / sample_rate, as float32


class FSMParams(NamedTuple):
    """Thresholds: numpy scalars (shared by every row) or [B] arrays (one
    machine per row)."""

    threshold_factor: np.ndarray  # f32
    ratio_threshold: np.ndarray  # f32
    min_consecutive_samples: np.ndarray  # i32
    max_gap_samples: np.ndarray  # i32
    min_duration_sec: np.ndarray  # f32
    initial_long_term_avg: np.ndarray  # f32 (seeds the long ring only)


PARAM_DTYPES = (np.float32, np.float32, np.int32, np.int32, np.float32, np.float32)


def statics_from_config(
    cfg: VADMachineConfig, sample_rate: int, fft_size: int
) -> tuple[FSMShape, FSMParams]:
    shape = FSMShape(
        long_window=cfg.long_term_window(sample_rate, fft_size),
        short_window=cfg.short_term_window(sample_rate, fft_size),
        ratio_window=cfg.channel_ratio_window(sample_rate, fft_size),
        has_initial_avg=cfg.initial_long_term_avg is not None,
        fft_size=fft_size,
        sample_rate=sample_rate,
        window_sec=float(np.float32(fft_size) / np.float32(sample_rate)),
    )
    params = FSMParams(
        threshold_factor=np.float32(cfg.speech_threshold_factor),
        ratio_threshold=np.float32(cfg.channel_vol_ratio_threshold),
        min_consecutive_samples=np.int32(cfg.min_consecutive_samples_to_open(sample_rate)),
        max_gap_samples=np.int32(cfg.max_gap_samples(sample_rate)),
        min_duration_sec=np.float32(cfg.min_vad_duration_sec),
        initial_long_term_avg=np.float32(cfg.initial_long_term_avg or 0.0),
    )
    return shape, params


def n_machines(params: FSMParams) -> int:
    """K for K machines' stacked parameters ([K] leaves), 0 for one machine
    (scalar leaves)."""
    return int(np.shape(params.threshold_factor)[0]) if np.ndim(params.threshold_factor) else 0


def tile_rows(params: FSMParams, b: int) -> FSMParams:
    """K machines' parameters as the (stream, config) rows of ``b`` streams:
    [b * K] leaves, row stream * K + k holding machine k (``np.tile``)."""
    return FSMParams(*(np.tile(np.asarray(leaf, dtype), b) for leaf, dtype in zip(params, PARAM_DTYPES)))


def repeat_rows(x, k: int):
    """Each stream's row of ``x`` [B, ...] (a tensor or numpy array) ``k``
    times in a row: the (stream, config) rows' inputs, [B * k, ...] (a copy;
    on the card without a sync)."""
    if not isinstance(x, torch.Tensor):
        return np.repeat(x, k, axis=0)
    return x[:, None].expand((x.shape[0], k) + tuple(x.shape[1:])).reshape((x.shape[0] * k,) + tuple(x.shape[1:]))


def machine_rows(params: FSMParams, b: int):
    """The scan's rows for ``b`` streams under ``params``: (their count, a
    function from a stream's [B, ...] inputs to the rows', the rows'
    parameters). One row a stream for one machine; for K machines
    (stacked parameters) K rows a stream, stream-major."""
    k = n_machines(params)
    if not k:
        return b, (lambda x: x), params
    return b * k, (lambda x: repeat_rows(x, k)), tile_rows(params, b)


def param_rows(params: FSMParams, b: int) -> FSMParams:
    """Every parameter as a contiguous numpy [B] array of its dtype."""
    out = []
    for name, value, dtype in zip(FSMParams._fields, params, PARAM_DTYPES):
        x = np.asarray(value, dtype)
        if x.ndim == 0:
            x = np.full((b,), x, dtype)  # a writable copy (a broadcast view is read-only)
        elif x.shape != (b,):
            raise ValueError(f"FSM parameter {name} has shape {x.shape}, expected () or ({b},)")
        out.append(np.ascontiguousarray(x))
    return FSMParams(*out)


class WindowOutput(NamedTuple):
    """Per-window FSM outputs, each [B, W]."""

    event: torch.Tensor  # int32 event code
    event_win: torch.Tensor  # int32 window payload (start for STARTED, end for COMPLETED)
    seg_valid: torch.Tensor  # bool: a speech segment was emitted at this window
    seg_start_win: torch.Tensor  # int32
    seg_end_win: torch.Tensor  # int32
    seg_ratio: torch.Tensor  # f32 average channel volume ratio over the segment
    seg_met_sec: torch.Tensor  # f32 seconds the threshold was met


def check_carry(shape: FSMShape, carry: dict, b: int, indices: bool = True) -> None:
    """Refuse a carry (numpy arrays or tensors) that does not belong to B
    machines of ``shape``: the scans stride raw pointers by these shapes and
    index the rings with the carried indices. ``indices=False`` checks the
    shapes only: reading the indices of a carry on the card waits for the
    call that wrote them."""
    L, S, R = shape.long_window, shape.short_window, shape.ratio_window
    for name, want in (
        ("long_buf", (b, L)), ("short_buf", (b, S)), ("ratio_buf", (b, R)),
        ("ireg", (b, NI)), ("freg", (b, NF)), ("kahan", (b, NK)),
    ):
        if tuple(carry[name].shape) != want:
            raise ValueError(f"carry[{name}] shape {tuple(carry[name].shape)} != {want}")
    if not indices:
        return
    for col, limit in ((I_LONG_IDX, L), (I_SHORT_IDX, S), (I_RATIO_IDX, R)):
        idx = carry["ireg"][:, col]
        if b and not bool(((idx >= 0) & (idx < limit)).all()):
            raise ValueError(f"carry ring index out of range for ring size {limit}")


def fresh_carry(shape: FSMShape, params: FSMParams, b: int, device) -> dict[str, torch.Tensor]:
    """Initial carry for B machines. Its Kahan slots are zero: the scans
    seed them from the rings (an exact left fold) when they start from it."""
    rows = param_rows(params, b)
    L, S, R = shape.long_window, shape.short_window, shape.ratio_window
    ireg = torch.zeros((b, NI), dtype=torch.int32)
    freg = torch.zeros((b, NF), dtype=torch.float32)
    if shape.has_initial_avg:
        init_avg = torch.from_numpy(rows.initial_long_term_avg)
        long_buf = torch.ones((b, L), dtype=torch.float32) * init_avg[:, None]
        ireg[:, I_LONG_CNT] = L
        freg[:, F_LONG_LAST] = init_avg
    else:
        long_buf = torch.zeros((b, L), dtype=torch.float32)
    carry = {
        "long_buf": long_buf,
        "short_buf": torch.zeros((b, S), dtype=torch.float32),
        "ratio_buf": torch.zeros((b, R), dtype=torch.float32),
        "ireg": ireg,
        "freg": freg,
        "kahan": torch.zeros((b, NK), dtype=torch.float32),
    }
    return {k: v.to(device) for k, v in carry.items()}
