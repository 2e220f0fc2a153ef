"""The speech-FSM window scan: CUDA kernel wrapper and plain version.

``scan_windows`` replaces ``formula_vad_tpu/pipeline/fsm_pallas.py::
scan_windows_pallas``: B independent machines, one per row, each stepping
serially over its W windows (fsm.py describes the machine and the carry).
The semantics are those of ``native/fvadfsm.cpp``, statement for
statement: Kahan-compensated float32 ring sums seeded by an exact left fold
and carried across calls, int32 wraparound window arithmetic, and inert
outputs from the frozen carry for invalid windows. The kernel and the plain
version are held to the host decoder bit for bit.

CUDA tensors go to the kernel in ``csrc/fsm_scan.cu``, whose body
``launch_plan`` picks on ring size alone (rings in shared memory, one CTA a
row; or, above the shared-memory budget, rings in global memory); CPU
tensors go to ``scan_windows_reference``, a per-window loop vectorised over
rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from . import fsm
from .fsm import FSMParams, FSMShape, WindowOutput

_I32 = 1 << 32


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 two's-complement wraparound, kept in int64."""
    return torch.remainder(x + (1 << 31), _I32) - (1 << 31)


def _kahan_add(v, s, c):
    y = v - c
    t = s + y
    return t, (t - s) - y


def _kahan_seed(ring: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact left fold of each row of ``ring`` [B, n] (fvad_fsm_kahan_seed)."""
    s = ring.new_zeros(ring.shape[0])
    c = ring.new_zeros(ring.shape[0])
    for i in range(ring.shape[1]):
        s, c = _kahan_add(ring[:, i], s, c)
    return s, c


@functools.lru_cache(maxsize=16)
def _param_tensors(raw: tuple[bytes, ...], device: torch.device) -> tuple[torch.Tensor, ...]:
    """The first five per-row parameters on ``device``, from their bytes
    (``fsm.param_rows``): made once per content, rows and device, so calls
    with the same parameters make no host-to-device copy. The kernel and
    the plain version only read them."""
    return tuple(torch.from_numpy(np.frombuffer(x, dt).copy()).to(device) for x, dt in zip(raw, fsm.PARAM_DTYPES))


def _prepare(shape, params, min_volumes, carry, win_base):
    b = min_volumes.shape[0]
    dev = min_volumes.device
    seed = carry is None
    if seed:
        carry = fsm.fresh_carry(shape, params, b, dev)
    else:
        fsm.check_carry(shape, carry, b)
        carry = {k: v.clone() for k, v in carry.items()}
    if win_base is None:
        win_base = torch.zeros((b,), dtype=torch.int32, device=dev)
    prm = _param_tensors(tuple(x.tobytes() for x in fsm.param_rows(params, b)[:5]), dev)
    return carry, seed, win_base, prm


def scan_windows_reference(
    shape: FSMShape,
    params: FSMParams,
    min_volumes: torch.Tensor,  # [B, W] f32
    volume_ratios: torch.Tensor,  # [B, W] f32
    valids: torch.Tensor,  # [B, W] bool
    carry: dict | None = None,
    win_base: torch.Tensor | None = None,  # [B] i32
) -> tuple[WindowOutput, dict]:
    """Plain PyTorch version of ``scan_windows`` (same arguments, same
    results bit for bit). Every float32 operation is a separate IEEE op in
    fvadfsm.cpp's order, so nothing is fused or reassociated."""
    carry, seed, win_base, (tf, rth, min_consec, max_gap, min_dur) = _prepare(
        shape, params, min_volumes, carry, win_base
    )
    b, w_total = min_volumes.shape
    dev = min_volumes.device
    L, S, R = shape.long_window, shape.short_window, shape.ratio_window
    f32 = lambda x: torch.tensor(np.float32(x), device=dev)  # noqa: E731
    win_sec, fftf, srf = f32(shape.window_sec), f32(shape.fft_size), f32(shape.sample_rate)
    rows = torch.arange(b, device=dev)
    min_consec, max_gap = min_consec.long(), max_gap.long()

    lbuf, sbuf, rbuf = carry["long_buf"], carry["short_buf"], carry["ratio_buf"]
    ir = carry["ireg"].long()
    long_idx, long_cnt, short_idx, short_cnt, ratio_idx, ratio_cnt, state, start, end, seg_cnt = (
        ir[:, i] for i in range(fsm.NI)
    )
    long_last, seg_sum, met_sec = (carry["freg"][:, i] for i in range(fsm.NF))
    if seed:
        (lsum, lcomp), (ssum, scomp), (rsum, rcomp) = (
            _kahan_seed(x) for x in (lbuf, sbuf, rbuf)
        )
    else:
        lsum, lcomp, ssum, scomp, rsum, rcomp = (carry["kahan"][:, i] for i in range(fsm.NK))

    outs = {
        "event": torch.zeros((b, w_total), dtype=torch.int32, device=dev),
        "event_win": torch.zeros((b, w_total), dtype=torch.int32, device=dev),
        "seg_valid": torch.zeros((b, w_total), dtype=torch.bool, device=dev),
        "seg_start_win": torch.zeros((b, w_total), dtype=torch.int32, device=dev),
        "seg_end_win": torch.zeros((b, w_total), dtype=torch.int32, device=dev),
        "seg_ratio": torch.zeros((b, w_total), dtype=torch.float32, device=dev),
        "seg_met_sec": torch.zeros((b, w_total), dtype=torch.float32, device=dev),
    }
    wb = win_base.long()
    where = torch.where
    for w in range(w_total):
        ok = valids[:, w]
        mv = min_volumes[:, w]
        vr = volume_ratios[:, w]
        win_idx = _wrap(wb + w)

        # Rolling averages (RollingAverage push/avg with Kahan running sums).
        old = sbuf[rows, short_idx]
        ssum2, scomp2 = _kahan_add(mv - old, ssum, scomp)
        sbuf[rows, short_idx] = where(ok, mv, old)
        short_idx2 = (short_idx + 1) % S
        short_cnt2 = torch.clamp(short_cnt + 1, max=S)
        short_avg = ssum2 / short_cnt2.float()

        old = rbuf[rows, ratio_idx]
        rsum2, rcomp2 = _kahan_add(vr - old, rsum, rcomp)
        rbuf[rows, ratio_idx] = where(ok, vr, old)
        ratio_idx2 = (ratio_idx + 1) % R
        ratio_cnt2 = torch.clamp(ratio_cnt + 1, max=R)
        ratio_avg = rsum2 / ratio_cnt2.float()

        base = long_last if shape.has_initial_avg else where(long_cnt > 0, long_last, short_avg)
        met = (short_avg > base * tf) & (ratio_avg > rth)

        # The long-term average only advances while the threshold is not met.
        push = ok & ~met
        old = lbuf[rows, long_idx]
        lsum2, lcomp2 = _kahan_add(mv - old, lsum, lcomp)
        lbuf[rows, long_idx] = where(push, mv, old)
        long_cnt2 = torch.clamp(long_cnt + 1, max=L)
        long_last2 = where(push, lsum2 / long_cnt2.float(), long_last)
        lsum2, lcomp2 = where(push, lsum2, lsum), where(push, lcomp2, lcomp)
        long_idx2 = where(push, (long_idx + 1) % L, long_idx)
        long_cnt2 = where(push, long_cnt2, long_cnt)

        # State machine (transitions from the entry state).
        is_closed, is_opening = state == fsm.CLOSED, state == fsm.OPENING
        is_open, is_closing = state == fsm.OPEN, state == fsm.CLOSING
        opening_dur = _wrap(_wrap(win_idx - start) * shape.fft_size) >= min_consec
        closing_dur = _wrap(_wrap(win_idx - end) * shape.fft_size) >= max_gap
        t_closed_opening = is_closed & met
        t_opening_open = is_opening & met & opening_dur
        t_open_closing = is_open & ~met
        t_closing_closed = is_closing & ~met & closing_dur

        length_sec = (_wrap(end - start).float() * fftf) / srf
        duration_met = length_sec >= min_dur
        seg_emitted = t_closing_closed & duration_met
        avg_ratio = seg_sum / torch.clamp(seg_cnt, min=1).float()

        ev = where(t_opening_open, fsm.EV_STARTED, fsm.EV_NONE)
        ev = where(seg_emitted, fsm.EV_COMPLETED, ev)
        ev = where(t_closing_closed & ~duration_met, fsm.EV_ABORTED, ev)
        ev_win = where(ev == fsm.EV_STARTED, start, where(ev == fsm.EV_COMPLETED, end, 0))

        outs["event"][:, w] = where(ok, ev, 0).int()
        outs["event_win"][:, w] = where(ok, ev_win, 0).int()
        outs["seg_valid"][:, w] = ok & seg_emitted
        outs["seg_start_win"][:, w] = start.int()
        outs["seg_end_win"][:, w] = end.int()
        outs["seg_ratio"][:, w] = avg_ratio
        outs["seg_met_sec"][:, w] = met_sec

        # Per-segment stats (trackSpeechStats, from the entry state).
        seg_sum2 = where(t_closed_opening, vr, seg_sum)
        seg_cnt2 = where(t_closed_opening, 1, seg_cnt)
        met_sec2 = where(t_closed_opening, win_sec, met_sec)
        seg_sum2 = where(is_open, seg_sum2 + vr, seg_sum2)
        seg_cnt2 = where(is_open, seg_cnt2 + 1, seg_cnt2)
        met_sec2 = where(is_open & met, met_sec2 + win_sec, met_sec2)

        state2 = where(t_closed_opening, fsm.OPENING, state)
        state2 = where(
            is_opening, where(met, where(opening_dur, fsm.OPEN, fsm.OPENING), fsm.CLOSED), state2
        )
        state2 = where(t_open_closing, fsm.CLOSING, state2)
        state2 = where(
            is_closing, where(met, fsm.OPEN, where(closing_dur, fsm.CLOSED, fsm.CLOSING)), state2
        )
        start2 = where(t_closed_opening, win_idx, start)
        end2 = where(t_open_closing, win_idx, end)

        # Invalid windows freeze the whole carry (the rings were gated above).
        long_idx, long_cnt, long_last = (
            where(ok, long_idx2, long_idx), where(ok, long_cnt2, long_cnt), where(ok, long_last2, long_last)
        )
        lsum, lcomp = where(ok, lsum2, lsum), where(ok, lcomp2, lcomp)
        short_idx, short_cnt = where(ok, short_idx2, short_idx), where(ok, short_cnt2, short_cnt)
        ssum, scomp = where(ok, ssum2, ssum), where(ok, scomp2, scomp)
        ratio_idx, ratio_cnt = where(ok, ratio_idx2, ratio_idx), where(ok, ratio_cnt2, ratio_cnt)
        rsum, rcomp = where(ok, rsum2, rsum), where(ok, rcomp2, rcomp)
        state, start, end = where(ok, state2, state), where(ok, start2, start), where(ok, end2, end)
        seg_sum, seg_cnt, met_sec = where(ok, seg_sum2, seg_sum), where(ok, seg_cnt2, seg_cnt), where(ok, met_sec2, met_sec)

    carry["ireg"] = torch.stack(
        [long_idx, long_cnt, short_idx, short_cnt, ratio_idx, ratio_cnt, state, start, end, seg_cnt],
        dim=1,
    ).int()
    carry["freg"] = torch.stack([long_last, seg_sum, met_sec], dim=1)
    carry["kahan"] = torch.stack([lsum, lcomp, ssum, scomp, rsum, rcomp], dim=1)
    return WindowOutput(**outs), carry


# The most dynamic shared memory an H100 block may opt in to, bytes.
H100_SMEM_PER_BLOCK = 232_448
# Windows a tile: the pipeline's unit (the three stages behind the loads
# each wait one tile to start), TILE_MIN where a CTA with TILE_MAX would not
# fit a block. Multiples of 32.
TILE_MAX, TILE_MIN = 128, 32
# Shared bytes a tile window (csrc/fsm_scan.cu): the state machine's
# records 32 B x 2 slots, inputs 9 B x 4, averages 8 B x 2 and their counts
# 8 B, met 1 B x 2.
TILE_BYTES = 32 * 2 + 9 * 4 + 8 * 2 + 8 + 2
SMEM_THREADS, GLOBAL_THREADS = 160, 64


class ScanPlan(NamedTuple):
    """How ``scan_windows`` launches: the body (``"smem"``, rings in shared
    memory, one CTA a row; ``"global"``, the first port's rings in global
    memory, one thread a row), its CTAs and threads, the windows a tile and
    the tiles a row, and the dynamic shared memory a CTA (the smem body
    only)."""

    body: str
    ctas: int
    threads: int
    tile: int
    tiles: int
    smem_bytes: int


def smem_bytes(shape: FSMShape, tile: int) -> int:
    """Dynamic shared memory of one smem-body CTA: its tiles and its row's three rings."""
    return TILE_BYTES * tile + 4 * (shape.long_window + shape.short_window + shape.ratio_window)


def launch_plan(b: int, w: int, shape: FSMShape, smem_per_block: int = H100_SMEM_PER_BLOCK) -> ScanPlan:
    """The launch of B machines over W windows, on ring size alone: the
    smem body with tiles of ``TILE_MAX`` windows, or ``TILE_MIN`` where one
    CTA would not fit a block's shared memory (``smem_per_block`` bytes)
    with the larger tile; the global body where it fits with neither. The
    results do not depend on the plan."""
    tile = next((t for t in (TILE_MAX, TILE_MIN) if smem_bytes(shape, t) <= smem_per_block), None)
    if tile is None:
        return ScanPlan("global", -(-b // GLOBAL_THREADS), GLOBAL_THREADS, 0, 0, 0)
    return ScanPlan("smem", b, SMEM_THREADS, tile, -(-w // tile), smem_bytes(shape, tile))


def _fold(values: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The exact left Kahan fold of ``n`` copies of each of ``values``
    (float32), in fvad_fsm_kahan_seed's order of operations."""
    s = np.zeros_like(values)
    c = np.zeros_like(values)
    for _ in range(n):
        y = values - c
        t = s + y
        c = (t - s) - y
        s = t
    return s, c


@functools.lru_cache(maxsize=16)
def fresh_kahan(long_window: int, has_initial_avg: bool, initial_avg: bytes, device: torch.device) -> torch.Tensor:
    """The Kahan slots [B, NK] of B fresh machines on ``device``: the
    exact left fold of each fresh ring, which holds ``long_window`` copies
    of the row's ``initial_avg`` (float32 bytes, one a row) in the long ring
    and zeros elsewhere. A function of the configuration alone, so it is
    folded on the host once per content and cached with the parameters: a
    fresh ``scan_windows`` call then makes no host-to-device copy, and the
    kernel no serial fold."""
    init = np.frombuffer(initial_avg, np.float32)
    kahan = np.zeros((init.shape[0], fsm.NK), np.float32)
    if has_initial_avg:  # zero rings fold to (0, 0)
        bits, inverse = np.unique(init.view(np.uint32), return_inverse=True)
        sums, comps = _fold(bits.view(np.float32), long_window)
        kahan[:, 0], kahan[:, 1] = sums[inverse.reshape(-1)], comps[inverse.reshape(-1)]
    return torch.from_numpy(kahan).to(device)


def seeded_fresh_carry(shape: FSMShape, params: FSMParams, b: int, device) -> dict[str, torch.Tensor]:
    """``fsm.fresh_carry`` with its Kahan slots seeded (``fresh_kahan``):
    a carry that every scan continues exactly as a fresh scan (``carry=None``)
    starts. The form of a fresh machine's carry where one must exist before
    its first scan: a checkpoint, a reset row of a fleet's carry."""
    dev = torch.device(device)
    carry = fsm.fresh_carry(shape, params, b, dev)
    raw = fsm.param_rows(params, b).initial_long_term_avg.tobytes()
    carry["kahan"] = fresh_kahan(shape.long_window, bool(shape.has_initial_avg), raw, dev).clone()
    return carry


@functools.cache  # the lookup and the argtypes stay off the per-call path
def _lib() -> ctypes.CDLL:
    lib = _build.load("fsm_scan", extra_flags=("-fmad=false",))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fvad_fsm_scan.argtypes = (
        [i32] * 10 + [ctypes.c_float]  # body, sizes, tile, static shape, window_sec
        + [p] * 6  # per-row params
        + [p] * 4  # inputs, win_base
        + [i32] + [p] * 7  # fresh flag, carry in, fresh Kahan seeds
        + [p] * 6  # carry out
        + [p] * 7  # outputs
        + [p]  # stream
    )
    lib.fvad_fsm_scan.restype = ctypes.c_int
    lib.fvad_fsm_smem_bytes.argtypes = [i32] * 4
    lib.fvad_fsm_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def smem_per_block(index: int) -> int:
    """The most dynamic shared memory a block of CUDA device ``index`` may opt in to."""
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"scan_windows: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
        )


CARRY_KEYS = ("long_buf", "short_buf", "ratio_buf", "ireg", "freg", "kahan")


def scan_windows(
    shape: FSMShape,
    params: FSMParams,
    min_volumes: torch.Tensor,
    volume_ratios: torch.Tensor,
    valids: torch.Tensor,
    carry: dict | None = None,
    win_base: torch.Tensor | None = None,
) -> tuple[WindowOutput, dict]:
    """Scan B machines over W windows: [B, W] inputs -> (WindowOutput, carry).

    ``carry=None`` starts fresh machines (index 0 at ``win_base``, default
    0); a carry returned by an earlier call continues them exactly. The
    given carry is not modified; its ring indices are checked, which on the
    card waits for the call that wrote them. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel or raises. A fresh call on the card makes no
    host-to-device copy and does not synchronise once its parameters and
    seeds are cached. Launches are counted in ``scan_windows.launches`` and,
    by body, in ``scan_windows.launches_by_body``; the last call's plan is
    ``scan_windows.last_plan``."""
    return _scan(shape, params, min_volumes, volume_ratios, valids, carry, win_base, own_carry=False)


def _scan_chained(
    shape: FSMShape,
    params: FSMParams,
    min_volumes: torch.Tensor,
    volume_ratios: torch.Tensor,
    valids: torch.Tensor,
    carry: dict,
    win_base: torch.Tensor,
) -> tuple[WindowOutput, dict]:
    """``scan_windows`` continuing a carry that an earlier call returned and
    nothing has written since (the slab runner's own chain). On the card its
    shapes are checked but its ring indices are not read back, so the call
    neither copies nor synchronises: the kernel wrote them in range. The
    plain version checks them as for any carry."""
    return _scan(shape, params, min_volumes, volume_ratios, valids, carry, win_base, own_carry=True)


def _scan(shape, params, min_volumes, volume_ratios, valids, carry, win_base, own_carry):
    if min_volumes.device.type == "cpu":
        return scan_windows_reference(shape, params, min_volumes, volume_ratios, valids, carry, win_base)
    if min_volumes.device.type != "cuda":
        raise ValueError(f"scan_windows: unsupported device {min_volumes.device}")
    if min_volumes.dim() != 2:
        raise ValueError(f"scan_windows: inputs must be [B, W], got {tuple(min_volumes.shape)}")
    b, w = min_volumes.shape
    dev = min_volumes.device
    _build.refuse_grad("scan_windows", min_volumes, volume_ratios, *(carry[k] for k in CARRY_KEYS if carry is not None))
    _check("min_volumes", min_volumes, torch.float32, (b, w), dev)
    _check("volume_ratios", volume_ratios, torch.float32, (b, w), dev)
    _check("valids", valids, torch.bool, (b, w), dev)
    if win_base is not None:
        _check("win_base", win_base, torch.int32, (b,), dev)
    fresh = carry is None
    if not fresh:
        fsm.check_carry(shape, carry, b, indices=not own_carry)
        for name in CARRY_KEYS:
            x = carry[name]
            _check(f"carry[{name}]", x, torch.int32 if name == "ireg" else torch.float32, tuple(x.shape), dev)
    L, S, R = shape.long_window, shape.short_window, shape.ratio_window
    sizes = {"long_buf": L, "short_buf": S, "ratio_buf": R, "ireg": fsm.NI, "freg": fsm.NF, "kahan": fsm.NK}
    new_carry = {
        k: torch.empty((b, n), dtype=torch.int32 if k == "ireg" else torch.float32, device=dev)
        for k, n in sizes.items()
    }

    def empty(dtype):
        return torch.empty((b, w), dtype=dtype, device=dev)

    outs = WindowOutput(
        event=empty(torch.int32), event_win=empty(torch.int32), seg_valid=empty(torch.bool),
        seg_start_win=empty(torch.int32), seg_end_win=empty(torch.int32),
        seg_ratio=empty(torch.float32), seg_met_sec=empty(torch.float32),
    )
    if b == 0:
        return outs, new_carry
    raw = tuple(x.tobytes() for x in fsm.param_rows(params, b))
    prm = _param_tensors(raw, dev)
    seeds = fresh_kahan(L, bool(shape.has_initial_avg), raw[5], dev) if fresh else None
    lib = _lib()
    plan = launch_plan(b, w, shape, smem_per_block(dev.index if dev.index is not None else torch.cuda.current_device()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fvad_fsm_scan(
            0 if plan.body == "smem" else 1, b, w, plan.tile, L, S, R, int(shape.has_initial_avg),
            shape.fft_size, shape.sample_rate, float(np.float32(shape.window_sec)),
            *(x.data_ptr() for x in prm),
            min_volumes.data_ptr(), volume_ratios.data_ptr(), valids.data_ptr(),
            None if win_base is None else win_base.data_ptr(),
            int(fresh),
            *((None,) * 6 if fresh else (carry[k].data_ptr() for k in CARRY_KEYS)),
            seeds.data_ptr() if fresh else None,
            *(new_carry[k].data_ptr() for k in CARRY_KEYS),
            *(x.data_ptr() for x in outs),
            stream,
        )
    _build.check(lib, err, "scan_windows launch")
    scan_windows.launches += 1
    scan_windows.launches_by_body[plan.body] += 1
    scan_windows.last_plan = plan
    return outs, new_carry


scan_windows.launches = 0
scan_windows.launches_by_body = {"smem": 0, "global": 0}
scan_windows.last_plan = None
