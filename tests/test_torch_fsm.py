"""The port's FSM window scan, bit for bit against the native host decoder
(through the port's own binding) and the JAX package's Pallas kernel run in
interpret mode, on inputs that visit all four states, with invalid
trailing windows and per-row parameters. The CUDA kernel is held to the
same bar on a GPU by test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from formula_vad_tpu.config import VADMachineConfig
from formula_vad_tpu.pipeline import fsm as jfsm
from formula_vad_tpu.pipeline import fsm_pallas
from formula_vad_tpu_torch.pipeline import fsm, fsm_cuda, fsm_host
from formula_vad_tpu_torch.testing.synth import fsm_inputs, fsm_per_row_params

SR, FFT = 48000, 1024
CONFIGS = {
    "default": VADMachineConfig(),
    # No initial average and a 140-slot long ring: the ring wraps, and the
    # threshold base falls back to the short-term average until it fills.
    "no_initial_short_long": VADMachineConfig(initial_long_term_avg=None, long_term_speech_avg_sec=3.0),
}
# Windows by which each burst's ratio cue leads its volume (``fsm_inputs``):
# without an initial long-term average the default inputs reach no
# completed segment (their loud windows enter the 3 s long ring before the
# ratio cue shows); a 12-window lead reaches every event.
RATIO_LEAD = {"default": 0, "no_initial_short_long": 12}
REG_NAMES = (
    "long_idx", "long_cnt", "short_idx", "short_cnt", "ratio_idx", "ratio_cnt",
    "state", "start_win", "end_win", "seg_ratio_cnt",
)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_same(got, want, what):
    for field, a, b in zip(fsm.WindowOutput._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{what}: {field}"


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_version_equals_host_decoder(config, per_row):
    shape, params = fsm.statics_from_config(CONFIGS[config], SR, FFT)
    mv, vr, valid = fsm_inputs(5, 700, seed=len(config) + per_row, ratio_lead=RATIO_LEAD[config])
    if per_row:
        params = fsm_per_row_params(params, 5, seed=1)
    want, want_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    got, got_carry = fsm_cuda.scan_windows_reference(shape, params, *_torch(mv, vr, valid))
    assert_same([x.numpy() for x in got], want, "plain vs host")
    for key in want_carry:
        assert got_carry[key].numpy().tobytes() == want_carry[key].tobytes(), key
    events = np.bincount(want.event.reshape(-1), minlength=4)
    assert (events[1:] > 0).all(), f"inputs must reach every event: {events}"


def test_plain_version_equals_pallas_interpret():
    shape, params = fsm.statics_from_config(CONFIGS["default"], SR, FFT)
    jshape, jparams = jfsm.statics_from_config(CONFIGS["default"], SR, FFT)
    rows, windows = 4, 600
    mv, vr, valid = fsm_inputs(rows, windows, seed=11)
    params = fsm_per_row_params(params, rows, seed=2)
    # The Pallas wrapper builds its fresh carry from a scalar initial average.
    jparams = jfsm.FSMParams(*(jnp.asarray(x) for x in params[:5]), jnp.float32(params.initial_long_term_avg[0]))
    want, want_carry = fsm_pallas.scan_windows_pallas(
        jshape, jparams, jnp.asarray(mv), jnp.asarray(vr), jnp.asarray(valid),
        interpret=True, return_carry=True,
    )
    got, got_carry = fsm_cuda.scan_windows_reference(shape, params, *_torch(mv, vr, valid))
    assert_same([x.numpy() for x in got], [np.asarray(x) for x in want], "plain vs pallas")
    for ring in ("long_buf", "short_buf", "ratio_buf"):
        assert got_carry[ring].numpy().tobytes() == np.asarray(want_carry[ring]).tobytes(), ring
    for i, name in enumerate(REG_NAMES):
        assert np.array_equal(got_carry["ireg"][:, i].numpy(), np.asarray(want_carry[name])), name
    for i, name in enumerate(("long_last", "seg_ratio_sum", "met_sec")):
        assert got_carry["freg"][:, i].numpy().tobytes() == np.asarray(want_carry[name]).tobytes(), name


@pytest.mark.parametrize("scan", ["plain", "host"])
def test_chained_calls_equal_one_shot(scan):
    """A carry returned by one call continues the machines exactly."""
    shape, params = fsm.statics_from_config(CONFIGS["no_initial_short_long"], SR, FFT)
    mv, vr, valid = fsm_inputs(3, 500, seed=5)
    cut = 230

    def run(a, b, c, carry=None, win_base=None):
        if scan == "host":
            out, carry = fsm_host.scan_windows_host(shape, params, a, b, c, carry, win_base)
            return out, carry
        args = _torch(a, b, c)
        wb = None if win_base is None else torch.from_numpy(win_base)
        out, carry = fsm_cuda.scan_windows_reference(shape, params, *args, carry, wb)
        return [x.numpy() for x in out], carry

    whole, whole_carry = run(mv, vr, valid)
    first, carry = run(mv[:, :cut], vr[:, :cut], valid[:, :cut])
    snapshot = {k: np.array(v) for k, v in carry.items()}
    second, final = run(mv[:, cut:], vr[:, cut:], valid[:, cut:], carry, np.full(3, cut, np.int32))
    assert_same([np.concatenate([a, b], axis=1) for a, b in zip(first, second)], whole, f"chained {scan}")
    for key in whole_carry:
        assert np.asarray(final[key]).tobytes() == np.asarray(whole_carry[key]).tobytes(), key
        assert np.asarray(carry[key]).tobytes() == snapshot[key].tobytes(), f"given carry modified: {key}"


def test_cpu_tensors_take_the_plain_version():
    shape, params = fsm.statics_from_config(CONFIGS["default"], SR, FFT)
    args = _torch(*fsm_inputs(2, 50, seed=3))
    before = fsm_cuda.scan_windows.launches
    got, _ = fsm_cuda.scan_windows(shape, params, *args)
    want, _ = fsm_cuda.scan_windows_reference(shape, params, *args)
    assert_same([x.numpy() for x in got], [x.numpy() for x in want], "wrapper on cpu")
    assert fsm_cuda.scan_windows.launches == before


def test_per_row_params_reach_the_device_once_per_content():
    """The per-row parameter tensors are made once per (params, rows,
    device): a repeated call makes no new ones, a change of any of them
    misses the cache."""
    shape, params = fsm.statics_from_config(CONFIGS["default"], SR, FFT)
    mv = torch.zeros((3, 4))
    first = fsm_cuda._prepare(shape, params, mv, None, None)[3]
    assert fsm_cuda._prepare(shape, params, mv, None, None)[3] is first
    changed = fsm_cuda._prepare(shape, params._replace(threshold_factor=np.float32(11.0)), mv, None, None)[3]
    assert changed[0].tolist() == [11.0] * 3 and all(torch.equal(a, b) for a, b in zip(changed[1:], first[1:]))
    rows = fsm_cuda._prepare(shape, params, torch.zeros((5, 4)), None, None)[3]
    assert [x.shape for x in rows] == [(5,)] * 5
    assert [x.dtype for x in first] == [torch.float32, torch.float32, torch.int32, torch.int32, torch.float32]


def test_kernel_libraries_are_looked_up_once():
    """Each wrapper's library lookup (a build-cache check and the argtypes)
    is cached, off the per-call path."""
    from formula_vad_tpu_torch.models import nsnet2_cuda, nsnet2_gates_cuda
    from formula_vad_tpu_torch.ops import matmul_q8

    for mod in (fsm_cuda, nsnet2_cuda, nsnet2_gates_cuda, matmul_q8):
        assert hasattr(mod._lib, "cache_info"), mod.__name__


def test_host_binding_refuses_bad_carry_and_params():
    shape, params = fsm.statics_from_config(CONFIGS["default"], SR, FFT)
    mv, vr, valid = fsm_inputs(2, 40, seed=4)
    _, carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    bad = dict(carry, ireg=carry["ireg"].copy())
    bad["ireg"][0, fsm.I_SHORT_IDX] = shape.short_window
    with pytest.raises(ValueError, match="ring index"):
        fsm_host.scan_windows_host(shape, params, mv, vr, valid, bad)
    with pytest.raises(ValueError, match="shape"):
        fsm_host.scan_windows_host(shape, params, mv, vr[:, :10], valid)
    with pytest.raises(ValueError, match="threshold_factor"):
        fsm_host.scan_windows_host(shape, params._replace(threshold_factor=np.ones(3, np.float32)), mv, vr, valid)


# A long-term window of 1,300 s: 60,937 slots, above the shared-memory ring
# budget of an H100 block.
ABOVE_BUDGET = VADMachineConfig(long_term_speech_avg_sec=1300.0)


@pytest.mark.parametrize("rows", [1, 21, 132, 133, 660, 5000])
def test_launch_plan_smem_body(rows):
    """The smem body at the default config: one CTA a row, tiles of
    TILE_MAX windows whatever the rows, a tile count that covers W, and the
    shared memory of the tiles and the rings."""
    shape, _ = fsm.statics_from_config(CONFIGS["default"], SR, FFT)
    plan = fsm_cuda.launch_plan(rows, 937, shape)
    assert (plan.body, plan.ctas, plan.threads, plan.tile) == ("smem", rows, fsm_cuda.SMEM_THREADS, fsm_cuda.TILE_MAX)
    assert plan.tiles == -(-937 // plan.tile) and (plan.tiles - 1) * plan.tile < 937
    ring = 4 * (shape.long_window + shape.short_window + shape.ratio_window)
    assert plan.smem_bytes == fsm_cuda.TILE_BYTES * plan.tile + ring == fsm_cuda.smem_bytes(shape, plan.tile)
    assert plan.smem_bytes <= fsm_cuda.H100_SMEM_PER_BLOCK
    assert fsm_cuda.launch_plan(rows, 1, shape).tiles == 1
    assert fsm_cuda.launch_plan(rows, 0, shape).tiles == 0


def test_launch_plan_chooses_the_body_on_ring_size():
    """Rings whose CTA does not fit a block's shared memory with TILE_MAX
    windows a tile take TILE_MIN; those that fit with neither take the
    global body (one thread a row, 64 a CTA)."""
    block = fsm_cuda.H100_SMEM_PER_BLOCK
    shape, _ = fsm.statics_from_config(CONFIGS["default"], SR, FFT)
    other = shape.short_window + shape.ratio_window
    edge = {t: (block - fsm_cuda.TILE_BYTES * t) // 4 - other for t in (fsm_cuda.TILE_MAX, fsm_cuda.TILE_MIN)}
    assert fsm_cuda.launch_plan(21, 937, shape._replace(long_window=edge[fsm_cuda.TILE_MAX])).tile == fsm_cuda.TILE_MAX
    below = fsm_cuda.launch_plan(21, 937, shape._replace(long_window=edge[fsm_cuda.TILE_MAX] + 1))
    assert (below.body, below.tile) == ("smem", fsm_cuda.TILE_MIN)
    at = fsm_cuda.launch_plan(21, 937, shape._replace(long_window=edge[fsm_cuda.TILE_MIN]))
    assert (at.body, at.tile, at.tiles) == ("smem", fsm_cuda.TILE_MIN, -(-937 // fsm_cuda.TILE_MIN))
    above = fsm_cuda.launch_plan(21, 937, shape._replace(long_window=edge[fsm_cuda.TILE_MIN] + 1))
    assert above == fsm_cuda.ScanPlan("global", 1, 64, 0, 0, 0)
    big, _ = fsm.statics_from_config(ABOVE_BUDGET, SR, FFT)
    assert fsm_cuda.launch_plan(130, 937, big).body == "global"
    assert fsm_cuda.launch_plan(130, 937, big).ctas == 3
    # A card with less shared memory a block gets the smaller tile, never another result.
    assert fsm_cuda.launch_plan(21, 937, shape, 40_000).tile == fsm_cuda.TILE_MIN


def _host_seeds(shape, params, rows):
    return fsm_host.fresh_host_carry(shape, params, rows)["kahan"]


@pytest.mark.parametrize("config", sorted(CONFIGS) + ["ring_of_1"])
def test_fresh_kahan_equals_the_exact_left_folds(config):
    """The cached seeds of a fresh carry, folded once per content on the
    host, are bit for bit the plain version's fold of the fresh rings and
    the native decoder's fvad_fsm_kahan_seed, with per-row initial
    averages (some repeated, one negative zero)."""
    cfg = VADMachineConfig(long_term_speech_avg_sec=0.01) if config == "ring_of_1" else CONFIGS[config]
    shape, params = fsm.statics_from_config(cfg, SR, FFT)
    rows = 7
    params = fsm_per_row_params(params, rows, seed=4)
    init = np.random.default_rng(5).uniform(0.001, 0.05, rows).astype(np.float32)
    init[3] = init[1]
    init[5] = np.float32(-0.0)
    params = params._replace(initial_long_term_avg=init)
    if config == "ring_of_1":
        assert shape.long_window == 1
    got = fsm_cuda.fresh_kahan(
        shape.long_window, bool(shape.has_initial_avg), fsm.param_rows(params, rows)[5].tobytes(), torch.device("cpu")
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, fsm.NK)
    assert got.numpy().tobytes() == _host_seeds(shape, params, rows).tobytes()
    ring = fsm.fresh_carry(shape, params, rows, "cpu")
    plain = [x for key in ("long_buf", "short_buf", "ratio_buf") for x in fsm_cuda._kahan_seed(ring[key])]
    assert torch.stack(plain, dim=1).numpy().tobytes() == got.numpy().tobytes()


def test_fresh_kahan_is_made_once_per_content():
    shape, params = fsm.statics_from_config(CONFIGS["default"], SR, FFT)
    raw = fsm.param_rows(params, 3)[5].tobytes()
    cpu = torch.device("cpu")
    first = fsm_cuda.fresh_kahan(shape.long_window, True, raw, cpu)
    assert fsm_cuda.fresh_kahan(shape.long_window, True, raw, cpu) is first
    other = fsm.param_rows(params._replace(initial_long_term_avg=np.float32(0.01)), 3)[5].tobytes()
    assert fsm_cuda.fresh_kahan(shape.long_window, True, other, cpu) is not first
    assert fsm_cuda.fresh_kahan(shape.long_window + 1, True, raw, cpu) is not first
    assert not fsm_cuda.fresh_kahan(shape.long_window, False, raw, cpu).any()
