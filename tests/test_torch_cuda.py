"""The port's CUDA kernels on a GPU (every test here but the last three skips
without one). This file imports no jax, so it also runs on a machine
without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Bars: the GRU kernel within 1e-4 of its plain version (CUDA's expf/tanhf
and the summation order differ by ulps over 54 steps), and so the three
per-gate GRU kernels in float32; in bf16 max |dh2| <= 6e-3 and mean <= 3e-5
(another float32 summation order now and then flips the bf16 rounding of an
h value, which moves single outputs by ~1e-3 but the mean by ~4e-6; a kernel
that skipped a bf16 rounding point would sit ~4e-4 off in the mean, the
distance of the plain bf16 form from the plain float32 one); the FSM kernel's
two bodies bit for bit equal to the native host decoder on the seven outputs
and the whole carry; the int8 matmul kernel bit for bit
equal to its plain version; the slice's segments on the GPU equal to the CPU
run's. Under the int8 tier the GPU and CPU runs give the same segment count
with every boundary within one FSM window: a one-ulp difference before
quantization can move a value into the next int8 step; so under the bf16 and
bf16-storage tiers, while 'high' (bf16_3x, kernel A) keeps the CPU run's
segments. Kernel A (``gates.gru_gates_3x``: the bf16_3x recurrence and its
mixes with 'default' on the tensor cores) and kernel B
(``nsnet2_cuda.gru_stack_mixed``: kernel 1's tiles with one class at
'high' or 'default' on mma.sync) are within 5e-6 and 2e-6 of their plain
versions where no class is 'default' (kernel 5's bf16 bars where one is),
carrying a state too, and nearer them than the plain versions at other
levels; kernel B spills nothing and kernel 1 keeps the parent's bits; the
int8 tier under bf16 storage and lbr = 0 weights in the
bf16 tiers agree with the CPU.
Each tier launches its recurrence kernel and the FSM and nothing else, and
a 10-case tier-fuzz campaign on the card finds no deviation at 'high'.
The streaming path (``BatchRunner(use_offline=False)``) launches one GRU
kernel and one FSM scan a chunk step and never synchronises inside its
chunk loop; its segments equal the card's offline run and the CPU's
streaming run, and its chained FSM calls equal the host decoder bit for
bit. The bf16 GRU bodies on random gi meet the CPU's pre-flip bar (ROADMAP
§3 fault 3): mean |dh2| <= 1e-5 over each row's steps before its first
bf16 rounding flip of h2. The serving fleet (``OnlineBatchServer``) fetches
each stream's outputs to its row: the plain FSM over the card's fetched
window inputs gives the card's FSM outputs and carry bit for bit; a reset
row is a fresh stream's with no read-back; a checkpoint written on the card
continues on the CPU. The rest of the denoiser registry: an imported ONNX
file is the ``.npz`` model bit for bit on the card; the spectral gate's
gains on the card are within 1e-6 of the CPU's (``10 ** x`` differs by
ulps), and its slice launches the FSM kernel alone, with the CPU's segments.
Training: every kernel route refuses a call that needs a gradient; the
trainer's differentiable forward launches none, its gradients on the card
are the CPU's within 1e-4 of each array's largest element, and a resumed
run on the card equals a straight one bit for bit. The data mesh over
shards of the card: one launch of kernels 1 and 2 a shard, the segments
of the unsharded runs, and no synchronising call inside the sharded slab
loop or a sharded serving tick. The trainer's grid on the card: a 2 x 2
step's loss and gradients equal the CPU grid's, with no kernel launched.
"""

import ctypes

import numpy as np
import pytest
import torch

from formula_vad_tpu_torch import device as device_mod
from formula_vad_tpu_torch.config import VADConfig, VADMachineConfig
from formula_vad_tpu_torch.models import nsnet2_cuda, registry
from formula_vad_tpu_torch.models import nsnet2_gates_cuda as gates
from formula_vad_tpu_torch.ops import matmul_q8 as mq
from formula_vad_tpu_torch.ops import precision
from formula_vad_tpu_torch.parallel.runner import BatchRunner
from formula_vad_tpu_torch.parallel.slab_runner import SlabRunner
from formula_vad_tpu_torch.pipeline import fsm, fsm_cuda, fsm_host, vad
from formula_vad_tpu_torch.testing.synth import fsm_inputs, fsm_per_row_params, synth_stream

GRU_TOL = 1e-4
BF16_MAX, BF16_MEAN = 6e-3, 3e-5
SR, FFT = 48000, 1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return device_mod.resolve("cuda")


@pytest.fixture
def net(cuda_device):
    return registry.load_denoiser("demo", device=cuda_device)


def _gi1(rows, steps, seed, device):
    x = (np.random.default_rng(seed).standard_normal((rows, steps, 1200)) * 0.8).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
def test_resolve_turns_tf32_off(cuda_device):
    assert cuda_device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _biased(net):
    """``net`` with N(0, 0.3) GRU biases (numpy seed 3): the demo weights'
    biases (~0.005) are too small for a check to see a misplaced one."""
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for g in (net.gru1, net.gru2):
            for b in (g.bi, g.bh):
                b.copy_(torch.from_numpy(rng.normal(0.0, 0.3, tuple(b.shape)).astype(np.float32)))
    return net


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["demo", "biased"])
@pytest.mark.parametrize(
    "rows, steps",
    [(37, 54), (1680, 54), (16, 1), (1, 1), (1, 54), (37, 1), (1690, 54), (1690, 1), (4000, 54), (4000, 1)],
)
def test_gru_kernel_matches_plain(net, cuda_device, rows, steps, weights):
    if weights == "biased":
        net = _biased(net)
    gi1 = _gi1(rows, steps, rows, cuda_device)
    before = nsnet2_cuda.gru_stack.launches
    got = nsnet2_cuda.gru_stack(net, gi1)
    want = nsnet2_cuda.gru_stack_reference(net, gi1)
    torch.cuda.synchronize()
    assert nsnet2_cuda.gru_stack.launches == before + 1
    assert float((got - want).abs().max()) <= GRU_TOL


@pytest.mark.cuda
def test_gru_kernel_back_to_back_calls(net, cuda_device):
    """Two calls at different row counts in a row, on one stream: each gets
    its own scratch and barrier, and neither disturbs the other."""
    net = _biased(net)
    gi_a, gi_b = _gi1(4000, 20, 1, cuda_device), _gi1(37, 54, 2, cuda_device)
    got_a = nsnet2_cuda.gru_stack(net, gi_a)
    got_b = nsnet2_cuda.gru_stack(net, gi_b)
    again_a = nsnet2_cuda.gru_stack(net, gi_a)
    torch.cuda.synchronize()
    assert float((got_a - nsnet2_cuda.gru_stack_reference(net, gi_a)).abs().max()) <= GRU_TOL
    assert float((got_b - nsnet2_cuda.gru_stack_reference(net, gi_b)).abs().max()) <= GRU_TOL
    assert torch.equal(got_a, again_a)


@pytest.mark.cuda
def test_gru_kernel_refuses_a_grid_that_cannot_be_resident(net, cuda_device):
    """A plan whose grid exceeds what the card holds at once would hang at
    the first grid barrier: the C entry point refuses it before launching,
    as it refuses a plan that does not cover the rows, half a carried
    state, and a pair of class levels it has no instantiation for (no
    class at 'highest', or a level with a bf16 out)."""
    import ctypes

    plan = nsnet2_cuda.device_plan(4000, cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lib = nsnet2_cuda._lib()
    gi1 = _gi1(4000, 2, 0, cuda_device)
    out = torch.empty((4000, 2, 400), device=cuda_device)
    h1 = torch.empty((2, 4000, 400), device=cuda_device)
    barrier = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    w = (net.gru1.wh, net.gru1.bh, net.gru2.wi, net.gru2.bi, net.gru2.wh, net.gru2.bh)
    stream = torch.cuda.current_stream().cuda_stream
    g = gi1.data_ptr()
    for row_tile, row_groups, grid in ((plan.row_tile, plan.row_groups, plan.tiles), (100, 39, 100), (200, 20, 100)):
        err = lib.fvad_gru_stack(
            g, g + 1600, g + 3200, *(x.data_ptr() for x in w), out.data_ptr(), h1.data_ptr(), None,
            barrier.data_ptr(), None, None, 1200, 0, 0, 0, 4000, 2, row_tile, row_groups, plan.unit_groups, grid,
            stream,
        )
        assert err != 0, (row_tile, row_groups, grid)
    # Half a carried state (h1 without h2) is refused too, on a plan it takes.
    err = lib.fvad_gru_stack(
        g, g + 1600, g + 3200, *(x.data_ptr() for x in w), out.data_ptr(), h1.data_ptr(), None, barrier.data_ptr(),
        h1[0].data_ptr(), None, 1200, 0, 0, 0, 4000, 2, plan.row_tile, plan.row_groups, plan.unit_groups, plan.grid,
        stream,
    )
    assert err != 0
    for out_bf16, level_i, level_h in ((0, 1, 1), (0, 2, 1), (0, 3, 0), (1, 1, 0)):
        err = lib.fvad_gru_stack(
            g, g + 1600, g + 3200, *(x.data_ptr() for x in w), out.data_ptr(), h1.data_ptr(), h1.data_ptr(),
            barrier.data_ptr(), None, None, 1200, out_bf16, level_i, level_h, 4000, 2, plan.row_tile, plan.row_groups,
            plan.unit_groups, plan.grid, stream,
        )
        assert err != 0, (out_bf16, level_i, level_h)
    assert plan.tiles > plan.grid == sms * nsnet2_cuda._card(cuda_device.index or 0)[1]
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_gru_kernel_refuses_what_it_does_not_take(net, cuda_device):
    gi1 = torch.zeros((4, 3, 1200), device=cuda_device)
    misaligned = torch.zeros(4 * 3 * 1200 + 1, device=cuda_device)[1:].view(4, 3, 1200)
    for bad in (gi1.double(), gi1.transpose(0, 1), gi1[..., :600], gi1.cpu().to("meta"), misaligned):
        with pytest.raises(ValueError):
            nsnet2_cuda.gru_stack(net, bad)
    net.gru2.linear_before_reset = 0
    with pytest.raises(NotImplementedError):
        nsnet2_cuda.gru_stack(net, gi1)


@pytest.mark.cuda
def test_fsm_kernel_equals_host_decoder(cuda_device):
    shape, params = fsm.statics_from_config(VADMachineConfig(), SR, FFT)
    mv, vr, valid = fsm_inputs(9, 937, seed=6)
    params = fsm_per_row_params(params, 9, seed=3)
    want, want_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    args = [torch.from_numpy(x).to(cuda_device) for x in (mv, vr, valid)]
    before = fsm_cuda.scan_windows.launches
    got, got_carry = fsm_cuda.scan_windows(shape, params, *args)
    torch.cuda.synchronize()
    assert fsm_cuda.scan_windows.launches == before + 1
    for field, a, b in zip(fsm.WindowOutput._fields, got, want):
        a = a.cpu().numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for key in want_carry:
        assert got_carry[key].cpu().numpy().tobytes() == want_carry[key].tobytes(), key


@pytest.mark.cuda
def test_fsm_kernel_chains_through_its_carry(cuda_device):
    shape, params = fsm.statics_from_config(VADMachineConfig(long_term_speech_avg_sec=3.0), SR, FFT)
    mv, vr, valid = fsm_inputs(5, 600, seed=8)
    args = [torch.from_numpy(x).to(cuda_device) for x in (mv, vr, valid)]
    whole, whole_carry = fsm_cuda.scan_windows(shape, params, *args)
    first, carry = fsm_cuda.scan_windows(shape, params, *(x[:, :250].contiguous() for x in args))
    second, final = fsm_cuda.scan_windows(
        shape, params, *(x[:, 250:].contiguous() for x in args), carry=carry,
        win_base=torch.full((5,), 250, dtype=torch.int32, device=cuda_device),
    )
    for a, b, w in zip(first, second, whole):
        assert torch.equal(torch.cat([a, b], dim=1), w)
    for key in whole_carry:
        assert torch.equal(final[key], whole_carry[key]), key
    bad = dict(carry, ireg=carry["ireg"].clone())
    bad["ireg"][0, fsm.I_LONG_IDX] = -1
    with pytest.raises(ValueError, match="ring index"):
        fsm_cuda.scan_windows(shape, params, *args, carry=bad)


FSM_CONFIGS = {
    "default": VADMachineConfig(),
    # No initial average and a 140-slot long ring, which wraps.
    "no_initial_short_long": VADMachineConfig(initial_long_term_avg=None, long_term_speech_avg_sec=3.0),
}
# A long-term window of 1,300 s: 60,937 slots, above the shared-memory
# ring budget, so the rings stay in global memory.
FSM_ABOVE_BUDGET = VADMachineConfig(long_term_speech_avg_sec=1300.0)


def _fsm_case(config, rows, windows, seed):
    """Inputs and per-row parameters (initial long-term averages too)."""
    shape, params = fsm.statics_from_config(config, SR, FFT)
    params = fsm_per_row_params(params, rows, seed=seed)
    init = np.random.default_rng(seed).uniform(0.002, 0.01, rows).astype(np.float32)
    params = params._replace(initial_long_term_avg=init)
    lead = 0 if config.initial_long_term_avg is not None else 12
    return shape, params, fsm_inputs(rows, windows, seed=seed, ratio_lead=lead)


def _assert_fsm_equal(got, got_carry, want, want_carry, what):
    for field, a, b in zip(fsm.WindowOutput._fields, got, want):
        a = a.cpu().numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{what}: {field}"
    for key in want_carry:
        assert got_carry[key].cpu().numpy().tobytes() == want_carry[key].tobytes(), f"{what}: carry {key}"


def _fsm_vs_host(cuda_device, config, rows, windows, seed, body="smem"):
    shape, params, (mv, vr, valid) = _fsm_case(config, rows, windows, seed)
    want, want_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    args = [torch.from_numpy(x).to(cuda_device) for x in (mv, vr, valid)]
    before = dict(fsm_cuda.scan_windows.launches_by_body)
    got, got_carry = fsm_cuda.scan_windows(shape, params, *args)
    torch.cuda.synchronize()
    assert fsm_cuda.scan_windows.last_plan.body == body
    assert fsm_cuda.scan_windows.launches_by_body[body] == before[body] + 1
    _assert_fsm_equal(got, got_carry, want, want_carry, f"[{rows}, {windows}]")


def _tile(config, rows):
    shape, _ = fsm.statics_from_config(config, SR, FFT)
    return fsm_cuda.launch_plan(rows, 1, shape, fsm_cuda.smem_per_block(torch.cuda.current_device())).tile


@pytest.mark.cuda
@pytest.mark.parametrize("windows", ["1", "tile-1", "tile", "tile+1", "20000"])
@pytest.mark.parametrize("config", sorted(FSM_CONFIGS))
def test_fsm_smem_body_at_tile_edges(cuda_device, config, windows):
    """The smem body bit for bit against the host decoder on the seven
    outputs and the whole carry, at 21 rows and W around one tile, and at
    20,000 windows (more than the long ring, and many tiles)."""
    tile = _tile(FSM_CONFIGS[config], 21)
    w = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "20000": 20000}[windows]
    _fsm_vs_host(cuda_device, FSM_CONFIGS[config], 21, w, seed=w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 660])
@pytest.mark.parametrize("config", sorted(FSM_CONFIGS) + ["long_ring"])
def test_fsm_smem_body_rows(cuda_device, config, rows):
    """One row, and 660 rows (five an SM on 132 SMs, more than one wave);
    a 20-minute long ring (56,250 slots) does not fit a block with the
    larger tile and takes the smaller."""
    cfg = VADMachineConfig(long_term_speech_avg_sec=1200.0) if config == "long_ring" else FSM_CONFIGS[config]
    if config == "long_ring":
        assert _tile(cfg, rows) == fsm_cuda.TILE_MIN
    _fsm_vs_host(cuda_device, cfg, rows, 937, seed=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(FSM_CONFIGS))
def test_fsm_chain_split_off_a_tile_edge(cuda_device, config):
    """A carry handed over at a window inside a tile continues the machines
    exactly: both halves equal the one-shot call and the host decoder."""
    rows, windows = 21, 937
    cut = _tile(FSM_CONFIGS[config], rows) + 45
    shape, params, (mv, vr, valid) = _fsm_case(FSM_CONFIGS[config], rows, windows, seed=9)
    want, want_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    args = [torch.from_numpy(x).to(cuda_device) for x in (mv, vr, valid)]
    first, carry = fsm_cuda.scan_windows(shape, params, *(x[:, :cut].contiguous() for x in args))
    snapshot = {k: v.clone() for k, v in carry.items()}
    second, final = fsm_cuda.scan_windows(
        shape, params, *(x[:, cut:].contiguous() for x in args), carry=carry,
        win_base=torch.full((rows,), cut, dtype=torch.int32, device=cuda_device),
    )
    torch.cuda.synchronize()
    joined = [torch.cat([a, b], dim=1) for a, b in zip(first, second)]
    _assert_fsm_equal(joined, final, want, want_carry, f"split at {cut}")
    for key in carry:
        assert torch.equal(carry[key], snapshot[key]), f"given carry modified: {key}"


@pytest.mark.cuda
def test_fsm_rings_above_the_budget_take_the_global_body(cuda_device):
    """A long-term window above the shared-memory budget runs the global body
    (rings in global memory), counted apart, fresh and continuing a carry."""
    shape, params, (mv, vr, valid) = _fsm_case(FSM_ABOVE_BUDGET, 5, 600, seed=4)
    assert fsm_cuda.smem_bytes(shape, fsm_cuda.TILE_MIN) > fsm_cuda.smem_per_block(torch.cuda.current_device())
    _fsm_vs_host(cuda_device, FSM_ABOVE_BUDGET, 5, 600, seed=4, body="global")
    want, want_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    args = [torch.from_numpy(x).to(cuda_device) for x in (mv, vr, valid)]
    first, carry = fsm_cuda.scan_windows(shape, params, *(x[:, :250].contiguous() for x in args))
    second, final = fsm_cuda.scan_windows(
        shape, params, *(x[:, 250:].contiguous() for x in args), carry=carry,
        win_base=torch.full((5,), 250, dtype=torch.int32, device=cuda_device),
    )
    assert fsm_cuda.scan_windows.last_plan.body == "global"
    _assert_fsm_equal([torch.cat([a, b], dim=1) for a, b in zip(first, second)], final, want, want_carry, "global split")


@pytest.mark.cuda
def test_fsm_fresh_call_makes_no_copy_and_no_sync(cuda_device):
    """Once its parameters and seeds are cached (one warm-up call), a fresh
    call builds its carry on the card: no host-to-device copy, no
    synchronisation."""
    shape, params, (mv, vr, valid) = _fsm_case(FSM_CONFIGS["default"], 21, 937, seed=2)
    args = [torch.from_numpy(x).to(cuda_device) for x in (mv, vr, valid)]
    fsm_cuda.scan_windows(shape, params, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_carry = fsm_cuda.scan_windows(shape, params, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    _assert_fsm_equal(got, got_carry, want, want_carry, "fresh call")


@pytest.mark.cuda
def test_fsm_plan_matches_the_kernel(cuda_device):
    """The host plan's shared-memory count is the kernel's, and fits the card."""
    lib = fsm_cuda._lib()
    block = fsm_cuda.smem_per_block(torch.cuda.current_device())
    assert block == fsm_cuda.H100_SMEM_PER_BLOCK or "H100" not in torch.cuda.get_device_name()
    for config in (*FSM_CONFIGS.values(), FSM_ABOVE_BUDGET):
        shape, _ = fsm.statics_from_config(config, SR, FFT)
        for tile in (32, 96, 256):
            want = lib.fvad_fsm_smem_bytes(tile, shape.long_window, shape.short_window, shape.ratio_window)
            assert fsm_cuda.smem_bytes(shape, tile) == want
        for rows in (1, 21, 660, 5000):
            plan = fsm_cuda.launch_plan(rows, 937, shape, block)
            assert plan.body == "global" or plan.smem_bytes <= block


@pytest.mark.cuda
def test_slice_on_gpu_equals_cpu(net, cuda_device):
    rng = np.random.default_rng(3)
    audio = np.stack([synth_stream(rng, 20.0)[0] for _ in range(3)])
    lengths = [audio.shape[-1], audio.shape[-1] - 50_000, audio.shape[-1] - 200_000]
    counts = (nsnet2_cuda.gru_stack.launches, fsm_cuda.scan_windows.launches)
    gpu = BatchRunner(net, VADConfig()).run(audio, lengths)
    assert nsnet2_cuda.gru_stack.launches > counts[0] and fsm_cuda.scan_windows.launches > counts[1]
    cpu = BatchRunner(registry.load_denoiser("demo", device="cpu"), VADConfig()).run(audio, lengths)
    assert [r.segments for r in gpu] == [r.segments for r in cpu]
    assert sum(len(r.segments) for r in gpu) > 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "r, k, n, offset",
    [
        (37, 161, 400, 0), (100, 161, 161, 0), (300, 600, 161, 0), (129, 600, 600, 0), (5, 7, 3, 0),
        (1680, 400, 1200, 0),
        # the int8 tier's six products, rows cut to 12,345 (a ragged last tile)
        (12345, 161, 400, 0), (12345, 400, 1200, 0), (12345, 400, 600, 0), (12345, 600, 600, 0), (12345, 600, 161, 0),
        # rows just past a tile edge; A at a byte offset of 1, 4 and 8
        (129, 400, 1200, 0), (257, 161, 400, 0), (257, 400, 1200, 1), (257, 400, 1200, 4), (257, 400, 1200, 8),
        (300, 600, 161, 1), (300, 600, 161, 8),
        # a K the wgmma body does not hold
        (130, 700, 200, 0),
        # a chunk step's in-scan product at 2 and 42 GRU rows, and its
        # fc_in and out products at 2 rows
        (2, 400, 1200, 0), (42, 400, 1200, 0), (108, 161, 400, 0), (100, 600, 161, 0),
    ],
)
def test_matmul_q8_kernel_matches_plain(cuda_device, r, k, n, offset):
    """Each call takes the path ``select_path`` names from the shape and A's
    alignment (the mma_sync body at K = 700, the wgmma body elsewhere), and
    equals the plain version bit for bit. The weights hold non-zero bytes
    past K, which no path may add in: A is zero there on every path, even
    where a 16-byte piece of A runs into the next row."""
    rng = np.random.default_rng(r * k + n + offset)
    flat = torch.from_numpy(rng.integers(-127, 128, r * k + offset).astype(np.int8)).to(cuda_device)
    a = flat[offset:].view(r, k)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(cuda_device)
    s = torch.from_numpy((rng.random(n) * 1e-3).astype(np.float32)).to(cuda_device)
    row = torch.from_numpy(rng.random((r, 1)).astype(np.float32) * 2.0).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for w in (mq.Q8Weight.pack(b, s), mq.Q8Weight.pack(b, s, bias)):
        pad = w.qt.shape[1] - k
        w.qt[:, k:] = torch.from_numpy(rng.integers(1, 128, (n, pad)).astype(np.int8)).to(cuda_device)
        for order in mq.ORDERS:
            for rs in (None, row):
                for dtype in mq.OUT_DTYPES:
                    before = mq.matmul_q8.launches
                    got = mq.matmul_q8(a, w, rs, order=order, out_dtype=dtype)
                    want = mq.matmul_q8_reference(a, w, rs, order=order, out_dtype=dtype)
                    torch.cuda.synchronize()
                    assert mq.matmul_q8.launches == before + 1
                    assert mq.matmul_q8.last_path == mq.select_path(r, k, n, dtype, a.data_ptr() % 16, sms)
                    assert torch.equal(got, want), (order, rs is not None, dtype, w.bias is not None)
    assert mq.select_path(r, k, n, torch.float32, offset, sms).name == ("wgmma" if k <= mq.K_PAD_MAX else "mma_sync")
    exact = (a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(np.int64)).astype(np.float32)
    got = mq.matmul_q8(a, mq.Q8Weight.pack(b, torch.ones(n, device=cuda_device)))
    assert got.cpu().numpy().tobytes() == exact.tobytes()


@pytest.mark.cuda
def test_matmul_q8_plans_the_kernels_shared_memory(cuda_device):
    """The host's tile plan sizes shared memory with the kernel's own sum."""
    lib = mq._lib()
    for bn in mq.TILE_NS:
        for k_pad in range(32, mq.K_PAD_MAX + 1, 32):
            for a_tma in (False, True):
                assert lib.fvad_matmul_q8_smem_bytes(bn, k_pad, int(a_tma)) == mq.smem_bytes(bn, k_pad, a_tma)


@pytest.mark.cuda
def test_matmul_q8_kernel_refuses_what_it_does_not_take(cuda_device):
    b = torch.ones((32, 16), dtype=torch.int8, device=cuda_device)
    w = mq.Q8Weight.pack(b, torch.ones(16, device=cuda_device))
    a = torch.ones((64, 64), dtype=torch.int8, device=cuda_device)
    for bad in (a[:, :32].float(), a[:, :32], a[:32].t()):
        with pytest.raises(ValueError):
            mq.matmul_q8(bad, w)
    with pytest.raises(ValueError, match="weight"):
        mq.matmul_q8(a[:, :32].contiguous(), mq.Q8Weight.pack(b.cpu(), torch.ones(16)))
    # The C entry point refuses the wgmma body at a K it cannot hold, before any launch.
    wide = mq.Q8Weight.pack(torch.ones((700, 16), dtype=torch.int8, device=cuda_device), torch.ones(16, device=cuda_device))
    a_wide, out = torch.ones((4, 700), dtype=torch.int8, device=cuda_device), torch.empty((4, 16), device=cuda_device)
    lib = mq._lib()
    err = lib.fvad_matmul_q8(a_wide.data_ptr(), wide.qt.data_ptr(), wide.scale.data_ptr(), None, None, out.data_ptr(),
                             4, 16, 700, 704, 0, 0, mq.PATHS.index("wgmma"), 128, 1, 4, 0,
                             ctypes.create_string_buffer(128), torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.cuda
def test_int8_slice_on_gpu_matches_cpu(net, cuda_device):
    rng = np.random.default_rng(3)
    audio = np.stack([synth_stream(rng, 20.0)[0] for _ in range(3)])
    lengths = [audio.shape[-1], audio.shape[-1] - 50_000, audio.shape[-1] - 200_000]
    counts = (nsnet2_cuda.gru_stack.launches, mq.matmul_q8.launches)
    precision.set_quant("int8")
    try:
        gpu = BatchRunner(net, VADConfig()).run(audio, lengths)
        assert nsnet2_cuda.gru_stack.launches == counts[0]
        assert mq.matmul_q8.launches == counts[1] + 167
        cpu = BatchRunner(registry.load_denoiser("demo", device="cpu"), VADConfig()).run(audio, lengths)
    finally:
        precision.set_quant("off")
    assert sum(len(r.segments) for r in gpu) > 0
    for g, c in zip(gpu, cpu):
        assert len(g.segments) == len(c.segments)
        for a, b in zip(g.segments, c.segments):
            assert abs(a["sample_from"] - b["sample_from"]) <= FFT and abs(a["sample_to"] - b["sample_to"]) <= FFT


def _gi3(net, rows, steps, seed, device):
    feats = np.random.default_rng(seed).normal(-3.0, 1.5, (rows, steps, 161)).astype(np.float32)
    with torch.inference_mode():
        return tuple(g.contiguous() for g in gates.gi_gates(net, net.fc_in(torch.from_numpy(feats).to(device))))


GATE_KERNELS = {
    "k4": (gates.gru_gates, lambda gw, gi, dt: gates.gru_gates_reference(gw, *gi)),
    "k5": (gates.gru_gates_p, lambda gw, gi, dt: gates.gru_gates_p_reference(gw, *gi)),
    "k6": (gates.gru_gates_f, lambda gw, gi, dt: gates.gru_gates_f_reference(gw, *gi)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(GATE_KERNELS))
@pytest.mark.parametrize("dtype", gates.DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rows, steps", [(37, 54), (1680, 54), (16, 1)])
def test_gru_gates_kernels_match_plain(net, cuda_device, kernel, dtype, rows, steps):
    wrapper, plain = GATE_KERNELS[kernel]
    gi = _gi3(net, rows, steps, rows, cuda_device)
    before = wrapper.launches
    with torch.inference_mode():
        got = wrapper(net, *gi, dtype=dtype)
        want = plain(gates.gate_weights(net, dtype), gi, dtype)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.dtype == want.dtype and got.shape == (rows, steps, 400)
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= GRU_TOL
    else:
        assert float(d.max()) <= BF16_MAX and float(d.mean()) <= BF16_MEAN, (float(d.max()), float(d.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", gates.DTYPES, ids=["f32", "bf16"])
def test_gru_gates_f_tile_and_out_dtype(net, cuda_device, dtype):
    gi = _gi3(net, 1680, 20, 4, cuda_device)
    with torch.inference_mode():
        for out_dtype in gates.DTYPES:
            whole = gates.gru_gates_f(net, *gi, dtype=dtype, out_dtype=out_dtype)
            assert whole.dtype == out_dtype
            for tile in (840, 416, 16, 5, 4096):
                assert torch.equal(gates.gru_gates_f(net, *gi, dtype=dtype, tile=tile, out_dtype=out_dtype), whole)
        # bf16 out is the float32 out rounded once.
        f32 = gates.gru_gates_f(net, *gi, dtype=dtype, out_dtype=torch.float32)
        assert torch.equal(gates.gru_gates_f(net, *gi, dtype=dtype, out_dtype=torch.bfloat16), f32.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(GATE_KERNELS))
@pytest.mark.parametrize("rows, steps", [(1, 1), (1, 54), (37, 1), (1690, 54), (1690, 1), (4000, 54), (4000, 1)])
def test_gru_gates_f32_forms_at_ragged_shapes(net, cuda_device, kernel, rows, steps):
    """The float32 forms run on kernel 1's kernel: its ragged row groups and
    multi-wave grids, counted as the wrapper's launch and not gru_stack's."""
    net = _biased(net)
    wrapper, plain = GATE_KERNELS[kernel]
    rng = np.random.default_rng(rows * steps)
    gi = [torch.from_numpy((rng.standard_normal((rows, steps, 400)) * 0.8).astype(np.float32)).to(cuda_device)
          for _ in range(3)]
    counts = (wrapper.launches, nsnet2_cuda.gru_stack.launches)
    got = wrapper(net, *gi)
    want = plain(gates.gate_weights(net, torch.float32), gi, torch.float32)
    torch.cuda.synchronize()
    assert (wrapper.launches, nsnet2_cuda.gru_stack.launches) == (counts[0] + 1, counts[1])
    assert got.dtype == torch.float32 and float((got - want).abs().max()) <= GRU_TOL


@pytest.mark.cuda
def test_gru_gates_refuse_what_they_do_not_take(net, cuda_device):
    gi = _gi3(net, 8, 3, 0, cuda_device)
    for wrapper in (gates.gru_gates, gates.gru_gates_p, gates.gru_gates_f):
        with pytest.raises(ValueError):
            wrapper(net, gi[0][..., :200], gi[1][..., :200], gi[2][..., :200])
        with pytest.raises(ValueError):
            wrapper(net, *gi, dtype=torch.float16)
        misaligned = torch.empty(8 * 3 * 400 + 1, device=cuda_device)[1:].view(8, 3, 400)
        with pytest.raises(ValueError, match="aligned"):
            wrapper(net, misaligned, *gi[1:])
    with pytest.raises(ValueError, match="tile"):
        gates.gru_gates_f(net, *gi, tile=0)
    # The float32 launcher itself takes CUDA float32 operands and out float32 or bf16 only.
    biases = gates.stacked_biases(net)
    with pytest.raises(ValueError, match="CUDA"):
        nsnet2_cuda.gru_stack_gates(net, tuple(g.cpu() for g in gi), biases, torch.float32)
    with pytest.raises(ValueError, match="out_dtype"):
        nsnet2_cuda.gru_stack_gates(net, gi, biases, torch.float16)
    with pytest.raises(ValueError, match="bh1"):
        nsnet2_cuda.gru_stack_gates(net, gi, (biases[0][:400],) + biases[1:], torch.float32)
    # The bf16 body (csrc/gru_gates_p.cu) holds the bf16 forms only: it
    # refuses float32 weights, and operand types its kind does not take,
    # before any launch.
    lib = gates._lib()
    w = gates.gate_weights(net, torch.bfloat16)
    x = torch.empty((2, 2, 1, 25, 32, 4), dtype=torch.int32, device=cuda_device)
    barrier = torch.zeros((8, 32), dtype=torch.int32, device=cuda_device)
    out = torch.empty((8, 3, 400), device=cuda_device)
    for kind, w_bf16, gi_bf16, out_bf16 in ((4, 0, 1, 0), (6, 0, 1, 0), (5, 0, 0, 0), (4, 1, 0, 0), (4, 1, 1, 1),
                                            (5, 1, 1, 0), (5, 1, 0, 1), (6, 1, 0, 0), (7, 1, 1, 0)):
        err = lib.fvad_gru_gates_p(kind, w_bf16, gi_bf16, out_bf16, *(g.data_ptr() for g in gi), w.units.data_ptr(),
                                   w.b8.data_ptr(), out.data_ptr(), x[0].data_ptr(), x[1].data_ptr(),
                                   barrier.data_ptr(), None, None, None, None, 8, 3, 1, 1, 1,
                                   torch.cuda.current_stream().cuda_stream)
        assert err != 0, (kind, w_bf16, gi_bf16, out_bf16)
    assert lib.fvad_gru_gates_p_smem_bytes(7, 1) == -1
    net.gru1.linear_before_reset = 0
    for wrapper in (gates.gru_gates, gates.gru_gates_p, gates.gru_gates_f):
        for dtype in gates.DTYPES:
            with pytest.raises(NotImplementedError):
                wrapper(net, *gi, dtype=dtype)
    with pytest.raises(NotImplementedError):
        nsnet2_cuda.gru_stack_gates(net, gi, biases, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 54])
@pytest.mark.parametrize("rows", [1, 15, 17, 337, 1680, 4000])
def test_gru_gates_p_bf16_at_ragged_shapes(net, cuda_device, rows, steps):
    """Kernel 5 in bf16 (csrc/gru_gates_p.cu) against its plain version,
    on gi as the bf16 tier makes it (``gi_gates`` of the fc_in output): a
    partial 16-row tile, one tile a CTA, several tiles a CTA, and 4,000
    rows, which take two launches of 25 tiles a CTA; one count a launch."""
    net = _biased(net)
    gi = _gi3(net, rows, steps, rows * steps, cuda_device)
    before = gates.gru_gates_p.launches
    with torch.inference_mode():
        got = gates.gru_gates_p(net, *gi, dtype=torch.bfloat16)
        want = gates.gru_gates_p_reference(gates.gate_weights(net, torch.bfloat16), *gi)
    torch.cuda.synchronize()
    assert gates.gru_gates_p.launches == before + len(gates.device_p_plan(rows, cuda_device))
    assert got.dtype == torch.float32 and got.shape == (rows, steps, 400)
    d = (got - want).abs()
    assert float(d.max()) <= BF16_MAX and float(d.mean()) <= BF16_MEAN, (float(d.max()), float(d.mean()))


@pytest.mark.cuda
def test_gru_gates_p_bf16_rows_are_independent(net, cuda_device):
    """A row's bits depend on its own inputs only: a repeated call, and the
    first 17 rows of the 1,680-row call against a 17-row call. The calls
    share the stream's barrier counters, which each launch leaves at 0."""
    net = _biased(net)
    gi = _gi3(net, 1680, 54, 8, cuda_device)
    with torch.inference_mode():
        whole = gates.gru_gates_p(net, *gi, dtype=torch.bfloat16)
        again = gates.gru_gates_p(net, *gi, dtype=torch.bfloat16)
        part = gates.gru_gates_p(net, *(g[:17].contiguous() for g in gi), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(whole, again)
    assert torch.equal(part, whole[:17])
    barrier = gates._p_barrier(whole.device, torch.cuda.current_stream(whole.device).cuda_stream)
    assert not bool(barrier.any())


@pytest.mark.cuda
def test_gru_gates_p_bf16_refuses_what_it_does_not_take(net, cuda_device):
    gi = _gi3(net, 40, 3, 0, cuda_device)
    misaligned = torch.empty(40 * 3 * 400 + 1, device=cuda_device)[1:].view(40, 3, 400)
    with pytest.raises(ValueError, match="aligned"):
        gates.gru_gates_p(net, misaligned, *gi[1:], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        gates.gru_gates_p(net, *gi, dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        gates.gru_gates_p(net, gi[0].transpose(0, 1).contiguous().transpose(0, 1), *gi[1:], dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gates.gru_gates_p(net, *(g[..., :200] for g in gi), dtype=torch.bfloat16)
    # The C entry point refuses, before any launch, a plan that does not
    # cover the tiles, a CTA of more tiles than its shared memory holds, and
    # a grid the card cannot hold at once.
    lib = gates._lib()
    w = gates.gate_weights(net, torch.bfloat16)
    out = torch.empty((40, 3, 400), device=cuda_device)
    x = torch.empty((2, 2, 3, 25, 32, 4), dtype=torch.int32, device=cuda_device)
    barrier = torch.zeros((8, 32), dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, tiles, groups, per in ((40, 2, 1, 2), (40, 3, 1, 2), (40, 3, 3, 2), (16 * 29, 29, 1, 29),
                                  (16 * (sms // 25 + 1), sms // 25 + 1, sms // 25 + 1, 1)):
        err = lib.fvad_gru_gates_p(5, 1, 0, 0, *(g.data_ptr() for g in gi), w.units.data_ptr(), w.b8.data_ptr(),
                                   out.data_ptr(), x[0].data_ptr(), x[1].data_ptr(), barrier.data_ptr(),
                                   None, None, None, None, n, 3, tiles, groups, per, stream)
        assert err != 0, (n, tiles, groups, per)
    # A carried state without its final-state buffer (h1_T), or with kernel
    # 6's h2_T on kernel 5, is refused on a plan the kernel takes.
    h = torch.zeros((40, 400), device=cuda_device)
    for h1_t, h2_t in ((None, None), (h.data_ptr(), h.data_ptr())):
        err = lib.fvad_gru_gates_p(5, 1, 0, 0, *(g.data_ptr() for g in gi), w.units.data_ptr(), w.b8.data_ptr(),
                                   out.data_ptr(), x[0].data_ptr(), x[1].data_ptr(), barrier.data_ptr(),
                                   h.data_ptr(), h.data_ptr(), h1_t, h2_t, 40, 3, 3, 1, 3, stream)
        assert err != 0, (h1_t, h2_t)
    torch.cuda.synchronize()
    for kind in (4, 5, 6):
        for per in (1, 21, gates.P_MAX_TILES):
            assert lib.fvad_gru_gates_p_smem_bytes(kind, per) == gates.PLaunch(0, 16, 1, 1, per).smem_bytes(kind)


BF16_W9_KERNELS = {"k4": gates.gru_gates, "k6": gates.gru_gates_f}


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 54])
@pytest.mark.parametrize("rows", [1, 15, 17, 337, 1680, 4000])
@pytest.mark.parametrize("kernel", sorted(BF16_W9_KERNELS))
def test_gru_gates_4_and_6_bf16_at_ragged_shapes(net, cuda_device, kernel, rows, steps):
    """Kernels 4 and 6 in bf16, on the bf16 body of kernel 5
    (csrc/gru_gates_p.cu), against their plain versions on gi as the tool
    makes it: a partial 16-row tile, one tile a CTA, several tiles a CTA,
    and 4,000 rows, which take two launches; one count a launch."""
    net = _biased(net)
    wrapper, plain = GATE_KERNELS[kernel]
    gi = tuple(g.to(torch.bfloat16) for g in _gi3(net, rows, steps, rows * steps, cuda_device))
    before = wrapper.launches
    with torch.inference_mode():
        got = wrapper(net, *gi, dtype=torch.bfloat16)
        want = plain(gates.gate_weights(net, torch.bfloat16), gi, torch.bfloat16)
    torch.cuda.synchronize()
    assert wrapper.launches == before + len(gates.device_p_plan(rows, cuda_device))
    assert len(gates.device_p_plan(rows, cuda_device)) == (2 if rows == 4000 else 1)
    assert got.dtype == want.dtype and got.shape == (rows, steps, 400)
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= BF16_MAX and float(d.mean()) <= BF16_MEAN, (float(d.max()), float(d.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(BF16_W9_KERNELS))
def test_gru_gates_4_and_6_bf16_rows_are_independent(net, cuda_device, kernel):
    """As kernel 5's: a repeated call, and the first 17 rows of a 1,680-row
    call against a 17-row call, bit for bit; the barrier counters left 0."""
    net = _biased(net)
    wrapper = BF16_W9_KERNELS[kernel]
    gi = _gi3(net, 1680, 54, 9, cuda_device)
    with torch.inference_mode():
        whole = wrapper(net, *gi, dtype=torch.bfloat16)
        again = wrapper(net, *gi, dtype=torch.bfloat16)
        part = wrapper(net, *(g[:17].contiguous() for g in gi), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(whole, again)
    assert torch.equal(part, whole[:17])
    barrier = gates._p_barrier(whole.device, torch.cuda.current_stream(whole.device).cuda_stream)
    assert not bool(barrier.any())


@pytest.mark.cuda
def test_lbr0_net_scores_on_the_card(cuda_device):
    """linear_before_reset = 0 weights, which the GRU kernel does not take,
    score on the card through the plain per-step loop, as on the CPU."""
    nets = {}
    for dev in ("cpu", cuda_device):
        nets[dev] = _biased(registry.load_denoiser("demo", device=dev))
        nets[dev].gru1.linear_before_reset = nets[dev].gru2.linear_before_reset = 0
    feats = np.random.default_rng(7).normal(-3.0, 1.5, (6, 54, 161)).astype(np.float32)
    before = nsnet2_cuda.gru_stack.launches
    with torch.inference_mode():
        got = nets[cuda_device](torch.from_numpy(feats).to(cuda_device), out_frames=50)
        want = nets["cpu"](torch.from_numpy(feats), out_frames=50)
    torch.cuda.synchronize()
    assert nsnet2_cuda.gru_stack.launches == before
    assert got.shape == (6, 50, 161) and float((got.cpu() - want).abs().max()) <= GRU_TOL


@pytest.mark.cuda
def test_bf16_tier_slice_on_gpu_matches_cpu(net, cuda_device):
    rng = np.random.default_rng(3)
    audio = np.stack([synth_stream(rng, 20.0)[0] for _ in range(3)])
    lengths = [audio.shape[-1], audio.shape[-1] - 50_000, audio.shape[-1] - 200_000]
    counts = (nsnet2_cuda.gru_stack.launches, gates.gru_gates_p.launches)
    precision.set_matmul_precision("default")
    try:
        gpu = BatchRunner(net, VADConfig()).run(audio, lengths)
        assert nsnet2_cuda.gru_stack.launches == counts[0]
        assert gates.gru_gates_p.launches == counts[1] + 1
        cpu = BatchRunner(registry.load_denoiser("demo", device="cpu"), VADConfig()).run(audio, lengths)
    finally:
        precision.set_matmul_precision("highest")
    assert sum(len(r.segments) for r in gpu) > 0
    for g, c in zip(gpu, cpu):
        assert len(g.segments) == len(c.segments)
        for a, b in zip(g.segments, c.segments):
            assert abs(a["sample_from"] - b["sample_from"]) <= FFT and abs(a["sample_to"] - b["sample_to"]) <= FFT


# Each tier (global level, io dtype) and the launches of one 3-stream
# forward: its recurrence kernel and the FSM, nothing else.
TIERS = {
    "float": (("highest", "f32"), {"gru_stack": 1}),
    "high": (("high", "f32"), {"gru_gates_3x": 1}),
    "bf16": (("default", "f32"), {"gru_gates_p": 1}),
    "bf16_io": (("default", "bf16"), {"gru_gates_f": 1}),
}
COUNTERS = {"gru_stack": nsnet2_cuda.gru_stack, "gru_gates": gates.gru_gates, "gru_gates_p": gates.gru_gates_p,
            "gru_gates_f": gates.gru_gates_f, "matmul_q8": mq.matmul_q8, "scan_windows": fsm_cuda.scan_windows,
            "gru_gates_3x": gates.gru_gates_3x, "gru_stack_mixed": nsnet2_cuda.gru_stack_mixed}


def _set_tier(level, io):
    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_each_tier_launches_its_kernels(net, cuda_device, tier):
    """A 3-stream forward at each tier launches its recurrence kernel and
    the FSM once each and no other kernel; its segments keep the CPU run's
    (identical at 'highest' and 'high', the same count with every boundary
    within one FSM window in the bf16 tiers)."""
    rng = np.random.default_rng(3)
    audio = np.stack([synth_stream(rng, 20.0)[0] for _ in range(3)])
    (level, io), launches = TIERS[tier]
    _set_tier(level, io)
    try:
        before = {name: fn.launches for name, fn in COUNTERS.items()}
        gpu = BatchRunner(net, VADConfig()).run(audio)
        got = {name: fn.launches - before[name] for name, fn in COUNTERS.items()}
        cpu = BatchRunner(registry.load_denoiser("demo", device="cpu"), VADConfig()).run(audio)
    finally:
        _set_tier("highest", "f32")
    assert got == dict(dict.fromkeys(COUNTERS, 0), scan_windows=1, **launches)
    assert sum(len(r.segments) for r in gpu) > 0
    tol = 0 if level != "default" else FFT
    for g, c in zip(gpu, cpu):
        assert len(g.segments) == len(c.segments)
        for a, b in zip(g.segments, c.segments):
            assert abs(a["sample_from"] - b["sample_from"]) <= tol and abs(a["sample_to"] - b["sample_to"]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 1680])
def test_kernel_6_on_the_bf16_storage_path(net, cuda_device, rows):
    """Kernel 6 in bf16 with a bf16 out, on the gi the bf16-storage tier
    hands it (the per-gate projections of the bf16 fc_in output), against
    its plain version: the bf16 bars."""
    feats = torch.from_numpy(np.random.default_rng(0).normal(-3.0, 1.5, (rows, 54, 161)).astype(np.float32))
    precision.set_io_dtype("bf16")
    try:
        with torch.inference_mode():
            gi = gates.gi_gates(net, net.fc_in(precision.io_cast(feats.to(cuda_device))))
            got = gates.gru_gates_f(net, *gi, dtype=torch.bfloat16, out_dtype=torch.bfloat16)
            want = gates.gru_gates_f_reference(gates.gate_weights(net, torch.bfloat16), *(g.to(torch.bfloat16) for g in gi),
                                               out_dtype=torch.bfloat16)
    finally:
        precision.set_io_dtype("f32")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= BF16_MAX and float(d.mean()) <= BF16_MEAN, (float(d.max()), float(d.mean()))


@pytest.mark.cuda
def test_tier_campaign_on_the_card(net, cuda_device):
    """10 cases of the tier-fuzz campaign on the demo weights: non-vacuous,
    and 'high' deviates in no case."""
    from formula_vad_tpu_torch.testing import tier_fuzz

    stats = tier_fuzz.run_campaign(net, n_cases=10)
    assert precision.matmul_precision() == "highest" and precision.io_dtype() is None
    assert stats["highest"].n_cases == 10 and stats["highest"].n_boundaries >= 10, tier_fuzz.format_table(stats)
    assert stats["high"].deviated_cases == 0, tier_fuzz.format_table(stats)


SLAB_CHUNKS = 32  # 16 s slabs


def _slab_batch(n_slabs=3, streams=3, seed=5):
    """``streams`` stereo streams a little short of ``n_slabs`` 16 s slabs,
    ragged, one ending inside a chunk."""
    rng = np.random.default_rng(seed)
    n = n_slabs * SLAB_CHUNKS * 24000
    lengths = [n - 30_000 - 61_111 * i for i in range(streams)]
    audio = np.zeros((streams, 2, n), np.float32)
    for i, length in enumerate(lengths):
        audio[i, :, :length] = synth_stream(rng, n / SR)[0][:, :length]
    return audio, lengths


def _capture(runner):
    """Wrap ``runner``'s front end and final fetch: -> a dict that collects
    each slab's FSM inputs and the fetched FSM outputs."""
    seen = {"inputs": []}
    front_end, fetch = runner._front_end, runner._fetch

    def capture_front_end(*args):
        out = front_end(*args)
        seen["inputs"].append(out[1:])
        return out

    def capture_fetch(slab_outs):
        seen["outputs"] = fetch(slab_outs)
        return seen["outputs"]

    runner._front_end, runner._fetch = capture_front_end, capture_fetch
    return seen


@pytest.mark.cuda
def test_slab_runner_chains_the_fsm_bit_for_bit(net, cuda_device):
    """Three 16 s slabs on the card: the FSM outputs chained over the slabs
    equal the host decoder's single call over all their windows, bit for
    bit, with one GRU-kernel launch and one smem-body FSM launch a slab;
    the segments equal the one-shot runner's and the host-FSM slab run's."""
    audio, lengths = _slab_batch()
    runner = SlabRunner(net, VADConfig(), slab_chunks=SLAB_CHUNKS)
    seen = _capture(runner)
    before = (nsnet2_cuda.gru_stack.launches, fsm_cuda.scan_windows.launches_by_body["smem"])
    got = runner.run(audio, lengths)
    assert nsnet2_cuda.gru_stack.launches - before[0] == 3
    assert fsm_cuda.scan_windows.launches_by_body["smem"] - before[1] == 3
    mv, rt, va = (torch.cat(xs, dim=1).cpu().numpy() for xs in zip(*seen["inputs"]))
    assert mv.shape == (3, 3 * SLAB_CHUNKS * 24000 // FFT)
    shape, params = runner.st.fsm_shape, runner.st.fsm_params
    want, _ = fsm_host.scan_windows_host(shape, params, mv, rt, va)
    for field, a, b in zip(fsm.WindowOutput._fields, seen["outputs"], want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert [r.segments for r in got] == [r.segments for r in BatchRunner(net, VADConfig()).run(audio, lengths)]
    host = SlabRunner(net, VADConfig(), slab_chunks=SLAB_CHUNKS, use_host_fsm=True).run(audio, lengths)
    assert [r.segments for r in got] == [r.segments for r in host]
    assert sum(len(r.segments) for r in got) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "raw16", "host_fsm"])
def test_slab_loop_makes_no_sync_after_its_first_dispatch(net, cuda_device, mode):
    """After its first slab is dispatched, the loop never waits on the
    compute stream (torch.cuda.set_sync_debug_mode("error") raises on any
    synchronising call) until the final fetch: no carry read-back, no
    pageable copy."""
    audio, lengths = _slab_batch(seed=6)
    q = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    dec = q.astype(np.float32) / 32768.0
    runner = SlabRunner(net, VADConfig(), slab_chunks=SLAB_CHUNKS, use_host_fsm=mode == "host_fsm")

    def run():
        if mode == "raw16":
            return runner.run_readers([lambda s, n, i=i: q[i, :, s : s + n] for i in range(3)], lengths, raw16=True)
        return runner.run(dec, lengths)

    want = run()  # builds and caches what a run needs once
    dispatch, fetch = runner._dispatch, runner._fetch

    def strict_dispatch(*args):
        out = dispatch(*args)
        torch.cuda.set_sync_debug_mode("error")
        return out

    def relaxed_fetch(slab_outs):
        torch.cuda.set_sync_debug_mode("default")
        return fetch(slab_outs)

    runner._dispatch, runner._fetch = strict_dispatch, relaxed_fetch
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [r.segments for r in got] == [r.segments for r in want]
    assert sum(len(r.segments) for r in got) > 0


@pytest.mark.cuda
def test_fsm_still_checks_an_outside_carry(cuda_device):
    """A carry from outside (here the host decoder's) continues the machines
    on the card bit for bit, and its ring indices are read back and checked:
    a bad one raises, and the read-back synchronises (the slab loop's
    chained calls skip it for their own carry)."""
    shape, params, (mv, vr, valid) = _fsm_case(FSM_CONFIGS["default"], 5, 600, seed=9)
    whole, whole_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
    _, host_carry = fsm_host.scan_windows_host(shape, params, mv[:, :250], vr[:, :250], valid[:, :250])
    outside = {k: torch.from_numpy(v).to(cuda_device) for k, v in host_carry.items()}
    rest = [torch.from_numpy(np.ascontiguousarray(x[:, 250:])).to(cuda_device) for x in (mv, vr, valid)]
    wb = torch.full((5,), 250, dtype=torch.int32, device=cuda_device)
    got, got_carry = fsm_cuda.scan_windows(shape, params, *rest, carry=outside, win_base=wb)
    torch.cuda.synchronize()
    _assert_fsm_equal(
        [torch.cat([torch.from_numpy(np.asarray(w)[:, :250]).to(a.device), a], dim=1) for w, a in zip(whole, got)],
        got_carry, whole, whole_carry, "outside carry",
    )
    bad = dict(outside, ireg=outside["ireg"].clone())
    bad["ireg"][2, fsm.I_RATIO_IDX] = shape.ratio_window
    with pytest.raises(ValueError, match="ring index"):
        fsm_cuda.scan_windows(shape, params, *rest, carry=bad, win_base=wb)
    with pytest.raises(ValueError, match="shape"):
        fsm_cuda._scan_chained(shape, params, *rest, dict(outside, kahan=outside["kahan"][:, :3]), wb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fsm_cuda._scan_chained(shape, params, *rest, got_carry, wb)
        with pytest.raises(RuntimeError):
            fsm_cuda.scan_windows(shape, params, *rest, carry=outside, win_base=wb)
    finally:
        torch.cuda.set_sync_debug_mode("default")


STREAM_COUNTERS = {"gru_stack": nsnet2_cuda.gru_stack, "scan_windows": fsm_cuda.scan_windows,
                   "gru_gates": gates.gru_gates, "gru_gates_p": gates.gru_gates_p, "gru_gates_f": gates.gru_gates_f,
                   "matmul_q8": mq.matmul_q8, "gru_gates_3x": gates.gru_gates_3x,
                   "gru_stack_mixed": nsnet2_cuda.gru_stack_mixed}


def _stream_batch(seed=8, seconds=20.0):
    rng = np.random.default_rng(seed)
    audio = np.stack([synth_stream(rng, seconds)[0] for _ in range(3)])
    return audio, [audio.shape[-1], audio.shape[-1] - 50_000, audio.shape[-1] - 150_000]


@pytest.mark.cuda
def test_streaming_runner_makes_no_sync_in_its_chunk_loop(net, cuda_device, monkeypatch):
    """One gru_stack and one scan_windows launch a chunk step and nothing
    else; no chunk step synchronises (torch.cuda.set_sync_debug_mode
    ("error") raises on any synchronising call); the segments equal the
    card's offline run and the CPU's streaming run."""
    audio, lengths = _stream_batch()
    runner = BatchRunner(net, use_offline=False)
    runner.run(audio, lengths)  # builds and caches what a run needs once
    step = vad.chunk_step

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(vad, "chunk_step", strict)
    before = {name: fn.launches for name, fn in STREAM_COUNTERS.items()}
    got = runner.run(audio, lengths)
    launched = {name: fn.launches - before[name] for name, fn in STREAM_COUNTERS.items()}
    n_chunks = audio.shape[-1] // 24000
    assert launched == dict(dict.fromkeys(STREAM_COUNTERS, 0), gru_stack=n_chunks, scan_windows=n_chunks)
    assert sum(len(r.segments) for r in got) > 0
    assert [r.segments for r in got] == [r.segments for r in BatchRunner(net).run(audio, lengths)]
    cpu = BatchRunner(registry.load_denoiser("demo", device="cpu"), use_offline=False).run(audio, lengths)
    assert [r.segments for r in got] == [r.segments for r in cpu]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 42])
@pytest.mark.parametrize("weights", ["demo", "biased"])
def test_gru_kernel_at_the_streaming_rows(net, cuda_device, rows, weights):
    """Kernel 1 at a chunk step's rows: one stereo stream (2) and the
    slice's 21 streams (42), 54 steps."""
    w = net if weights == "demo" else _biased(net)
    gi1 = _gi1(rows, 54, rows, cuda_device)
    got = nsnet2_cuda.gru_stack(w, gi1)
    want = nsnet2_cuda.gru_stack_reference(w, gi1)
    assert float((got - want).abs().max()) <= GRU_TOL


def _chunk_fsm_inputs(outs):
    """The FSM's per-chunk inputs and outputs of a streaming run, numpy [B, K, W]."""
    mv, rt, va = (x.cpu().numpy() for x in (outs.min_vol, outs.ratios, outs.window_valid))
    return mv, rt, va, outs.win_indices[..., 0].cpu().numpy(), fsm.WindowOutput(*(x.cpu().numpy() for x in outs.windows))


@pytest.mark.cuda
def test_chained_chunk_fsm_equals_host_decoder(net, cuda_device):
    """The kernel's per-chunk calls, each continuing the last one's carry,
    against the host decoder: chained over the same chunks, all seven
    outputs and the final carry bit for bit; and in one call over each
    row's valid windows joined (the slot left empty by a 23-window chunk
    and padding chunks lie between them), the same outputs at every valid
    slot and the same final carry, with every invalid slot inert."""
    audio, lengths = _stream_batch(seed=9)
    st = vad.statics_from_config(VADConfig())
    n_chunks = audio.shape[-1] // 24000
    cv = np.arange(n_chunks)[None, :] < np.array([n // 24000 for n in lengths])[:, None]
    cv[0, 3] = False  # a padding chunk between valid ones
    with torch.inference_mode():
        carry, outs = vad.process_stream(net, st, torch.from_numpy(audio).to(cuda_device), chunk_valids=cv)
    mv, rt, va, wb, got = _chunk_fsm_inputs(outs)
    final = {k: v.cpu().numpy() for k, v in carry["fsm"].items()}
    assert (va.sum(axis=2) == 23).any() and not va[0, 3].any()
    host_carry = None
    for k in range(n_chunks):
        want, host_carry = fsm_host.scan_windows_host(st.fsm_shape, st.fsm_params, mv[:, k], rt[:, k], va[:, k],
                                                      host_carry, wb[:, k])
        for field, a, w in zip(got._fields, got, want):
            assert np.ascontiguousarray(a[:, k]).tobytes() == w.tobytes(), (k, field)
    for key in final:
        assert final[key].tobytes() == host_carry[key].tobytes(), key
    b = mv.shape[0]
    flat = [x.reshape(b, -1) for x in (mv, rt, va)]
    n = flat[2].sum(axis=1)
    joined = [np.zeros((b, n.max()), x.dtype) for x in flat[:2]]
    for i in range(b):
        for j in range(2):
            joined[j][i, : n[i]] = flat[j][i, flat[2][i]]
    want, one_carry = fsm_host.scan_windows_host(st.fsm_shape, st.fsm_params, *joined, np.arange(n.max()) < n[:, None])
    for i in range(b):
        for field, a, w in zip(got._fields, got, want):
            a = a.reshape(b, -1)[i]
            assert a[flat[2][i]].tobytes() == w[i, : n[i]].tobytes(), (i, field)
            if field in ("event", "event_win", "seg_valid"):
                assert not a[~flat[2][i]].any(), (i, field)
    for key in final:
        assert final[key].tobytes() == one_carry[key].tobytes(), key
    assert (want.event == fsm.EV_COMPLETED).any()


# ROADMAP §3 fault 3, step 3: tests/test_torch_gru_gates.py's random gi
# (N(0, 0.8), numpy seed 100, 8 rows x 54 steps) and its pre-flip bar.
PRE_FLIP_ROWS, PRE_FLIP_STEPS, PRE_FLIP_MEAN = 8, 16, 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [4, 5, 6])
def test_bf16_kernels_agree_before_the_first_rounding_flip(cuda_device, kind):
    """Each bf16 body against its plain version on random gi: over each
    row's steps before its first bf16 rounding flip of h2, mean |dh2| <=
    1e-5, with at least PRE_FLIP_STEPS such row-steps (a version that
    dropped a rounding point flips every row at once)."""
    name = {4: "gru_gates", 5: "gru_gates_p", 6: "gru_gates_f"}[kind]
    net = registry.load_denoiser("random", device=cuda_device)
    rng = np.random.default_rng(100)
    gi = [torch.from_numpy((rng.standard_normal((PRE_FLIP_ROWS, 54, 400)) * 0.8).astype(np.float32)).to(cuda_device)
          for _ in range(3)]
    args = gi if kind == 5 else [g.to(torch.bfloat16) for g in gi]
    kw = {"out_dtype": torch.float32} if kind == 6 else {}
    got = getattr(gates, name)(net, *args, dtype=torch.bfloat16, **kw).float()
    want = getattr(gates, f"{name}_reference")(gates.gate_weights(net, torch.bfloat16), *args, **kw).float()
    flip = (got.to(torch.bfloat16) != want.to(torch.bfloat16)).any(dim=2)
    first = torch.where(flip.any(dim=1), flip.int().argmax(dim=1), 54)
    before = torch.arange(54, device=cuda_device)[None, :] < first[:, None]
    assert int(before.sum()) >= PRE_FLIP_STEPS, first.tolist()
    assert float((got - want).abs()[before].mean()) <= PRE_FLIP_MEAN


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["demo", "biased"])
@pytest.mark.parametrize("rows", [2, 42])
@pytest.mark.parametrize("kind", [5, 6])
def test_bf16_kernels_at_the_streaming_rows(net, cuda_device, kind, rows, weights):
    """Kernel 5 (the bf16 tier) and kernel 6 (bf16 out, the bf16_io tier) at
    a chunk step's rows, one stereo stream (2) and the slice's 21 streams
    (42), on the gi their tiers hand them, against their plain versions:
    one launch, max |dh2| <= BF16_MAX, and the pre-flip bar (mean |dh2| <=
    PRE_FLIP_MEAN over each row's steps before its first bf16 rounding flip
    of h2). At 42 rows also the whole-call mean bar (BF16_MEAN). At 2 rows
    one row's flips carry the whole-call mean, which the 1,680-row bar does
    not bound (ROADMAP §3 fault 3)."""
    net = _biased(net) if weights == "biased" else net
    feats = torch.from_numpy(np.random.default_rng(rows).normal(-3.0, 1.5, (rows, 54, 161)).astype(np.float32))
    bf16 = torch.bfloat16
    precision.set_io_dtype("bf16" if kind == 6 else "f32")
    try:
        with torch.inference_mode():
            gi = gates.gi_gates(net, net.fc_in(precision.io_cast(feats.to(cuda_device))))
    finally:
        precision.set_io_dtype("f32")
    wrapper, plain = (gates.gru_gates_p, gates.gru_gates_p_reference) if kind == 5 else \
        (gates.gru_gates_f, gates.gru_gates_f_reference)
    gi = tuple(g.contiguous() if kind == 5 else g.to(bf16) for g in gi)
    kw = {} if kind == 5 else {"out_dtype": bf16}
    before = wrapper.launches
    with torch.inference_mode():
        got = wrapper(net, *gi, dtype=bf16, **kw).float()
        want = plain(gates.gate_weights(net, bf16), *gi, **kw).float()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    d = (got - want).abs()
    assert float(d.max()) <= BF16_MAX, float(d.max())
    flip = (got.to(bf16) != want.to(bf16)).any(dim=2)
    first = torch.where(flip.any(dim=1), flip.int().argmax(dim=1), 54)
    pre = torch.arange(54, device=cuda_device)[None, :] < first[:, None]
    assert bool(pre.any()), first.tolist()
    assert float(d[pre].mean()) <= PRE_FLIP_MEAN, (first.tolist(), float(d[pre].mean()))
    if rows > 2:
        assert float(d.mean()) <= BF16_MEAN, float(d.mean())


def _serve_chunks(n_streams, seconds, seed):
    """[ticks, B, 2, 24000] float32 chunks of ``synth_stream`` streams."""
    rng = np.random.default_rng(seed)
    audio = np.stack([synth_stream(rng, seconds)[0] for _ in range(n_streams)])
    n = audio.shape[-1] // 24000
    return np.ascontiguousarray(audio[..., : n * 24000].reshape(n_streams, 2, n, 24000).transpose(2, 0, 1, 3))


def _serve(server, chunks, valid=None):
    """Push ``chunks`` tick by tick; -> each tick's host outputs (copies)."""
    ticks, run = [], server._run_step

    def step(c, v):
        out = run(c, v)
        ticks.append({k: x.copy() for k, x in out.items()})
        return out

    server._run_step = step
    for k in range(len(chunks)):
        server.push(chunks[k], None if valid is None else valid[k])
    return ticks


@pytest.mark.cuda
@pytest.mark.parametrize("microbatch", [1, 2])
def test_server_ticks_on_the_card_move_data_like_the_cpu(net, cuda_device, microbatch):
    """4 streams, 8 ticks, streams idle now and then, on the card and on the
    CPU port: the card's fetched window validity and indices equal the
    CPU's bit for bit and its window volumes and ratios are within 1e-4;
    the plain FSM chained over the card's fetched window inputs gives the
    card's fetched FSM outputs at every tick and its final carry bit for
    bit (what the kernel computed reached each stream's row)."""
    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.parallel.online import OnlineBatchServer

    chunks = _serve_chunks(4, 4.0, seed=3)
    valid = np.ones(chunks.shape[:2], bool)
    valid[2, 1] = valid[5, 3] = valid[6, 0] = False
    cpu_net = registry.load_denoiser("demo", device="cpu")
    card = OnlineBatchServer(PipelineConfig(), 4, params=net, microbatch=microbatch)
    cpu = OnlineBatchServer(PipelineConfig(), 4, params=cpu_net, device="cpu")
    got, want = _serve(card, chunks, valid), _serve(cpu, chunks, valid)
    st = card.st
    carry = None
    for k, (g, w) in enumerate(zip(got, want)):
        for f in ("window_valid", "win_indices"):
            assert g[f].tobytes() == w[f].tobytes(), (k, f)
        for f in ("min_vol", "ratios"):
            np.testing.assert_allclose(g[f], w[f], rtol=1e-4, atol=1e-6, err_msg=f"tick {k} {f}")
        args = [torch.from_numpy(g[f]) for f in ("min_vol", "ratios", "window_valid")]
        out, carry = fsm_cuda.scan_windows_reference(st.fsm_shape, st.fsm_params, *args, carry,
                                                     torch.from_numpy(g["win_indices"][:, 0].copy()))
        for f, x in zip(fsm.WindowOutput._fields, out):
            assert g[f].tobytes() == x.numpy().tobytes(), (k, f)
    final = card._full_carries()["fsm"]
    for key, x in carry.items():
        assert final[key].tobytes() == x.numpy().tobytes(), key


@pytest.mark.cuda
def test_server_shards_dispatch_with_no_sync(net, cuda_device):
    """At microbatch=2, after two ticks, a push dispatches every shard
    (upload, step, fetch) without synchronising
    (torch.cuda.set_sync_debug_mode("error") raises on any synchronising
    call, a pageable upload included) until it waits on the first shard's
    event; a ragged valid mask and int16 pushes included. The outputs equal
    those of the same fleet pushed the dequantized float32 chunks."""
    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.parallel.online import OnlineBatchServer

    chunks = _serve_chunks(4, 4.0, seed=7)
    valid = np.ones(chunks.shape[:2], bool)
    valid[2, 1] = False
    pcm = np.clip(np.round(chunks * 32768.0), -32768, 32767).astype(np.int16)
    dec = pcm.astype(np.float32) / np.float32(32768.0)
    server = OnlineBatchServer(PipelineConfig(), 4, params=net, microbatch=2)
    floats = OnlineBatchServer(PipelineConfig(), 4, params=net, microbatch=2)
    got, want = _serve(server, chunks[:0]), _serve(floats, chunks[:0])  # each tick's outputs from here
    finish = server._finish_fetch

    def relaxed(*args):
        torch.cuda.set_sync_debug_mode("default")
        return finish(*args)

    server._finish_fetch = relaxed
    for k in range(len(chunks)):
        if k >= 2:  # ticks 0 and 1 start the FSM and stage the first float32 and int16 batches
            torch.cuda.set_sync_debug_mode("error")
        try:
            server.push((pcm if k % 2 else chunks)[k], valid[k])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        floats.push((dec if k % 2 else chunks)[k], valid[k])
    assert len(got) == len(want) == len(chunks)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for f in g:
            assert g[f].tobytes() == w[f].tobytes(), (k, f)
    assert server.segments == floats.segments


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
def test_mesh_batch_runner_on_the_card(net, cuda_device, k):
    """The slice's runner over k shards of the card (3 streams padded to
    4 and 3): one GRU-kernel and one FSM launch a shard, segments equal
    the unsharded run's, offline and streaming."""
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib

    audio, lengths = _slab_batch(n_slabs=1, seed=8)
    mesh = mesh_lib.data_mesh([cuda_device] * k)
    assert mesh.devices == (torch.device("cuda", torch.cuda.current_device()),) * k
    for offline in (True, False):
        want = BatchRunner(net, VADConfig(), use_offline=offline).run(audio, lengths)
        before = (nsnet2_cuda.gru_stack.launches, fsm_cuda.scan_windows.launches)
        got = BatchRunner(net, VADConfig(), mesh=mesh, use_offline=offline).run(audio, lengths)
        steps = 1 if offline else audio.shape[-1] // 24000
        assert (nsnet2_cuda.gru_stack.launches - before[0], fsm_cuda.scan_windows.launches - before[1]) == (k * steps,) * 2
        assert [r.segments for r in got] == [r.segments for r in want]
    assert sum(len(r.segments) for r in got) > 0


@pytest.mark.cuda
def test_mesh_slab_loop_makes_no_sync_after_its_first_dispatch(net, cuda_device):
    """The slab loop over 2 shards of the card, each with its own staging
    and carries: no synchronising call between the first dispatch and the
    fetches, one fetch a shard after every dispatch, segments equal the
    unsharded run's."""
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib

    audio, lengths = _slab_batch(seed=6)
    want = SlabRunner(net, VADConfig(), slab_chunks=SLAB_CHUNKS).run(audio, lengths)
    runner = SlabRunner(net, VADConfig(), slab_chunks=SLAB_CHUNKS, mesh=mesh_lib.data_mesh([cuda_device] * 2))
    runner.run(audio, lengths)  # builds and caches what a run needs once
    dispatch, fetch = runner._dispatch, runner._fetch
    dispatched, fetched_after = [0], []

    def strict_dispatch(*args):
        out = dispatch(*args)
        dispatched[0] += 1
        torch.cuda.set_sync_debug_mode("error")
        return out

    def relaxed_fetch(slab_outs):
        torch.cuda.set_sync_debug_mode("default")
        fetched_after.append(dispatched[0])
        return fetch(slab_outs)

    runner._dispatch, runner._fetch = strict_dispatch, relaxed_fetch
    try:
        got = runner.run(audio, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fetched_after == [dispatched[0]] * 2 and dispatched[0] == 2 * 3
    assert [r.segments for r in got] == [r.segments for r in want]
    assert sum(len(r.segments) for r in got) > 0


@pytest.mark.cuda
def test_mesh_server_dispatches_with_no_sync(net, cuda_device):
    """A fleet of 8 over 2 shards x microbatch 2 of the card: after two
    ticks a push dispatches every device shard without synchronising
    until it waits on the first shard's event, a ragged mask included; its
    segments, decisions and indices equal the unsharded fleet's and its
    floats are within 1e-5 (ROADMAP §3 fault 7)."""
    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib
    from formula_vad_tpu_torch.parallel.online import OnlineBatchServer

    chunks = _serve_chunks(8, 4.0, seed=9)
    valid = np.ones(chunks.shape[:2], bool)
    valid[3, 5] = False
    server = OnlineBatchServer(PipelineConfig(), 8, params=net, mesh=mesh_lib.data_mesh([cuda_device] * 2), microbatch=2)
    plain = OnlineBatchServer(PipelineConfig(), 8, params=net)
    got, want = _serve(server, chunks[:0]), _serve(plain, chunks[:0])
    finish = server._finish_fetch

    def relaxed(*args):
        torch.cuda.set_sync_debug_mode("default")
        return finish(*args)

    server._finish_fetch = relaxed
    before = (nsnet2_cuda.gru_stack.launches, fsm_cuda.scan_windows.launches)
    for k in range(len(chunks)):
        if k >= 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            server.push(chunks[k], valid[k])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    after = (nsnet2_cuda.gru_stack.launches, fsm_cuda.scan_windows.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (4 * len(chunks),) * 2
    for k in range(len(chunks)):
        plain.push(chunks[k], valid[k])
    for g, w in zip(got, want):
        for f, a in g.items():
            if a.dtype.kind == "f":
                assert np.abs(a.astype(np.float64) - w[f]).max(initial=0.0) <= 1e-5, f
            else:
                assert a.tobytes() == w[f].tobytes(), f
    assert server.segments == plain.segments


@pytest.mark.cuda
def test_reset_row_on_the_card_is_a_fresh_stream(net, cuda_device):
    """reset_stream on the card: the row's carry becomes a fresh stream's
    (its FSM part with seeded Kahan slots, under the default machine's
    initial long-term average), every other row is untouched, nothing is
    read back; and the slot then serves a new stream as a fresh server does."""
    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.parallel.online import OnlineBatchServer
    from formula_vad_tpu_torch.parallel.online import _to_host

    chunks = _serve_chunks(2, 19.0, seed=4)
    new = _serve_chunks(1, 16.0, seed=5)
    server = OnlineBatchServer(PipelineConfig(), 2, params=net)
    assert server.st.fsm_shape.has_initial_avg
    _serve(server, chunks[:5])
    before = _to_host(server._carries[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        server.reset_stream(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = _to_host(server._carries[0])
    fresh = _to_host(vad.init_carry(server.st, (1,)))
    fresh["fsm"] = _to_host(fsm_cuda.seeded_fresh_carry(server.st.fsm_shape, server.st.fsm_params, 1, "cpu"))

    def rows(a, b, f, path=""):
        if isinstance(a, dict):
            for k in a:
                rows(a[k], b[k], f, f"{path}/{k}")
        else:
            f(a, b, path)

    rows(after, before, lambda a, b, p: np.testing.assert_array_equal(a[0], b[0], err_msg=p))
    rows(after, fresh, lambda a, b, p: np.testing.assert_array_equal(a[1], b[0], err_msg=p))
    both = np.concatenate([chunks[5:37, :1], new], axis=1)
    _serve(server, both)
    alone = OnlineBatchServer(PipelineConfig(), 1, params=net)
    _serve(alone, new)
    assert server.segments[1] == alone.segments[0] and alone.segments[0]


@pytest.mark.cuda
def test_checkpoint_from_the_card_continues_on_the_cpu(net, cuda_device, tmp_path):
    """A fleet checkpoint written on the card loads into a CPU server bit
    for bit (the carries, FSM included) and both continue to the same
    segments."""
    from formula_vad_tpu_torch.config import PipelineConfig
    from formula_vad_tpu_torch.parallel.online import OnlineBatchServer

    chunks = _serve_chunks(2, 20.0, seed=6)
    card = OnlineBatchServer(PipelineConfig(), 2, params=net)
    _serve(card, chunks[:19])
    card.save_state(str(tmp_path / "ckpt"))
    cpu = OnlineBatchServer(PipelineConfig(), 2, params=registry.load_denoiser("demo", device="cpu"), device="cpu")
    cpu.load_state(str(tmp_path / "ckpt"))
    want, got = card._full_carries(), cpu._full_carries()

    def same(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path

    same(got, want)
    assert [p._read_count for p in cpu.pipelines] == [p._read_count for p in card.pipelines]
    done = [len(x) for x in card.segments]  # a checkpoint carries no finished segment
    _serve(card, chunks[19:])
    _serve(cpu, chunks[19:])
    assert cpu.segments == [x[n:] for x, n in zip(card.segments, done)] and any(cpu.segments)


def _state(rows, seed, device):
    """A nonzero GRU state (h1, h2), |h| < 1, [rows, 400] float32 each."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (rows, 400))).astype(np.float32)).to(device)
                 for _ in range(2))


STATE_SHAPES = [(42, 1), (42, 54), (8192, 1)]  # a low-latency hop of 21 streams, a chunk's steps, 4,096 streams


@pytest.mark.cuda
@pytest.mark.parametrize("rows,steps", STATE_SHAPES)
def test_gru_kernel_carries_a_state(net, cuda_device, rows, steps):
    """Kernel 1 continuing a nonzero state against its plain version, the
    sequence and the final state within 1e-5; from a zero state it is the
    stateless call bit for bit; split at step 27 and chained, one call bit
    for bit."""
    gi1 = _gi1(rows, steps, rows + steps, cuda_device)
    state = _state(rows, steps, cuda_device)
    before = nsnet2_cuda.gru_stack.launches
    with torch.inference_mode():
        got, (h1, h2) = nsnet2_cuda.gru_stack(net, gi1, state)
        want, (w1, w2) = nsnet2_cuda.gru_stack_reference(net, gi1, state)
        stateless = nsnet2_cuda.gru_stack(net, gi1)
        zero, _ = nsnet2_cuda.gru_stack(net, gi1, tuple(torch.zeros_like(h) for h in state))
        torch.cuda.synchronize()
        assert nsnet2_cuda.gru_stack.launches == before + 3
        for a, b in ((got, want), (h1, w1), (h2, w2)):
            assert float((a - b).abs().max()) <= 1e-5
        assert torch.equal(h2, got[:, -1]) and torch.equal(zero, stateless)
        if steps > 27:
            first, mid = nsnet2_cuda.gru_stack(net, gi1[:, :27].contiguous(), state)
            second, (g1, g2) = nsnet2_cuda.gru_stack(net, gi1[:, 27:].contiguous(), mid)
            assert torch.equal(torch.cat([first, second], 1), got) and torch.equal(g1, h1) and torch.equal(g2, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [5, 6])
@pytest.mark.parametrize("rows,steps", STATE_SHAPES)
def test_bf16_kernels_carry_a_state(net, cuda_device, kind, rows, steps):
    """Kernel 5 (the bf16 tier) and kernel 6 (bf16 out, the bf16_io tier)
    continuing a nonzero state, on the gi their tiers hand them, against
    their plain versions: max |dh2| <= BF16_MAX, the pre-flip bar and, above
    2 rows, the whole-call mean bar, for the sequence and the final float32
    state; as many launches as the plan holds (4 at 8,192 rows, each on its
    rows' state); from a zero state the stateless call bit for bit; split
    at step 27 and chained, one call bit for bit."""
    feats = torch.from_numpy(np.random.default_rng(rows).normal(-3.0, 1.5, (rows, steps, 161)).astype(np.float32))
    bf16 = torch.bfloat16
    precision.set_io_dtype("bf16" if kind == 6 else "f32")
    try:
        with torch.inference_mode():
            gi = gates.gi_gates(net, net.fc_in(precision.io_cast(feats.to(cuda_device))))
    finally:
        precision.set_io_dtype("f32")
    wrapper, plain = (gates.gru_gates_p, gates.gru_gates_p_reference) if kind == 5 else \
        (gates.gru_gates_f, gates.gru_gates_f_reference)
    gi = tuple(g.contiguous() if kind == 5 else g.to(bf16) for g in gi)
    kw = {} if kind == 5 else {"out_dtype": bf16}
    state = _state(rows, steps + kind, cuda_device)
    before = wrapper.launches
    with torch.inference_mode():
        got, (h1, h2) = wrapper(net, *gi, dtype=bf16, state=state, **kw)
        want, (w1, w2) = plain(gates.gate_weights(net, bf16), *gi, state=state, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + len(gates.device_p_plan(rows, cuda_device))
        assert h1.dtype == h2.dtype == torch.float32 and torch.equal(h2.to(got.dtype), got[:, -1])
        d = (got.float() - want.float()).abs()
        assert float(d.max()) <= BF16_MAX, float(d.max())
        flip = (got.to(bf16) != want.to(bf16)).any(dim=2)
        first = torch.where(flip.any(dim=1), flip.int().argmax(dim=1), steps)
        pre = torch.arange(steps, device=cuda_device)[None, :] < first[:, None]
        assert bool(pre.any()) and float(d[pre].mean()) <= PRE_FLIP_MEAN, float(d[pre].mean())
        for a, b in ((h1, w1), (h2, w2)):
            e = (a - b).abs()
            assert float(e.max()) <= BF16_MAX and float(e.mean()) <= BF16_MEAN, (float(e.max()), float(e.mean()))
        if rows > 2:
            assert float(d.mean()) <= BF16_MEAN, float(d.mean())
        stateless = wrapper(net, *gi, dtype=bf16, **kw)
        zero, _ = wrapper(net, *gi, dtype=bf16, state=tuple(torch.zeros_like(h) for h in state), **kw)
        assert torch.equal(zero, stateless)
        if steps > 27:
            first_half, mid = wrapper(net, *(g[:, :27].contiguous() for g in gi), dtype=bf16, state=state, **kw)
            second_half, (g1, g2) = wrapper(net, *(g[:, 27:].contiguous() for g in gi), dtype=bf16, state=mid, **kw)
            assert torch.equal(torch.cat([first_half, second_half], 1), got)
            assert torch.equal(g1, h1) and torch.equal(g2, h2)


LOWLATENCY_TIERS = {  # tier: (matmul level, io dtype, quant, the recurrence's wrapper, its launches a step)
    "float": ("highest", "f32", "off", "gru_stack", 1),
    "high": ("high", "f32", "off", "gru_gates_3x", 1),
    "bf16": ("default", "f32", "off", "gru_gates_p", 1),
    "bf16_io": ("default", "bf16", "off", "gru_gates_f", 1),
    "int8": ("highest", "f32", "int8", "matmul_q8", 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(LOWLATENCY_TIERS))
def test_lowlatency_on_the_card(net, cuda_device, tier):
    """The low-latency mode at 4 streams x 2 channels x 40 hops: a chain of
    ``step`` calls launches the tier's recurrence once a hop and nothing
    else (int8: its 8 products), ``run`` once for all hops (int8: 3 a hop
    and 5); in the float32 recurrences (float, high) the chain equals the
    run within 1e-5, and the float tier's run the CPU's."""
    from formula_vad_tpu_torch.pipeline import lowlatency

    level, io, quant, name, per_step = LOWLATENCY_TIERS[tier]
    audio = (0.05 * np.random.default_rng(9).standard_normal((4, 2, 40 * 480))).astype(np.float32)
    x = torch.from_numpy(audio).to(cuda_device)
    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)
    precision.set_quant(quant)
    try:
        with torch.inference_mode():
            lowlatency.run(net, x[..., :480])  # builds the kernels, packs the weights
            torch.cuda.synchronize()
            before = {k: fn.launches for k, fn in STREAM_COUNTERS.items()}
            state = lowlatency.init_state((4, 2), cuda_device)
            outs = []
            for i in range(40):
                state, o = lowlatency.step(net, state, x[..., i * 480 : (i + 1) * 480])
                outs.append(o)
            chain = torch.cat(outs, -1)
            mid = {k: fn.launches for k, fn in STREAM_COUNTERS.items()}
            final, whole = lowlatency.run(net, x)
            after = {k: fn.launches for k, fn in STREAM_COUNTERS.items()}
        torch.cuda.synchronize()
    finally:
        precision.set_matmul_precision("highest")
        precision.set_io_dtype("f32")
        precision.set_quant("off")
    assert {k: mid[k] - before[k] for k in before} == dict(dict.fromkeys(STREAM_COUNTERS, 0), **{name: 40 * per_step})
    run_launches = 3 * 40 + 5 if tier == "int8" else 1
    assert {k: after[k] - mid[k] for k in mid} == dict(dict.fromkeys(STREAM_COUNTERS, 0), **{name: run_launches})
    assert bool(torch.isfinite(chain).all()) and bool(torch.isfinite(whole).all())
    if tier in ("float", "high"):
        assert float((chain - whole).abs().max()) <= 1e-5
        for a, b in zip(state["gru"], final["gru"]):
            assert float((a - b).abs().max()) <= 1e-5
    if tier == "float":
        with torch.inference_mode():
            _, cpu = lowlatency.run(registry.load_denoiser("demo", device="cpu"), torch.from_numpy(audio))
        assert float((whole.cpu() - cpu).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(LOWLATENCY_TIERS))
def test_lowlatency_step_makes_no_sync(net, cuda_device, tier):
    """After a first step has built and cached what a step needs, a chain of
    ``step`` calls never waits on the card (torch.cuda.set_sync_debug_mode
    ("error") raises on any synchronising call: a read-back, a pageable
    copy), and gives the same outputs as the same chain without the mode."""
    from formula_vad_tpu_torch.pipeline import lowlatency

    level, io, quant, _, _ = LOWLATENCY_TIERS[tier]
    audio = (0.05 * np.random.default_rng(10).standard_normal((3, 2, 8 * 480))).astype(np.float32)
    x = torch.from_numpy(audio).to(cuda_device)
    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)
    precision.set_quant(quant)

    def chain():
        state, outs = lowlatency.init_state((3, 2), cuda_device), []
        for i in range(8):
            state, o = lowlatency.step(net, state, x[..., i * 480 : (i + 1) * 480])
            outs.append(o)
        return torch.cat(outs, -1)

    try:
        with torch.inference_mode():
            want = chain()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = chain()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        precision.set_matmul_precision("highest")
        precision.set_io_dtype("f32")
        precision.set_quant("off")
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_alt_machines_on_the_card(net, cuda_device):
    """K = 4 alternative machines (the base config among them) as rows of
    one FSM scan: one kernel-2 launch at [B * 5, W] offline, one a chunk
    step streaming, and on the slab path one a slab; every path's segments
    and alternative segments equal the CPU's offline run, and the base
    machine's alternative segments are the primary's bit for bit."""
    audio, lengths = _stream_batch(seconds=18.0)
    grid = [VADMachineConfig(speech_threshold_factor=f, channel_vol_ratio_threshold=r)
            for f in (6.0, 10.0) for r in (0.3, 0.5)]
    cfg = VADConfig(alt_vad_machine_configs=grid)
    want = BatchRunner(registry.load_denoiser("demo", device="cpu"), cfg).run(audio, lengths)
    n_chunks = audio.shape[-1] // 24000
    runs = (("offline", BatchRunner(net, cfg), 1), ("streaming", BatchRunner(net, cfg, use_offline=False), n_chunks),
            ("slab", SlabRunner(net, cfg, slab_chunks=32), 2))
    for what, runner, launches in runs:
        before = fsm_cuda.scan_windows.launches
        got = runner.run(audio, lengths)
        assert fsm_cuda.scan_windows.launches - before == launches, what
        assert [(r.segments, r.alt_segments) for r in got] == [(r.segments, r.alt_segments) for r in want], what
    assert fsm_cuda.scan_windows.last_plan.ctas == 3 * 5  # the smem body: one CTA a (stream, config) row
    assert all(r.alt_segments[3] == r.segments for r in want) and any(r.segments for r in want)
    assert len({str(s) for r in want for s in r.alt_segments}) > 3


@pytest.mark.cuda
def test_onnx_import_on_the_card(net, cuda_device, tmp_path):
    from formula_vad_tpu_torch.models.onnx_import import export_nsnet2_onnx

    path = tmp_path / "demo.onnx"
    path.write_bytes(export_nsnet2_onnx(net))
    imported = registry.load_denoiser(str(path), device=cuda_device)
    for a, b in zip(net.parameters(), imported.parameters()):
        assert a.device == b.device and torch.equal(a, b)
    x = torch.from_numpy(np.random.default_rng(5).normal(-3.0, 1.5, (42, 54, 161)).astype(np.float32)).to(cuda_device)
    with torch.inference_mode():
        assert torch.equal(imported(x, out_frames=50), net(x, out_frames=50))


@pytest.mark.cuda
def test_gate_on_the_card(cuda_device):
    gate = registry.load_denoiser("spectral_gate", device=cuda_device)
    gate_cpu = registry.load_denoiser("spectral_gate", device="cpu")
    feats = np.random.default_rng(0).normal(-5.0, 1.5, (6, 54, 161)).astype(np.float32)
    with torch.inference_mode():
        got = gate(torch.from_numpy(feats).to(cuda_device)).cpu()
        want = gate_cpu(torch.from_numpy(feats))
    assert float((got - want).abs().max()) <= 1e-6
    rng = np.random.default_rng(3)
    audio = np.stack([synth_stream(rng, 20.0)[0] for _ in range(2)])
    wrappers = (nsnet2_cuda.gru_stack, fsm_cuda.scan_windows, mq.matmul_q8, gates.gru_gates, gates.gru_gates_p,
                gates.gru_gates_f)
    for fn in wrappers:
        fn.launches = 0
    segments = [r.segments for r in BatchRunner(gate).run(audio)]
    assert [fn.launches for fn in wrappers] == [0, 1, 0, 0, 0, 0]
    assert segments == [r.segments for r in BatchRunner(gate_cpu, use_host_fsm=True).run(audio)]
    assert sum(map(len, segments)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(LOWLATENCY_TIERS))
def test_kernel_routes_refuse_grad(cuda_device, tier):
    """Autograd cannot see a kernel launched through ctypes: with gradients
    on, the model's forward on the card raises in every tier where a weight
    requires grad (else fc_in and both GRUs would get no gradient while the
    head trained), and each wrapper raises where an input does; under
    no_grad the same calls run. Training goes through
    ``train/nsnet2_train.apply``."""
    from formula_vad_tpu_torch.train import nsnet2_train

    level, io, quant, name, _ = LOWLATENCY_TIERS[tier]
    trained = nsnet2_train.trainable(registry.load_denoiser("demo", device=cuda_device))
    feats = torch.from_numpy(np.random.default_rng(0).normal(-3.0, 1.5, (4, 54, 161)).astype(np.float32))
    feats = feats.to(cuda_device)
    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)
    precision.set_quant(quant)
    try:
        before = STREAM_COUNTERS[name].launches
        with pytest.raises(RuntimeError, match="nsnet2_train.apply"):
            trained(feats)
        assert STREAM_COUNTERS[name].launches == before
        with torch.no_grad():
            assert torch.isfinite(trained(feats)).all()
        assert STREAM_COUNTERS[name].launches > before
    finally:
        precision.set_matmul_precision("highest")
        precision.set_io_dtype("f32")
        precision.set_quant("off")


@pytest.mark.cuda
def test_wrappers_refuse_grad_requiring_inputs(net, cuda_device):
    gi1 = _gi1(4, 6, 0, cuda_device).requires_grad_(True)
    gi = tuple(gi1[..., k * 400 : (k + 1) * 400].detach().contiguous().requires_grad_(True) for k in range(3))
    with pytest.raises(RuntimeError, match="^gru_stack: "):
        nsnet2_cuda.gru_stack(net, gi1)
    for wrapper in (gates.gru_gates, gates.gru_gates_p, gates.gru_gates_f):
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(RuntimeError, match=f"^{wrapper.__name__}: "):
                wrapper(net, *gi, dtype=dtype)
    w = mq.Q8Weight.pack(torch.ones((16, 8), dtype=torch.int8, device=cuda_device),
                         torch.ones(8, device=cuda_device))
    a8 = torch.ones((4, 16), dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError, match="^matmul_q8: "):
        mq.matmul_q8(a8, w, torch.ones(4, device=cuda_device, requires_grad=True), order="row_col")
    shape, params = fsm.statics_from_config(VADMachineConfig(), SR, FFT)
    mv, vr, valid = (torch.from_numpy(x).to(cuda_device) for x in fsm_inputs(2, 64, 0))
    with pytest.raises(RuntimeError, match="^scan_windows: "):
        fsm_cuda.scan_windows(shape, params, mv.requires_grad_(True), vr, valid)
    with torch.no_grad():
        nsnet2_cuda.gru_stack(net, gi1)
        fsm_cuda.scan_windows(shape, params, mv, vr, valid)


@pytest.mark.cuda
def test_training_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The differentiable forward on the card launches no kernel; its loss
    and gradients equal the CPU's within 1e-5 and 1e-4 of each array's
    largest element (float32 sums in other orders, TF32 off); the trainer
    CLI on the card resumes bit for bit and writes weights that score."""
    from formula_vad_tpu_torch.apps import train as train_app
    from formula_vad_tpu_torch.models import nsnet2
    from formula_vad_tpu_torch.train import nsnet2_train

    batch = nsnet2_train.synth_batch(torch.Generator().manual_seed(3), 4, 20)
    grads = {}
    for dev in ("cpu", cuda_device):
        net = nsnet2_train.trainable(registry.load_denoiser("random", device=dev))
        counts = [fn.launches for fn in STREAM_COUNTERS.values()]
        loss = nsnet2_train.spectral_loss(net, *(x.to(dev) for x in batch))
        loss.backward()
        assert [fn.launches for fn in STREAM_COUNTERS.values()] == counts
        grads[str(dev)] = (loss.item(), [p.grad.cpu() for p in net.parameters()])
    (want_loss, want), (got_loss, got) = grads["cpu"], grads[str(cuda_device)]
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0 and float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    base = ["--synthetic", "16", "--batch", "4", "--frames", "20", "--device-data"]
    straight, resumed, ck = str(tmp_path / "s.npz"), str(tmp_path / "r.npz"), str(tmp_path / "ck")
    assert train_app.main(base + ["--steps", "4", "--out", straight]) == 0
    assert train_app.main(base + ["--steps", "2", "--out", resumed, "--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    assert train_app.main(base + ["--steps", "4", "--out", resumed, "--ckpt-dir", ck]) == 0
    for p, q in zip(nsnet2.load_npz(straight).parameters(), nsnet2.load_npz(resumed).parameters()):
        assert torch.equal(p, q)
    trained = registry.load_denoiser(straight, device=cuda_device)
    with torch.inference_mode():
        assert torch.isfinite(trained(batch[0].to(cuda_device))).all()


@pytest.mark.cuda
def test_train_mesh_step_on_the_card_matches_the_cpu(cuda_device):
    """A step on a 2 x 2 training grid of the card (cuda:0 four times)
    against the same step on a 2 x 2 grid of the CPU: the loss within 1e-5,
    each gathered gradient within 1e-4 of that array's largest element
    (float32 sums in other orders, TF32 off); no kernel launches in the
    sharded step."""
    from formula_vad_tpu_torch.parallel import mesh as mesh_lib
    from formula_vad_tpu_torch.train import nsnet2_train

    batch = nsnet2_train.synth_batch(torch.Generator().manual_seed(4), 4, 20)
    got = {}
    for dev in ("cpu", cuda_device):
        grid = mesh_lib.data_model_mesh(2, [dev] * 4)
        sharded = nsnet2_train.shard_params(nsnet2_train.trainable(registry.load_denoiser("random", device="cpu")), grid)
        opt = torch.optim.Adam(sharded.parameters(), lr=1e-4)
        counts = [fn.launches for fn in STREAM_COUNTERS.values()]
        loss = nsnet2_train.make_train_step(opt, sharded, grid)(batch)
        assert [fn.launches for fn in STREAM_COUNTERS.values()] == counts
        got[str(dev)] = (loss.item(), {k: g.cpu() for k, g in sharded.gathered_grads().items()})
    (want_loss, want), (got_loss, grads) = got["cpu"], got[str(cuda_device)]
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    for name, w in want.items():
        assert float(w.abs().max()) > 0 and float((grads[name] - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


KERNEL_A_LEVELS = [("high", "high"), ("default", "high"), ("high", "default")]  # (gru_i, gru_h)
KERNEL_B_LEVELS = [("high", "highest"), ("default", "highest"), ("highest", "high"), ("highest", "default")]


# Kernel A's and kernel B's bars where no class is 'default', from their
# readings on the card (H100: A at all-'high' max 2.9e-6, B at a 'high' mix
# 1.2e-6): a 'high' and a 'highest' product differ by only ~2^-16, so the
# plain versions at other levels lie within 3e-6 to 6e-6 of each other
# and ``_nearer_than_other_levels`` tells them apart.
KERNEL_A_HIGH_TOL, KERNEL_B_HIGH_TOL = 5e-6, 2e-6


def _near(got, want, levels, bar):
    """Kernel A's and kernel B's bar against their plain versions: ``bar``;
    where a class is 'default', h is rounded to bf16 where it enters its
    products, and another float32 summation order now and then moves an h
    value across a bf16 rounding step, so kernel 5's bf16 bars hold there
    (max 6e-3, mean 3e-5)."""
    d = (got - want).abs()
    if "default" in levels:
        assert float(d.max()) <= BF16_MAX and float(d.mean()) <= BF16_MEAN, (float(d.max()), float(d.mean()))
    else:
        assert float(d.max()) <= bar, (float(d.max()), float(d.mean()))


def _nearer_than_other_levels(got, want, levels, plain_at):
    """The control: the kernel's output lies nearer (mean |d|) its plain
    version at its own levels than the plain versions at all-'highest' and
    at the two classes swapped, so a kernel that ignored its levels (kernel
    1's code) or swapped the classes fails."""
    own = float((got - want).abs().mean())
    for other in sorted({("highest", "highest"), levels[::-1]} - {levels}):
        assert own < float((got - plain_at(other)).abs().mean()), (levels, other, own)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", KERNEL_A_LEVELS)
@pytest.mark.parametrize("rows, steps", [(1, 1), (37, 54), (1680, 54), (4000, 54)])
def test_kernel_a_matches_plain(net, cuda_device, levels, rows, steps):
    """Kernel A (``gru_gates_3x``) against its plain version on the
    per-gate gi of the fc_in output and N(0, 0.3) GRU biases (``_near``);
    one count a launch of its 8-unit plan (one at any row count)."""
    net = _biased(net)
    gi = _gi3(net, rows, steps, rows * steps, cuda_device)
    before = gates.gru_gates_3x.launches
    with torch.inference_mode():
        got = gates.gru_gates_3x(net, *gi, levels=levels)
        want = gates.gru_gates_p_reference(gates.gate_weights(net, torch.float32), *gi, levels=levels)
    torch.cuda.synchronize()
    assert gates.gru_gates_3x.launches == before + len(gates.device_p_plan(rows, cuda_device, gates.P3_UNITS))
    assert got.dtype == torch.float32 and got.shape == (rows, steps, 400)
    _near(got, want, levels, KERNEL_A_HIGH_TOL)
    if steps > 1:
        with torch.inference_mode():
            _nearer_than_other_levels(got, want, levels, lambda other: gates.gru_gates_p_reference(
                gates.gate_weights(net, torch.float32), *gi, levels=other))


@pytest.mark.cuda
def test_kernel_a_on_random_gi(net, cuda_device):
    """Kernel A at three passes a class on N(0, 0.8) gi (numpy seed 100,
    8 rows x 54 steps) within 5e-6 of its plain version: bf16_3x carries h
    to ~16 bits, so the bf16 bodies' rounding cascade (ROADMAP fault 3)
    does not appear."""
    rng = np.random.default_rng(100)
    gi = tuple(torch.from_numpy((rng.standard_normal((8, 54, 400)) * 0.8).astype(np.float32)).to(cuda_device)
               for _ in range(3))
    with torch.inference_mode():
        got = gates.gru_gates_3x(net, *gi, levels=("high", "high"))
        want = gates.gru_gates_p_reference(gates.gate_weights(net, torch.float32), *gi, levels=("high", "high"))
    torch.cuda.synchronize()
    _near(got, want, ("high", "high"), KERNEL_A_HIGH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", KERNEL_A_LEVELS)
@pytest.mark.parametrize("rows", [297, 1825])
def test_kernel_a_partial_last_cluster(net, cuda_device, levels, rows):
    """Row counts whose last row group's clusters hold a partial tile and
    fewer or odd tiles: 297 rows (19 tiles: a group of 10 in 5 pairs, one
    of 9 single tiles, 9 rows in the last) and 1,825 (115 tiles: 58 and 57,
    the last pair one tile of one row), stateless and from a state. Against
    the plain version (``_near``), and bit for bit with the same rows in a
    call of their own, whose plan differs."""
    (plan,) = gates.device_p_plan(rows, cuda_device, gates.P3_UNITS)
    last = plan.tiles - (plan.row_groups - 1) * plan.tiles_per_group  # the last group's tiles
    assert (last <= gates.P3_WARPS or last % 2) and rows % 16
    net = _biased(net)
    gi = _gi3(net, rows, 54, rows, cuda_device)
    state = _state(rows, rows, cuda_device)
    tail = slice(rows - 20, rows)
    with torch.inference_mode():
        got = gates.gru_gates_3x(net, *gi, levels=levels)
        carried, (h1, h2) = gates.gru_gates_3x(net, *gi, levels=levels, state=state)
        want = gates.gru_gates_p_reference(gates.gate_weights(net, torch.float32), *gi, levels=levels)
        want_c, (w1, w2) = gates.gru_gates_p_reference(gates.gate_weights(net, torch.float32), *gi, state=state,
                                                       levels=levels)
        alone = gates.gru_gates_3x(net, *(g[tail].contiguous() for g in gi), levels=levels)
        alone_c, (a1, _) = gates.gru_gates_3x(net, *(g[tail].contiguous() for g in gi), levels=levels,
                                              state=tuple(h[tail].contiguous() for h in state))
    torch.cuda.synchronize()
    for a, b in ((got, want), (carried, want_c), (h1, w1), (h2, w2)):
        _near(a, b, levels, KERNEL_A_HIGH_TOL)
    assert torch.equal(alone, got[tail]) and torch.equal(alone_c, carried[tail]) and torch.equal(a1, h1[tail])


@pytest.mark.cuda
@pytest.mark.parametrize("levels", KERNEL_A_LEVELS)
def test_kernel_a_rows_are_independent(net, cuda_device, levels):
    """A repeated call and rows 0-16 of a 1,680-row call against a 17-row
    call bit for bit; the barrier counters left at 0."""
    gi = _gi3(_biased(net), 1680, 54, 8, cuda_device)
    with torch.inference_mode():
        whole = gates.gru_gates_3x(net, *gi, levels=levels)
        again = gates.gru_gates_3x(net, *gi, levels=levels)
        part = gates.gru_gates_3x(net, *(g[:17].contiguous() for g in gi), levels=levels)
    torch.cuda.synchronize()
    assert torch.equal(whole, again) and torch.equal(part, whole[:17])
    assert not bool(gates._p_barrier(whole.device, torch.cuda.current_stream(whole.device).cuda_stream).any())


@pytest.mark.cuda
@pytest.mark.parametrize("levels", KERNEL_A_LEVELS)
@pytest.mark.parametrize("rows,steps", [(42, 1), (42, 54)])
def test_kernel_a_carries_a_state(net, cuda_device, levels, rows, steps):
    """Kernel A continuing a nonzero state against its plain version, the
    sequence and the final state (``_near``); from a zero state the
    stateless call bit for bit; split at step 27 and chained, one call bit
    for bit."""
    net = _biased(net)
    gi = _gi3(net, rows, steps, rows + steps, cuda_device)
    state = _state(rows, steps, cuda_device)
    with torch.inference_mode():
        got, (h1, h2) = gates.gru_gates_3x(net, *gi, levels=levels, state=state)
        want, (w1, w2) = gates.gru_gates_p_reference(gates.gate_weights(net, torch.float32), *gi, state=state,
                                                     levels=levels)
        stateless = gates.gru_gates_3x(net, *gi, levels=levels)
        zero, _ = gates.gru_gates_3x(net, *gi, levels=levels, state=tuple(torch.zeros_like(h) for h in state))
        torch.cuda.synchronize()
        for a, b in ((got, want), (h1, w1), (h2, w2)):
            _near(a, b, levels, KERNEL_A_HIGH_TOL)
        assert torch.equal(h2, got[:, -1]) and torch.equal(zero, stateless)
        if steps > 27:
            first, mid = gates.gru_gates_3x(net, *(g[:, :27].contiguous() for g in gi), levels=levels, state=state)
            second, (g1, g2) = gates.gru_gates_3x(net, *(g[:, 27:].contiguous() for g in gi), levels=levels, state=mid)
            assert torch.equal(torch.cat([first, second], 1), got) and torch.equal(g1, h1) and torch.equal(g2, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", KERNEL_B_LEVELS)
@pytest.mark.parametrize("rows, steps", [(1, 1), (37, 54), (1680, 54), (42, 54), (4000, 54)])
def test_kernel_b_matches_plain(net, cuda_device, levels, rows, steps):
    """Kernel B (``gru_stack_mixed``, ``csrc/gru_mixed.cu``: kernel 1's
    tiles with the class at 'high' or 'default' on mma.sync) against
    ``gru_stack_reference`` at the same levels, on N(0, 0.8) gi1 and N(0,
    0.3) GRU biases (``_near``), one launch."""
    net = _biased(net)
    gi1 = _gi1(rows, steps, rows + steps, cuda_device)
    before = (nsnet2_cuda.gru_stack_mixed.launches, nsnet2_cuda.gru_stack.launches)
    with torch.inference_mode():
        got = nsnet2_cuda.gru_stack_mixed(net, gi1, levels)
        want = nsnet2_cuda.gru_stack_reference(net, gi1, levels=levels)
    torch.cuda.synchronize()
    assert (nsnet2_cuda.gru_stack_mixed.launches, nsnet2_cuda.gru_stack.launches) == (before[0] + 1, before[1])
    _near(got, want, levels, KERNEL_B_HIGH_TOL)
    if steps > 1:
        with torch.inference_mode():
            _nearer_than_other_levels(got, want, levels,
                                      lambda other: nsnet2_cuda.gru_stack_reference(net, gi1, levels=other))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", KERNEL_B_LEVELS)
def test_kernel_b_carries_a_state(net, cuda_device, levels):
    """Kernel B continuing a nonzero state at [42, 54] against its plain
    version (``_near``); from a zero state the stateless call bit for bit."""
    gi1 = _gi1(42, 54, 5, cuda_device)
    state = _state(42, 6, cuda_device)
    with torch.inference_mode():
        got, (h1, h2) = nsnet2_cuda.gru_stack_mixed(net, gi1, levels, state)
        want, (w1, w2) = nsnet2_cuda.gru_stack_reference(net, gi1, state, levels=levels)
        stateless = nsnet2_cuda.gru_stack_mixed(net, gi1, levels)
        zero, _ = nsnet2_cuda.gru_stack_mixed(net, gi1, levels, tuple(torch.zeros_like(h) for h in state))
    torch.cuda.synchronize()
    for a, b in ((got, want), (h1, w1), (h2, w2)):
        _near(a, b, levels, KERNEL_B_HIGH_TOL)
    assert torch.equal(zero, stateless)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", KERNEL_B_LEVELS)
def test_kernel_b_does_not_spill(cuda_device, levels):
    """Every kernel B instantiation, as built, keeps its registers: 0 bytes
    of local memory a thread (``cudaFuncGetAttributes``)."""
    built = nsnet2_cuda.mixed_attributes(levels, cuda_device)
    assert built["local_bytes"] == 0 and 0 < built["registers"] <= 255, built


@pytest.mark.cuda
def test_kernel_b_shared_bytes_match_the_source(cuda_device):
    """The host's ``MIXED_SMEM_BYTES`` (which the CPU plan test holds to a
    block's 232,448 bytes) is the source's shared bytes a CTA."""
    assert nsnet2_cuda._mixed_lib().fvad_gru_mixed_smem_bytes() == nsnet2_cuda.MIXED_SMEM_BYTES


@pytest.mark.cuda
def test_kernel_1_unchanged_by_kernel_b_split(cuda_device):
    """Kernel 1 kept its bits when kernel B moved out of its source: its
    outputs on ``chip_smoke.py``'s fixed inputs (``unchanged_outputs``:
    [1,680, 54] and [42, 54] from a state, the demo weights) hash to the
    parent tree's ``PARENT_DIGESTS`` under the nvcc release that recorded
    them."""
    import importlib.util
    import subprocess
    from pathlib import Path

    from formula_vad_tpu_torch import _build

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_digests", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    release = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
    if release != smoke.PARENT_DIGESTS_NVCC:
        pytest.skip(f"PARENT_DIGESTS bind nvcc '{smoke.PARENT_DIGESTS_NVCC}', this is '{release}'")
    got = smoke.unchanged_outputs("formula_vad_tpu_torch", cuda_device)
    assert got["gru_stack"] == smoke.PARENT_DIGESTS["gru_stack"], got


def _route(levels):
    """The wrapper that runs the recurrence at (gru_i, gru_h) levels, f32 storage."""
    if levels == ("highest", "highest"):
        return "gru_stack"
    if levels == ("default", "default"):
        return "gru_gates_p"
    return "gru_stack_mixed" if "highest" in levels else "gru_gates_3x"


@pytest.mark.cuda
@pytest.mark.parametrize("level_i", ["highest", "high", "default"])
@pytest.mark.parametrize("level_h", ["highest", "high", "default"])
def test_stage_levels_route_on_the_card(net, cuda_device, level_i, level_h):
    """Under gru_i and gru_h stage overrides the forward launches its
    route's kernel once and nothing else, with gains within the route
    kernel's bar of the CPU's (5e-6 on kernel A, 2e-6 on kernels 1 and B;
    2e-3 where a class is 'default': a bf16 rounding step of h)."""
    feats = torch.from_numpy(np.random.default_rng(2).normal(-3.0, 1.5, (6, 54, 161)).astype(np.float32))
    cpu_net = registry.load_denoiser("demo", device="cpu")
    precision.set_stage_overrides({"gru_i": level_i, "gru_h": level_h})
    try:
        with torch.inference_mode():
            before = {k: fn.launches for k, fn in COUNTERS.items()}
            got = net(feats.to(cuda_device))
            torch.cuda.synchronize()
            launched = {k: fn.launches - before[k] for k, fn in COUNTERS.items()}
            want = cpu_net(feats)
    finally:
        precision.set_stage_overrides(None)
    assert launched == dict(dict.fromkeys(COUNTERS, 0), **{_route((level_i, level_h)): 1})
    bar = 2e-3 if "default" in (level_i, level_h) else {"gru_gates_3x": KERNEL_A_HIGH_TOL}.get(
        _route((level_i, level_h)), KERNEL_B_HIGH_TOL)
    assert float((got.cpu() - want).abs().max()) <= bar, float((got.cpu() - want).abs().max())


@pytest.mark.cuda
def test_int8_with_bf16_storage_on_the_card(net, cuda_device):
    """The int8 tier under bf16 storage: 167 kernel-3 launches a run and no
    recurrence kernel, bf16 gains; the slice's segments against the CPU
    run's: the same count, every boundary within one FSM window."""
    rng = np.random.default_rng(3)
    audio = np.stack([synth_stream(rng, 20.0)[0] for _ in range(3)])
    precision.set_quant("int8")
    precision.set_io_dtype("bf16")
    try:
        before = {k: fn.launches for k, fn in COUNTERS.items()}
        gpu = BatchRunner(net, VADConfig()).run(audio)
        launched = {k: fn.launches - before[k] for k, fn in COUNTERS.items()}
        cpu = BatchRunner(registry.load_denoiser("demo", device="cpu"), VADConfig()).run(audio)
        with torch.inference_mode():
            gains = net(torch.zeros((2, 54, 161), device=cuda_device))
    finally:
        precision.set_quant("off")
        precision.set_io_dtype("f32")
    assert launched == dict(dict.fromkeys(COUNTERS, 0), matmul_q8=167, scan_windows=1)
    assert gains.dtype == torch.bfloat16
    assert sum(len(r.segments) for r in gpu) > 0
    for g, c in zip(gpu, cpu):
        assert len(g.segments) == len(c.segments)
        for a, b in zip(g.segments, c.segments):
            assert abs(a["sample_from"] - b["sample_from"]) <= FFT and abs(a["sample_to"] - b["sample_to"]) <= FFT


@pytest.mark.cuda
@pytest.mark.parametrize("tier", [("default", "f32"), ("highest", "bf16"), ("high", "f32")])
def test_lbr0_tiers_on_the_card(cuda_device, tier):
    """lbr = 0 weights, which no kernel takes, at 'default', under bf16
    storage and at 'high': the plain loop on the card launches no kernel
    of the recurrence, and its gains are the CPU's within the CPU tests'
    bars (max 2e-3 and mean 2e-5 at 'default'; 4e-3 and 2e-5 under bf16
    storage; 1e-4 at 'high')."""
    feats = torch.from_numpy(np.random.default_rng(4).normal(-3.0, 1.5, (4, 20, 161)).astype(np.float32))
    nets = [registry.load_denoiser("demo", device=d) for d in (cuda_device, "cpu")]
    for n in nets:
        n.gru2.linear_before_reset = 0
    _set_tier(*tier)
    try:
        with torch.inference_mode():
            before = {k: fn.launches for k, fn in COUNTERS.items()}
            got = nets[0](feats.to(cuda_device))
            torch.cuda.synchronize()
            launched = {k: fn.launches - before[k] for k, fn in COUNTERS.items()}
            want = nets[1](feats)
    finally:
        _set_tier("highest", "f32")
    assert launched == dict.fromkeys(COUNTERS, 0)
    assert got.dtype == want.dtype == (torch.bfloat16 if tier[1] == "bf16" else torch.float32)
    d = (got.cpu().float() - want.float()).abs()
    bar = {"default": (2e-3, 2e-5), "highest": (4e-3, 2e-5), "high": (GRU_TOL, GRU_TOL)}[tier[0]]
    assert float(d.max()) <= bar[0] and float(d.mean()) <= bar[1], (float(d.max()), float(d.mean()))



@pytest.mark.cuda
def test_kernel_a_shared_bytes_match_the_source(cuda_device):
    """The host's kernel-A plan takes the source's shared bytes a CTA and
    its cluster size."""
    lib = gates._lib()
    for per in (1, 54, 126):
        assert lib.fvad_gru_gates_3x_smem_bytes() == gates.PLaunch(0, 16, 1, 1, per, gates.P3_UNITS).smem_bytes("A")
    assert lib.fvad_gru_gates_3x_cluster() == gates.P3_CLUSTER


def test_wrappers_refuse_other_devices():
    """No wrapper silently runs a tensor that is on neither the CPU nor a
    GPU (here: the meta device)."""
    net = registry.load_denoiser("demo", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        nsnet2_cuda.gru_stack(net, torch.empty((2, 3, 1200), device="meta"))
    gi = torch.empty((2, 3, 400), device="meta")
    for wrapper in (gates.gru_gates, gates.gru_gates_p, gates.gru_gates_f):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(net, gi, gi, gi)
    with pytest.raises(ValueError, match="unsupported device"):
        gates.gru_gates_3x(net, gi, gi, gi, levels=("high", "high"))
    with pytest.raises(ValueError, match="unsupported device"):
        nsnet2_cuda.gru_stack_mixed(net, torch.empty((2, 3, 1200), device="meta"), ("high", "highest"))
    shape, params = fsm.statics_from_config(VADMachineConfig(), SR, FFT)
    x = torch.empty((2, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fsm_cuda.scan_windows(shape, params, x, x, x.bool())


def test_resolve_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve("cuda")
    assert device_mod.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve("tpu")


@pytest.mark.parametrize("rows", [1, 16, 17, 1680, 1824, 1825, 4000])
def test_kernel_a_plan_covers_the_rows(rows):
    """Kernel A's plan (pure, no GPU) on 132 SMs: one launch at any row
    count, 2 row groups x 50 unit groups of 8 units at most, an even number
    of tiles a group above 9, 115,200 bytes of weights and a ring of 6
    stages (225,936 bytes a CTA, within a block's 232,448); every row and unit
    covered once. 1,680 rows are 2 groups of 54 and 51 tiles, 100 CTAs.
    The old instantiations keep their plan: kernel 5 at 1,680 rows is one
    launch of 5 row groups x 21 tiles, 201,216 bytes a CTA."""
    plan = gates.p_launch_plan(rows, 132, gates.P3_UNITS)
    covered = []
    assert len(plan) == 1
    for launch in plan:
        assert launch.units == 8 and launch.grid == 50 * launch.row_groups <= 132
        assert launch.tiles == -(-launch.n_rows // 16)
        assert launch.tiles_per_group <= 9 or launch.tiles_per_group % 2 == 0
        assert launch.smem_bytes("A") == 115200 + 6 * (18432 + 24) == 225936 <= 232448
        for block in range(launch.grid):
            r, u = launch.cta_span(block)
            assert len(u) == 8 and u.start == 8 * (block % 50)
            if block % 50 == 0:
                covered += list(r)
    assert covered == list(range(rows))
    if rows == 1680:
        assert [(p.row_groups, p.tiles_per_group, p.grid) for p in plan] == [(2, 54, 100)]
        k5 = gates.p_launch_plan(rows, 132)
        assert [(p.row_groups, p.tiles_per_group, p.grid, p.smem_bytes(5)) for p in k5] == [(5, 21, 125, 201216)]
