"""Kernel B (``nsnet2_cuda.gru_stack_mixed``, ``csrc/gru_mixed.cu``) on the
CPU: what surrounds the kernel, which runs only on the card. The host's
packing of a bf16 class's weights in ``mma.sync`` B-fragment order, read
back by a plain index formula; the launch plan at the row counts the card
checks; the wrapper's refusals. The kernel itself is held to its plain
version by the GPU tests (``tests/test_torch_cuda.py -k kernel_b``) and
``chip_smoke.py`` phase 17 (b)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from formula_vad_tpu_torch.models import nsnet2_cuda, registry

H = 400
SMEM_LIMIT = 232448  # an H100 block's shared memory
SMS, BLOCKS_PER_SM = 132, 1  # an H100's SMs; kernel B's CTAs an SM (221,952 bytes of shared memory each)
# chip_smoke.py's P17_SHAPES and the low-latency hop from a state.
SHAPES = [(1680, 54), (42, 54), (37, 54), (4000, 54), (42, 1)]


@pytest.fixture(scope="module")
def net():
    return registry.load_denoiser("random", seed=3, device="cpu")


def _bf16_bits_to_float(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("matrix", ["wh1", "wi2", "wh2"])
@pytest.mark.parametrize("level", ["high", "default"])
def test_fragment_packing_reads_back_the_split(net, level, matrix):
    """``pack_at`` at 'high' and 'default' read back word by word: lane
    4 g + q of (unit group u, K step s, n8 tile n), word 2 part + half, bf16
    `pair` holds part (hi, then lo) of w[16 s + 8 half + 2 q + pair, gate *
    400 + 40 u + c % 40] with c = 8 n + g and gate = c // 40; hi =
    bf16(w), lo = bf16(w - hi) at 'high', bf16(w) alone at 'default'."""
    w = {"wh1": net.gru1.wh, "wi2": net.gru2.wi, "wh2": net.gru2.wh}[matrix].detach()
    packed = nsnet2_cuda.pack_at(w, level)
    words = 4 if level == "high" else 2
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (10, 25, 15, 32, words)
    halves = packed.contiguous().numpy().view(np.uint16).reshape(10, 25, 15, 32, words, 2)
    u, s, n, lane, word, pair = np.meshgrid(*(np.arange(d) for d in halves.shape), indexing="ij")
    g, q, part, half = lane // 4, lane % 4, word // 2, word % 2
    k = 16 * s + 8 * half + 2 * q + pair
    c = 8 * n + g
    column = (c // 40) * H + 40 * u + c % 40
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    want = torch.stack([hi.float(), lo.float()]).numpy()[part, k, column]
    assert np.array_equal(_bf16_bits_to_float(halves), want)
    # Every weight once in each part.
    assert np.array_equal(np.sort((k * 3 * H + column)[part == 0]), np.arange(H * 3 * H))


@pytest.mark.parametrize("rows, steps", SHAPES)
def test_kernel_b_plan_covers_the_rows(rows, steps):
    """Kernel B's plan on 132 SMs at one CTA an SM (its own occupancy on an
    H100: 256 threads, 221,952 bytes of shared memory): every row and unit
    in exactly one tile, one wave, at most 144 rows a tile; its shared
    memory within a block's 232,448 bytes, and the bf16 class's handed-off
    sums (144 rows at a pitch of 124 floats) within one of its two stages
    (the ring: all but the 144 x 84 floats of kept z and r sums).
    (``steps`` do not change the plan: a call of any length runs these
    tiles every step.)"""
    plan = nsnet2_cuda.launch_plan(rows, SMS, BLOCKS_PER_SM)
    assert plan.row_tile <= nsnet2_cuda.ROW_TILE_MAX and plan.grid <= SMS * BLOCKS_PER_SM
    assert plan.grid == plan.tiles or rows > 13 * nsnet2_cuda.ROW_TILE_MAX
    seen = np.zeros((rows, H), dtype=np.int64)
    for tile in range(plan.tiles):
        span, units = plan.tile_span(tile)
        assert 1 <= len(span) <= nsnet2_cuda.ROW_TILE_MAX and len(units) == nsnet2_cuda.UNIT_TILE
        seen[span.start:span.stop, units.start:units.stop] += 1
    assert (seen == 1).all()
    stage = (nsnet2_cuda.MIXED_SMEM_BYTES - nsnet2_cuda.ROW_TILE_MAX * 84 * 4) // 2
    assert nsnet2_cuda.MIXED_SMEM_BYTES == 221952 <= SMEM_LIMIT
    assert nsnet2_cuda.ROW_TILE_MAX * 124 * 4 <= stage
    if (rows, steps) == (1680, 54):
        assert (plan.row_tile, plan.row_groups, plan.grid) == (130, 13, 130)
    if rows == 42:
        assert (plan.row_tile, plan.row_groups, plan.grid) == (4, 11, 110)


@pytest.mark.parametrize("levels, device", [
    (("highest", "highest"), "cpu"),
    (("high", "high"), "cpu"),
    (("default", "high"), "cpu"),
    (("high", "highest"), "meta"),
])
def test_gru_stack_mixed_refuses(net, levels, device):
    """``gru_stack_mixed`` takes only a mix of 'highest' with 'high' or
    'default' (all-'highest' is kernel 1's, the rest kernel A's), and only
    CPU or CUDA tensors."""
    gi1 = torch.zeros((2, 3, 1200), device=device)
    if device == "meta":
        with pytest.raises(ValueError, match="unsupported device"):
            nsnet2_cuda.gru_stack_mixed(net, gi1, levels)
    else:
        with pytest.raises(ValueError, match="levels must pair"):
            nsnet2_cuda.gru_stack_mixed(net, gi1, levels)
