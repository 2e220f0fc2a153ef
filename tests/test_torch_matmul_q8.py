"""The port's int8 matmul (``ops/matmul_q8.py``) against the JAX package's
Pallas kernel and against exact references.

On the CPU the wrapper runs its plain version, which defines what the CUDA
kernel computes (the kernel itself is held to it on a GPU by
test_torch_cuda.py). Bars: bit for bit everywhere. The contraction is exact
integer arithmetic, and the epilogue is the same separately rounded float32
operations in the same order, so no tolerance is needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from formula_vad_tpu.ops.matmul_q8 import matmul_q8 as jax_matmul_q8
from formula_vad_tpu_torch.ops import matmul_q8 as mq


def _operands(r, k, n, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-127, 128, (r, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = (rng.rand(1, n) * 1e-3).astype(np.float32)
    row = (rng.rand(r, 1) * 2.0).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return a, b, s, row, bias


def _numpy_epilogue(a, b, s, row, bias, order):
    """int64 contraction, then each float32 op rounded on its own."""
    acc = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.float32)
    if order == "col_row":
        out = acc * s
        out = out * row if row is not None else out
    else:
        out = acc * row if row is not None else acc
        out = out * s
    return out + bias if bias is not None else out


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_row", [False, True])
def test_plain_version_equals_pallas_kernel(with_row, out_dtype):
    """[512, 400] x [400, 1200], the JAX kernel in interpret mode."""
    a, b, s, row, _ = _operands(512, 400, 1200, seed=3)
    want = jax_matmul_q8(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(s), row_scale=jnp.asarray(row) if with_row else None,
        out_dtype=getattr(jnp, out_dtype), interpret=True,
    )
    w = mq.Q8Weight.pack(torch.from_numpy(b), torch.from_numpy(s))
    got = mq.matmul_q8(
        torch.from_numpy(a), w, torch.from_numpy(row) if with_row else None, out_dtype=getattr(torch, out_dtype)
    )
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (512, 1200)
    want = np.asarray(want.astype(jnp.float32))
    assert got.float().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("order", mq.ORDERS)
@pytest.mark.parametrize(
    "r, k, n", [(100, 400, 1200), (100, 161, 161), (37, 161, 400), (50, 600, 161), (30, 600, 600), (1, 7, 3)]
)
def test_ragged_shapes_equal_exact_reference(r, k, n, order):
    a, b, s, row, bias = _operands(r, k, n, seed=r + k + n)
    w = mq.Q8Weight.pack(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(bias))
    for use_row in (None, row):
        want = _numpy_epilogue(a, b, s, use_row, bias, order)
        got = mq.matmul_q8(torch.from_numpy(a), w, None if use_row is None else torch.from_numpy(use_row), order=order)
        assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


def test_orders_differ_and_bf16_rounds_the_float32_result():
    """The two epilogue orders are different functions (so the order is
    really honoured), and bf16 output is the float32 result rounded to
    nearest even."""
    a, b, s, row, bias = _operands(64, 161, 400, seed=11)
    w = mq.Q8Weight.pack(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(bias))
    args = (torch.from_numpy(a), w, torch.from_numpy(row))
    col_row = mq.matmul_q8(*args, order="col_row")
    row_col = mq.matmul_q8(*args, order="row_col")
    assert not torch.equal(col_row, row_col)
    assert torch.equal(mq.matmul_q8(*args, order="row_col", out_dtype=torch.bfloat16), row_col.to(torch.bfloat16))


def test_leading_dims_and_packing():
    a, b, s, row, bias = _operands(24, 161, 40, seed=5)
    w = mq.Q8Weight.pack(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(bias))
    assert w.qt.shape == (40, 192) and w.k == 161 and w.n == 40
    assert torch.equal(w.qt[:, :161], torch.from_numpy(b).t()) and not w.qt[:, 161:].any()
    flat = mq.matmul_q8(torch.from_numpy(a), w, torch.from_numpy(row), order="row_col")
    nested = mq.matmul_q8(
        torch.from_numpy(a).reshape(2, 3, 4, 161), w, torch.from_numpy(row).reshape(2, 3, 4, 1), order="row_col"
    )
    assert nested.shape == (2, 3, 4, 40) and torch.equal(nested.reshape(24, 40), flat)


def test_cpu_runs_plain_version_without_counting_a_launch():
    a, b, s, _, _ = _operands(8, 32, 16, seed=1)
    w = mq.Q8Weight.pack(torch.from_numpy(b), torch.from_numpy(s))
    before = mq.matmul_q8.launches
    assert torch.equal(mq.matmul_q8(torch.from_numpy(a), w), mq.matmul_q8_reference(torch.from_numpy(a), w))
    assert mq.matmul_q8.launches == before


def test_refuses_what_it_does_not_take():
    a, b, s, row, _ = _operands(8, 32, 16, seed=2)
    a, w = torch.from_numpy(a), mq.Q8Weight.pack(torch.from_numpy(b), torch.from_numpy(s))
    with pytest.raises(ValueError, match="order"):
        mq.matmul_q8(a, w, order="row_row")
    with pytest.raises(ValueError, match="out_dtype"):
        mq.matmul_q8(a, w, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="int8"):
        mq.matmul_q8(a.float(), w)
    with pytest.raises(ValueError, match="int8"):
        mq.matmul_q8(a[:, :31], w)
    with pytest.raises(ValueError, match="row_scale"):
        mq.matmul_q8(a, w, torch.from_numpy(row[:7]))
    with pytest.raises(ValueError, match="K, N"):
        mq.Q8Weight.pack(torch.from_numpy(b).float(), torch.from_numpy(s))
    with pytest.raises(ValueError, match="unsupported device"):
        mq.matmul_q8(torch.empty((8, 32), dtype=torch.int8, device="meta"), w)


# The int8 tier's six products on the 21-stream slice, and the GPU tests'
# ragged shapes: (R, K, N).
SLICE_SHAPES = [
    (90720, 161, 400), (90720, 400, 1200), (1680, 400, 1200), (84000, 400, 600), (84000, 600, 600), (84000, 600, 161),
]
GPU_SHAPES = [
    (37, 161, 400), (100, 161, 161), (300, 600, 161), (129, 600, 600), (5, 7, 3), (12345, 161, 400),
    (12345, 400, 1200), (12345, 600, 161), (129, 400, 1200), (257, 161, 400), (257, 400, 1200),
]


def _k_pad(k):
    return -(-k // mq.K_STEP) * mq.K_STEP


def _check_covers_once(plan, k, sms):
    """Every tile goes to exactly one CTA, in contiguous ranges; the tiles'
    row and column ranges cut [0, R) x [0, N) into disjoint blocks; the
    grid fits one CTA a SM and the shared memory fits the limit."""
    assert 1 <= plan.grid <= min(plan.tiles, sms)
    taken = [t for c in range(plan.grid) for t in plan.cta_tiles(c)]
    assert taken == list(range(plan.tiles))
    assert max(len(plan.cta_tiles(c)) for c in range(plan.grid)) == plan.waves
    rows = [plan.tile(mb * plan.col_blocks)[0] for mb in range(plan.row_blocks)]
    cols = [plan.tile(nb)[1] for nb in range(plan.col_blocks)]
    assert [i for rr in rows for i in rr] == list(range(plan.rows)) and all(len(rr) for rr in rows)
    assert [j for cc in cols for j in cc] == list(range(plan.n)) and all(len(cc) for cc in cols)
    for t in range(0, plan.tiles, max(1, plan.tiles // 97)):
        mb, nb = divmod(t, plan.col_blocks)
        assert plan.tile(t) == (rows[mb], cols[nb])
    assert plan.bn in mq.TILE_NS and mq.smem_bytes(plan.bn, _k_pad(k), False) <= mq.SMEM_LIMIT


@pytest.mark.parametrize("r, k, n", SLICE_SHAPES + GPU_SHAPES)
def test_tile_plan_covers_every_output_once(r, k, n):
    _check_covers_once(mq.tile_plan(r, n, _k_pad(k), 132), k, 132)


@pytest.mark.parametrize("k, n", [(161, 400), (400, 1200), (600, 161), (7, 3)])
def test_tile_plan_covers_every_output_once_at_small_rows(k, n):
    """1 <= R <= 300, element by element, on 132 SMs and on 7."""
    for sms in (132, 7):
        for r in range(1, 301):
            plan = mq.tile_plan(r, n, _k_pad(k), sms)
            _check_covers_once(plan, k, sms)
            hits = np.zeros((r, n), dtype=np.int32)
            for t in range(plan.tiles):
                rows, cols = plan.tile(t)
                hits[rows.start:rows.stop, cols.start:cols.stop] += 1
            assert (hits == 1).all(), (r, k, n, sms)


def test_tile_plan_in_scan_product_is_one_wave():
    """The 1,680 x 1,200 product inside the GRU scan (K = 400), 162 times a
    forward: no partial second wave on 132 SMs, where 128 x 128 tiles
    would leave 8 of 140 tiles to one."""
    plan = mq.tile_plan(1680, 1200, 416, 132, True)
    assert plan.tiles <= 132 and plan.waves == 1 and plan.grid == plan.tiles
    assert (plan.bn, plan.tiles) == (144, 126)
    assert mq.select_path(1680, 400, 1200, torch.float32, 0, 132) == mq.Path("wgmma", plan, 16, True)
    assert mq.smem_bytes(144, 416, True) <= mq.SMEM_LIMIT < mq.smem_bytes(144, 608, False)
    assert mq.tile_plan(1680, 1200, 800, 132) is None  # K_pad > 608: no wgmma plan


# A's load width on the wgmma body, by K and A's byte offset modulo 16: 16
# bytes by TMA where both are multiples of 16, 8 by cp.async where both are
# multiples of 8, else through registers.
A_VEC = {
    (7, 0): 1, (7, 1): 1, (7, 4): 1, (7, 8): 1,
    (161, 0): 1, (161, 1): 1, (161, 4): 1, (161, 8): 1,
    (400, 0): 16, (400, 1): 1, (400, 4): 1, (400, 8): 8,
    (600, 0): 8, (600, 1): 1, (600, 4): 1, (600, 8): 8,
}


@pytest.mark.parametrize("out_dtype", mq.OUT_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("k, offset", sorted(A_VEC))
def test_select_path_by_shape_and_alignment(k, offset, out_dtype):
    for n in (3, 161, 400, 600, 1200):
        for r in (5, 1680, 90720):
            path = mq.select_path(r, k, n, out_dtype, offset, 132)
            assert path.name == "wgmma" and path.plan == mq.tile_plan(r, n, _k_pad(k), 132, path.a_vec == 16)
            assert path.a_vec == A_VEC[k, offset]
            # 16-byte output stores where a row is a whole number of 16 bytes
            assert path.out_vec == (n in (400, 600, 1200))
            # past the K the wgmma body holds, the widest load that divides
            # K and the offset, on the mma_sync body
            wide = mq.select_path(r, k + 704, n, out_dtype, offset, 132)
            assert wide.name == "mma_sync" and wide.plan is None and not wide.out_vec
            assert wide.a_vec == (4 if (k, offset) == (400, 4) or (k, offset) == (600, 4) else A_VEC[k, offset])


def test_select_path_keeps_tma_a_within_shared_memory():
    """K = 608 would qualify for TMA, but A's 128-byte blocks (640 bytes a
    row) and B's do not fit beside the staging tile: A goes by cp.async."""
    path = mq.select_path(1000, 608, 600, torch.float32, 0, 132)
    assert (path.name, path.a_vec, path.plan.bn) == ("wgmma", 8, 128)
    assert mq.smem_bytes(128, 608, True) > mq.SMEM_LIMIT >= mq.smem_bytes(128, 608, False)
    assert mq.select_path(1000, 512, 600, torch.float32, 0, 132).a_vec == 16


def test_select_path_takes_mma_sync_past_the_shared_memory_k():
    """The wgmma body holds K_pad <= 608; from 609 on every call takes the
    mma_sync body, whatever its rows, N and output type."""
    path = mq.select_path(130, 700, 200, torch.float32, 4, 132)
    assert (path.name, path.plan, path.a_vec) == ("mma_sync", None, 4)
    for k in (600, 608, 609, 640, 1024):
        for r, n, dtype in ((5, 3, torch.float32), (90720, 1200, torch.bfloat16)):
            assert mq.select_path(r, k, n, dtype, 0, 132).name == ("wgmma" if k <= mq.K_PAD_MAX else "mma_sync")
