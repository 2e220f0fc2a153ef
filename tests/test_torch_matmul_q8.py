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
