"""The precision tiers that the last of the port's refusals held: each
(gru_i, gru_h) pair of levels, for linear_before_reset = 1 and 0 weights;
the int8 tier under bf16 activation storage; lbr = 0 weights under bf16
storage; and the stage audit (``tools/stage_precision_audit.py``).

XLA:CPU computes every precision level in float32, so the references are
built from JAX pieces that round on the CPU (``test_torch_precision.
_jax_scan_forward``: a ``lax.scan`` over ``jnsnet2._gates_lbr``, or the lbr
= 0 gate math of ``gru_cell_pre``, with each class's products at its
level). Bars: where a product runs at 'default', gains max 2e-3 and mean
2e-5 (another float32 summation order now and then moves an h value across
a bf16 rounding step); 'high' and 'highest' alone, max 2e-6 and mean 3e-7;
the int8 tier, ``tests/test_torch_q8.py``'s (max 0.05, mean 5e-3); bf16
storage, ``tests/test_torch_precision.py``'s (max 4e-3, mean 2e-5). Each
case names the plain version its recurrence ran and checks that no other
ran.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_precision import _jax_scan_forward
from test_torch_train import _jax_apply_rounding_each_op

from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.ops import precision as jprecision
from formula_vad_tpu_torch.models import nsnet2, nsnet2_cuda, nsnet2_gates_cuda
from formula_vad_tpu_torch.ops import matmul_q8, precision
from formula_vad_tpu_torch.tools import stage_precision_audit

LEVELS = ("highest", "high", "default")
PLAIN = ((nsnet2_cuda, "gru_stack_reference"), (nsnet2_gates_cuda, "gru_gates_p_reference"),
         (nsnet2_gates_cuda, "gru_gates_f_reference"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensor ops, for which torch's intra-op threads only add
    overhead when the test workers share the cores: one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore():
    yield
    for module in (precision, jprecision):
        module.set_stage_overrides(None)
        module.set_matmul_precision("highest")
        module.set_io_dtype("f32")
        module.set_quant("off")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{lbr: (JAX params, port module)} holding the JAX
    ``init_params(PRNGKey(21))`` with N(0, 0.1) GRU biases (numpy seed 5),
    both GRUs at linear_before_reset = lbr; and the features."""
    jp = jnsnet2.init_params(jax.random.PRNGKey(21))
    rng = np.random.default_rng(5)

    def biased(g, lbr):
        b = {k: jnp.asarray(rng.normal(0.0, 0.1, (1200,)).astype(np.float32)) for k in ("bi", "bh")}
        return dataclasses.replace(g, linear_before_reset=lbr, **b)

    out = {}
    for lbr in (1, 0):
        p = dataclasses.replace(jp, gru1=biased(jp.gru1, lbr), gru2=biased(jp.gru2, lbr))
        path = str(tmp_path_factory.mktemp("weights") / f"lbr{lbr}.npz")
        jnsnet2.save_npz(path, p)
        out[lbr] = (p, nsnet2.load_npz(path))
    feats = np.random.default_rng(7).normal(-3.0, 1.5, (6, 10, 161)).astype(np.float32)
    return out, feats


def _record(monkeypatch) -> list:
    """Record (name, levels, weight dtype) of every call of the
    recurrences' plain versions."""
    calls = []
    for module, name in PLAIN:
        plain = getattr(module, name)

        def recorded(*args, name=name, plain=plain, **kw):
            dtype = args[0].dtype if name != "gru_stack_reference" else None
            calls.append((name, kw.get("levels"), dtype))
            return plain(*args, **kw)

        monkeypatch.setattr(module, name, recorded)
    return calls


def _expected_plain(level_i: str, level_h: str, lbr: int) -> tuple:
    """The plain version the route of (gru_i, gru_h) runs on the CPU."""
    if not lbr or "highest" in (level_i, level_h):
        return ("gru_stack_reference", (level_i, level_h), None)
    if (level_i, level_h) == ("default", "default"):
        return ("gru_gates_p_reference", None, torch.bfloat16)
    return ("gru_gates_p_reference", (level_i, level_h), torch.float32)


def _bars(*levels) -> tuple:
    return (2e-3, 2e-5) if "default" in levels else (2e-6, 3e-7)


@pytest.mark.parametrize("lbr", [1, 0])
@pytest.mark.parametrize("level_h", LEVELS)
@pytest.mark.parametrize("level_i", LEVELS)
def test_stage_levels_match_jax(weights, monkeypatch, level_i, level_h, lbr):
    """The forward at 'highest' with gru_i and gru_h overridden, against
    the JAX scan with each class's products at its level; the recurrence
    on its route's plain version (kernel 1's or kernel B's for a mix with
    'highest' and for every lbr = 0 pair, kernel 5's bf16 one at
    'default'/'default', kernel A's otherwise)."""
    pairs, feats = weights
    jp, net = pairs[lbr]
    want, _ = _jax_scan_forward(jp, feats, gru_i=level_i, gru_h=level_h)
    calls = _record(monkeypatch)
    precision.set_stage_overrides({"gru_i": level_i, "gru_h": level_h})
    with torch.inference_mode():
        got = net(torch.from_numpy(feats)).numpy()
    assert calls == [_expected_plain(level_i, level_h, lbr)]
    d = np.abs(got - want)
    max_bar, mean_bar = _bars(level_i, level_h)
    assert d.max() <= max_bar and d.mean() <= mean_bar, (d.max(), d.mean())


def test_bf16_3x_recurrence_is_nearer_the_jax_bf16_3x_scan(weights):
    """Control: kernel A's plain version at three passes a class gives an
    h2 sequence nearer the JAX bf16_3x scan's than the float32 recurrence
    (kernel 1's plain version) on the same gi does, in the mean and the
    largest difference (seen: 4.1e-7 against 8.4e-7, 3.4e-6 against
    5.5e-6; bf16_3x drops ~2^-16 of a product, the folded biases move
    float32 roundings of the same order)."""
    pairs, feats = weights
    jp, net = pairs[1]
    _, want = _jax_scan_forward(jp, feats, gru_i="high", gru_h="high")
    precision.set_stage_overrides({"gru_i": "high"})
    with torch.inference_mode():
        x = net.fc_in(torch.from_numpy(feats))
        high = nsnet2_gates_cuda.gru_gates_3x(net, *nsnet2_gates_cuda.gi_gates(net, x), ("high", "high")).numpy()
        gi1 = precision.matmul(x, net.gru1.wi, "gru_i") + net.gru1.bi
        f32 = nsnet2_cuda.gru_stack(net, gi1.contiguous()).numpy()
    d_high, d_f32 = np.abs(high - want), np.abs(f32 - want)
    assert d_high.mean() < d_f32.mean() and d_high.max() < d_f32.max(), (d_high.mean(), d_f32.mean())


@pytest.fixture(scope="module")
def jax_int8_bf16(weights):
    """The JAX int8 tier under bf16 storage (``apply_streaming_q8``, which
    ignores the matmul level) on the lbr = 1 weights: gains in bf16."""
    pairs, feats = weights
    jprecision.set_quant("int8")
    jprecision.set_io_dtype("bf16")
    try:  # the weights a jit argument (as constants XLA would fold them for seconds)
        gains = jax.jit(jnsnet2.apply)(pairs[1][0], jnp.asarray(feats))
    finally:
        jprecision.set_quant("off")
        jprecision.set_io_dtype("f32")
    assert gains.dtype == jnp.bfloat16
    return np.asarray(gains.astype(jnp.float32), np.float64)


@pytest.mark.parametrize("level", LEVELS)
def test_int8_with_bf16_storage_matches_jax(weights, jax_int8_bf16, monkeypatch, level):
    """The int8 tier under bf16 storage at each matmul level runs
    ``forward_q8`` (3T + 5 int8 products, no float recurrence) with its
    layer-1 projection, GRU outputs and gains stored in bf16, as
    ``apply_streaming_q8`` stores them; the gains against the JAX tier at
    the int8 bars, and off the float32-storage int8 tier's."""
    pairs, feats = weights
    net = pairs[1][1]
    precision.set_quant("int8")
    with torch.inference_mode():
        f32_storage = net(torch.from_numpy(feats)).numpy()
    calls = _record(monkeypatch)
    q8 = [0]
    plain = matmul_q8.matmul_q8_reference

    def counted(*args, **kw):
        q8[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(matmul_q8, "matmul_q8_reference", counted)
    precision.set_matmul_precision(level)
    precision.set_io_dtype("bf16")
    with torch.inference_mode():
        got = net(torch.from_numpy(feats))
    assert calls == [] and q8[0] == 3 * feats.shape[1] + 5
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - jax_int8_bf16)
    assert d.max() < 0.05 and d.mean() < 5e-3, (d.max(), d.mean())
    assert np.abs(got.float().numpy() - f32_storage).max() > 0


@pytest.fixture(scope="module")
def jax_lbr0_bf16(weights):
    pairs, feats = weights
    jprecision.set_io_dtype("bf16")
    try:
        return _jax_apply_rounding_each_op(pairs[0][0], feats)
    finally:
        jprecision.set_io_dtype("f32")


@pytest.mark.parametrize("level", LEVELS)
def test_lbr0_weights_under_bf16_storage_match_jax(weights, jax_lbr0_bf16, monkeypatch, level):
    """lbr = 0 weights under bf16 storage, at each level (two bf16
    operands multiply exactly at every level): the plain loop in bf16
    (``gru_stack_reference``: every operand and op output bf16, as the JAX
    scan runs on bf16 arrays), against the JAX forward with each op
    rounded once (``test_torch_train._jax_apply_rounding_each_op``), at the
    storage tier's bars; control: the float32
    storage's gains are off by more than 10x the mean bar."""
    pairs, feats = weights
    net = pairs[0][1]
    with torch.inference_mode():
        f32_storage = net(torch.from_numpy(feats)).numpy()
    calls = _record(monkeypatch)
    precision.set_matmul_precision(level)
    precision.set_io_dtype("bf16")
    with torch.inference_mode():
        got = net(torch.from_numpy(feats))
    assert calls == [("gru_stack_reference", (level, level), None)]
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - jax_lbr0_bf16)
    assert d.max() <= 4e-3 and d.mean() <= 2e-5, (d.max(), d.mean())
    assert np.abs(f32_storage - jax_lbr0_bf16).mean() > 10 * 2e-5


def test_stage_audit_runs_on_the_cpu(monkeypatch, capsys):
    """``tools/stage_precision_audit.py`` at SPA_STREAMS=2 SPA_CHUNKS=2
    SPA_REPS=1 on the CPU: a row for each of the 7 stages, the
    recurrence's classes at the row's levels under its override, its
    route's plain version run once a row (kernel B's at gru_i and gru_h:
    ``gru_stack_reference`` at the mixed levels), and all-'high' on kernel
    A's; the timings printed."""
    for name, value in (("SPA_STREAMS", "2"), ("SPA_CHUNKS", "2"), ("SPA_REPS", "1")):
        monkeypatch.setenv(name, value)
    calls = _record(monkeypatch)
    assert stage_precision_audit.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [line for line in out if line.startswith("stage ")]
    assert [r.split()[1].rstrip(":") for r in rows] == list(precision.STAGES)
    for row, stage in zip(rows, precision.STAGES):
        want = {"gru_i": "high/highest", "gru_h": "highest/high"}.get(stage, "highest/highest")
        assert f"gru_i/gru_h={want}" in row, row
    assert any(line.startswith("tier high: gru_i/gru_h=high/high") for line in out)
    assert sum(line.startswith("timing ") for line in out) >= 2
    levels = [c[1] for c in calls if c[0] == "gru_stack_reference"]
    assert ("high", "highest") in levels and ("highest", "high") in levels
    assert ("gru_gates_p_reference", ("high", "high"), torch.float32) in calls
    assert precision.matmul_precision() == "highest" and precision.stage_overrides() == {}
