"""The port's low-latency mode (``pipeline/lowlatency.py``) and the model's
carried GRU state (``NSNet2.forward_streaming``, the recurrence wrappers'
``state``) against the JAX package, on the same inputs.

Bars: the float tier's audio and final state at 1e-5, the JAX package's own
bar between its chained steps and its run (tests/test_utils_and_lowlatency.py);
``forward_streaming`` at the port's model bar, 1e-5 (tests/test_torch_nsnet2.py).
The plain versions of the recurrences with a zero state equal their
stateless calls bit for bit, and a call split at step 27 equals one call
(bit for bit where the split changes no product's shape). The tiers are
held to the JAX tier at the bars of tests/test_torch_precision.py (gains of
``high``: max 2e-6, mean 3e-7; bf16: 2e-3, 2e-5; bf16 storage: 4e-3, 2e-5)
and tests/test_torch_q8.py (int8: max 0.05, mean 5e-3), on those tests'
inputs and weights, in two calls with the state carried. Weights: the JAX
``init_params(PRNGKey(21))`` carried across by ``from_numpy`` (the bf16
tier: the packaged demo weights, as its tier test); audio from
``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_nsnet2 import _flat
from test_torch_precision import _jax_bf16_forward, _jax_high_forward, _jax_io_dense, _jax_io_forward, _jdot, _rb

from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models import nsnet2_q8 as jnsnet2_q8
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu.ops import precision as jprecision
from formula_vad_tpu.pipeline import lowlatency as jlowlatency
from formula_vad_tpu_torch.models import nsnet2, nsnet2_cuda, nsnet2_gates_cuda, registry
from formula_vad_tpu_torch.ops import matmul_q8, precision
from formula_vad_tpu_torch.pipeline import lowlatency

TOL = 1e-5
HOP = 480
N_HOPS, SPLIT = 40, 20


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops, for which torch's intra-op threads only add
    overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore():
    yield
    for module in (precision, jprecision):
        module.set_matmul_precision("highest")
        module.set_io_dtype("f32")
        module.set_quant("off")


@pytest.fixture(scope="module")
def pair():
    """(JAX params, port module) holding the JAX ``init_params(PRNGKey(21))``."""
    jp = jnsnet2.init_params(jax.random.PRNGKey(21))
    return jp, nsnet2.from_numpy(_flat(jp))


@pytest.fixture(scope="module")
def audio():
    """2 stereo streams x 40 hops of noise with tones."""
    rng = np.random.default_rng(15)
    t = np.arange(N_HOPS * HOP) / 48000.0
    tone = 0.2 * np.sin(2 * np.pi * 700 * t) * (t > 0.15)
    return (0.05 * rng.standard_normal((2, 2, N_HOPS * HOP)) + tone).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run(pair, audio):
    jp, _ = pair
    # The weights as an argument, not constants of the trace: XLA would fold
    # every product of them at compile time.
    state, out = jax.jit(lambda p, a: jlowlatency.run(p, a))(jp, jnp.asarray(audio))
    return jax.tree_util.tree_map(np.asarray, state), np.asarray(out)


def _port_run(net, audio, state=None):
    with torch.inference_mode():
        return lowlatency.run(net, torch.from_numpy(audio), state)


def _states_close(got: dict, want: dict, tol: float = TOL) -> None:
    for key in ("in_tail", "out_tail", "last_sample"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=tol, rtol=0, err_msg=key)
    for a, b in zip(got["gru"], want["gru"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0, err_msg="gru")


def test_run_matches_jax(pair, audio, jax_run):
    state, out = _port_run(pair[1], audio)
    want_state, want = jax_run
    assert out.shape == want.shape == audio.shape
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=0)
    assert np.abs(want).max() > 0.05  # the network passed signal through
    _states_close({k: (tuple(x.numpy() for x in v) if k == "gru" else v.numpy()) for k, v in state.items()}, want_state)


def test_step_chain_and_split_run_match_one_run(pair, audio):
    net = pair[1]
    whole_state, whole = _port_run(net, audio)
    with torch.inference_mode():
        state = lowlatency.init_state((2, 2), "cpu")
        outs = []
        for i in range(N_HOPS):
            state, o = lowlatency.step(net, state, torch.from_numpy(audio[..., i * HOP : (i + 1) * HOP]))
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), whole.numpy(), atol=TOL, rtol=0)
    _states_close(state, whole_state)
    first_state, first = _port_run(net, audio[..., : SPLIT * HOP])
    second_state, second = _port_run(net, audio[..., SPLIT * HOP :], first_state)
    np.testing.assert_allclose(torch.cat([first, second], -1).numpy(), whole.numpy(), atol=TOL, rtol=0)
    _states_close(second_state, whole_state)


def test_latency_is_one_hop(pair):
    """An impulse in input hop 5 reaches no output hop before 5, as the JAX
    package's test_latency_is_one_hop: one 10 ms hop of latency, not 0.5 s.
    The two frames that hold it end by completing output hop 7 (frame 6's
    second half, the OLA tail), and the energy a hop is the JAX run's."""
    audio = np.zeros((1, 10 * HOP), np.float32)
    audio[0, 5 * HOP + 99] = 1.0  # on the decimation grid
    _, out = _port_run(pair[1], audio)
    _, want = jlowlatency.run(pair[0], jnp.asarray(audio))
    energy = np.abs(out.numpy()).reshape(10, HOP).sum(axis=-1)
    np.testing.assert_allclose(energy, np.abs(np.asarray(want)).reshape(10, HOP).sum(axis=-1), atol=1e-4, rtol=0)
    assert not (energy[:5] > 1e-6).any() and not (energy[8:] > 1e-6).any()
    assert energy[5] > 1e-6 or energy[6] > 1e-6


def test_forward_streaming_from_a_nonzero_state_matches_jax(pair):
    jp, net = pair
    rng = np.random.default_rng(4)
    feats = rng.normal(-3.0, 1.5, (4, 6, 161)).astype(np.float32)
    h = tuple(np.tanh(rng.normal(0.0, 0.8, (4, 400))).astype(np.float32) for _ in range(2))
    (jh1, jh2), want = jnsnet2.apply_streaming(jp, tuple(map(jnp.asarray, h)), jnp.asarray(feats))
    with torch.inference_mode():
        (h1, h2), got = net.forward_streaming(tuple(map(torch.from_numpy, h)), torch.from_numpy(feats))
        from_zero = net.forward_streaming(nsnet2.zero_state((4,)), torch.from_numpy(feats))[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), atol=TOL, rtol=0)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), atol=TOL, rtol=0)
    assert np.abs(from_zero.numpy() - got.numpy()).max() > 1e-3  # the state mattered
    empty_state, empty = net.forward_streaming((h1, h2), torch.zeros((4, 0, 161)))
    assert empty.shape == (4, 0, 161) and empty_state[0] is h1


def _gates_inputs(net, rows: int, steps: int, seed: int):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.0, 0.5, (rows, steps, 400)).astype(np.float32))
    state = tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (rows, 400))).astype(np.float32)) for _ in range(2))
    return x, state


def _kernel_1(net, x, dtype, state):
    gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
    return nsnet2_cuda.gru_stack(net, gi1, state=state)


WRAPPERS = {
    "kernel_1": _kernel_1,
    "kernel_4": lambda net, x, dt, state: nsnet2_gates_cuda.gru_gates(
        net, *nsnet2_gates_cuda.gi_gates(net, x), dtype=dt, state=state),
    "kernel_5": lambda net, x, dt, state: nsnet2_gates_cuda.gru_gates_p(
        net, *nsnet2_gates_cuda.gi_gates(net, x), dtype=dt, state=state),
    "kernel_6": lambda net, x, dt, state: nsnet2_gates_cuda.gru_gates_f(
        net, *nsnet2_gates_cuda.gi_gates(net, x), dtype=dt, out_dtype=dt, state=state),
}
CASES = [("kernel_1", torch.float32)] + [(k, dt) for k in ("kernel_4", "kernel_5", "kernel_6")
                                         for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("kernel,dtype", CASES, ids=[f"{k}-{str(dt)[6:]}" for k, dt in CASES])
def test_plain_versions_carry_the_state(pair, kernel, dtype):
    """Each recurrence's plain version from a zero state is its stateless
    call bit for bit, and split at step 27 with the state carried it is one
    call from a nonzero state, bit for bit (its per-step products keep their
    shapes)."""
    net = pair[1]
    run = WRAPPERS[kernel]
    x, state = _gates_inputs(net, 5, 54, seed=len(kernel))
    with torch.inference_mode():
        stateless = run(net, x, dtype, None)
        zero = run(net, x, dtype, nsnet2.zero_state((5,)))
        assert torch.is_tensor(stateless) and torch.equal(zero[0], stateless)
        whole, (h1, h2) = run(net, x, dtype, state)
        first, mid = run(net, x[:, :27], dtype, state)
        second, (g1, g2) = run(net, x[:, 27:], dtype, mid)
    assert whole.dtype == stateless.dtype and h1.dtype == h2.dtype == torch.float32
    assert torch.equal(torch.cat([first, second], 1), whole)
    assert torch.equal(g1, h1) and torch.equal(g2, h2)
    assert torch.equal(whole[:, -1].float(), h2.to(whole.dtype).float())
    assert not torch.equal(whole, stateless)


def _jax_io_split(jp, feats, split: int):
    """The bf16-storage tier's model over ``feats`` in two calls, from JAX
    pieces that round on the CPU: ``_jax_io_forward``'s products, and kernel
    6's recurrence (bf16 gi and weights, float32 h rounded to bf16 where it
    enters a product, float32 sums, a bf16 out) as a JAX loop that takes a
    state, the state rounded to bf16 between the calls as the JAX package
    casts it."""
    h, g1, g2 = jnsnet2.HIDDEN, jp.gru1, jp.gru2
    x = _jax_io_dense(feats, jp.fc_in_w, jp.fc_in_b)
    gi1 = _rb(_jdot(x.astype(jnp.bfloat16), g1.wi.astype(jnp.bfloat16)))
    gz = _rb(gi1[..., :h] + (g1.bi[:h] + g1.bh[:h]))
    gr = _rb(gi1[..., h : 2 * h] + (g1.bi[h : 2 * h] + g1.bh[h : 2 * h]))
    gn = _rb(gi1[..., 2 * h :] + g1.bi[2 * h :])
    w = [m[:, k * h : (k + 1) * h].astype(jnp.bfloat16) for m in (g1.wh, g2.wi, g2.wh) for k in range(3)]
    b_n1, b_n2i, b_n2h = g1.bh[2 * h :], g2.bi[2 * h :], g2.bh[2 * h :]
    b_z2, b_r2 = g2.bi[:h] + g2.bh[:h], g2.bi[h : 2 * h] + g2.bh[h : 2 * h]
    h1 = h2 = jnp.zeros(feats.shape[:-2] + (h,), jnp.float32)
    ys = []
    for t in range(feats.shape[-2]):
        if t == split:
            h1, h2 = _rb(h1), _rb(h2)
        d1 = h1.astype(jnp.bfloat16)
        z1 = jax.nn.sigmoid(gz[..., t, :] + _jdot(d1, w[0]))
        r1 = jax.nn.sigmoid(gr[..., t, :] + _jdot(d1, w[1]))
        n1 = jnp.tanh(gn[..., t, :] + r1 * (_jdot(d1, w[2]) + b_n1))
        h1 = (1.0 - z1) * n1 + z1 * h1
        d1, d2 = h1.astype(jnp.bfloat16), h2.astype(jnp.bfloat16)
        z2 = jax.nn.sigmoid(_jdot(d1, w[3]) + _jdot(d2, w[6]) + b_z2)
        r2 = jax.nn.sigmoid(_jdot(d1, w[4]) + _jdot(d2, w[7]) + b_r2)
        n2 = jnp.tanh((_jdot(d1, w[5]) + b_n2i) + r2 * (_jdot(d2, w[8]) + b_n2h))
        h2 = (1.0 - z2) * n2 + z2 * h2
        ys.append(_rb(h2))
    y = jnp.stack(ys, axis=-2)
    y = jax.nn.relu(_jax_io_dense(y, jp.ff1_w, jp.ff1_b))
    y = jax.nn.relu(_jax_io_dense(y, jp.ff2_w, jp.ff2_b))
    return _rb(jax.nn.sigmoid(_jax_io_dense(y, jp.out_w, jp.out_b)))


def _jax_int8_split(jp, feats, split: int):
    """The JAX int8 model over ``feats`` in two calls, the state carried."""
    step = jax.jit(jnsnet2_q8.apply_streaming_q8)  # the weights an argument, as in jax_run
    state, first = step(jp, jnsnet2.zero_state(feats.shape[:-2]), feats[..., :split, :])
    _, second = step(jp, state, feats[..., split:, :])
    return jnp.concatenate([first, second], axis=-2)


# tier: (matmul level, io dtype, quant, the plain version its recurrence runs,
# the weights, the JAX tier over the features split in two calls, gains max and mean bars)
TIERS = {
    "high": ("high", "f32", "off", (nsnet2_gates_cuda, "gru_gates_p_reference"), "random",
             lambda jp, f, split: _jax_high_forward(jp, f), 2e-6, 3e-7),
    "bf16": ("default", "f32", "off", (nsnet2_gates_cuda, "gru_gates_p_reference"), "demo",
             lambda jp, f, split: _jax_bf16_forward(jp, f), 2e-3, 2e-5),
    "bf16_io": ("default", "bf16", "off", (nsnet2_gates_cuda, "gru_gates_f_reference"), "random",
                _jax_io_split, 4e-3, 2e-5),
    "int8": ("highest", "f32", "int8", (matmul_q8, "matmul_q8_reference"), "random", _jax_int8_split, 0.05, 5e-3),
}


@pytest.fixture(scope="module")
def demo_pair():
    return jnsnet2.load_npz(DEMO_WEIGHTS), registry.load_denoiser("demo", device="cpu")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tiers_carry_the_state_and_match_jax(pair, demo_pair, audio, tier, monkeypatch):
    """The tier's model in two calls, the state carried from the first to
    the second, against the JAX tier on the inputs and weights of the
    port's tier tests (tests/test_torch_precision.py: 12 rows x 10 frames,
    the split after 5); and the tier's ``lowlatency.run`` over 10 hops
    launching its recurrence once (int8: its 3 in-step products a hop and
    5 more). The float32 state makes the split exact in ``high`` and bf16,
    so their bars are the one-call bars; bf16 storage rounds the state at
    the split, and so does its JAX reference."""
    level, io, quant, (module, plain_name), weights, jax_tier, max_bar, mean_bar = TIERS[tier]
    jp, net = demo_pair if weights == "demo" else pair
    feats = np.random.default_rng(7).normal(-3.0, 1.5, (12, 10, 161)).astype(np.float32)
    want = np.asarray(jax_tier(jp, jnp.asarray(feats), 5), np.float64)
    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)
    precision.set_quant(quant)
    calls = [0]
    plain = getattr(module, plain_name)

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(module, plain_name, counted)
    x = torch.from_numpy(feats)
    with torch.inference_mode():
        state, first = net.forward_streaming(nsnet2.zero_state((12,)), x[:, :5])
        _, second = net.forward_streaming(state, x[:, 5:])
        got = torch.cat([first, second], 1).float().numpy()
        calls[0] = 0
        _, out = lowlatency.run(net, torch.from_numpy(audio[..., : 10 * HOP]))
    d = np.abs(got - want)
    assert d.max() <= max_bar and d.mean() <= mean_bar, (d.max(), d.mean())
    assert calls[0] == (3 * 10 + 5 if tier == "int8" else 1)
    assert out.shape == (2, 2, 10 * HOP) and bool(torch.isfinite(out).all())


def test_io_reference_without_a_split_is_the_jax_kernel_6(pair):
    """``_jax_io_split``'s loop without a split against the TPU kernel 6 in
    interpret mode (``_jax_io_forward``), at the bf16-storage bars."""
    jp, _ = pair
    feats = jnp.asarray(np.random.default_rng(7).normal(-3.0, 1.5, (12, 10, 161)).astype(np.float32))
    d = np.abs(np.asarray(_jax_io_split(jp, feats, -1), np.float64) - np.asarray(_jax_io_forward(jp, feats)))
    assert d.max() <= 4e-3 and d.mean() <= 2e-5, (d.max(), d.mean())


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lowlatency.init_state((2, 2))
    with pytest.raises(ValueError, match="480"):
        lowlatency.step(None, lowlatency.init_state((1,), "cpu"), torch.zeros((1, 100)))
