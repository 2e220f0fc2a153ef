"""Training in the port (``train/nsnet2_train.py``, ``apps/train.py``, the
training half of ``utils/checkpoint.py``, the segment STFT of its data)
against the JAX package's trainer, on the CPU.

Both packages get the same numpy arrays (weights from the JAX
``init_params`` with random biases, batches from a numpy seed; B = 4,
T = 8 unless stated). Tolerances, each stated with its test: float32
products and reductions summed in other orders give relative differences
of ~1e-6 in a loss, a gradient or a spectrum; Adam's first steps move an
element by about lr whatever the size of its gradient, so parameter checks
after full steps derive their bound from lr.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from formula_vad_tpu.apps import train as jtrain_app
from formula_vad_tpu.io_.wav import write_wav
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models import onnx_import as jonnx
from formula_vad_tpu.ops import precision as jprecision
from formula_vad_tpu.ops import stft as jstft
from formula_vad_tpu.pipeline import denoiser as jdenoiser
from formula_vad_tpu.train import nsnet2_train as jtrain
from formula_vad_tpu_torch import _build
from formula_vad_tpu_torch.apps import train as train_app
from formula_vad_tpu_torch.eval import denoise_quality as dq
from formula_vad_tpu_torch.models import nsnet2, onnx_import
from formula_vad_tpu_torch.ops import precision, stft
from formula_vad_tpu_torch.pipeline import denoiser
from formula_vad_tpu_torch.train import nsnet2_train as train
from formula_vad_tpu_torch.utils import checkpoint

B, T = 4, 8
LR = 1e-3
PARAM_NAMES = (
    "fc_in_w", "fc_in_b", *(f"{g}_{k}" for g in ("gru1", "gru2") for k in ("wi", "wh", "bi", "bh")),
    "ff1_w", "ff1_b", "ff2_w", "ff2_b", "out_w", "out_b",
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensor ops, for which torch's intra-op threads only add
    overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(lbr: int = 1, seed: int = 0):
    """The JAX init with N(0, 0.1) biases (numpy seed), so that every bias
    term counts, and both GRUs' linear_before_reset set to ``lbr``."""
    p = jnsnet2.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    leaves = [jnp.asarray(rng.normal(0.0, 0.1, l.shape).astype(np.float32)) if l.ndim == 1 else l for l in leaves]
    p = jax.tree_util.tree_unflatten(treedef, leaves)
    return dataclasses.replace(
        p, gru1=dataclasses.replace(p.gru1, linear_before_reset=lbr),
        gru2=dataclasses.replace(p.gru2, linear_before_reset=lbr),
    )


def _leaves(params) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _port_net(params):
    """The port's network holding the JAX params, gradients on."""
    lbr = (params.gru1.linear_before_reset, params.gru2.linear_before_reset)
    net, _ = train.train_state_from_numpy(_leaves(params), *[[np.zeros_like(a) for a in _leaves(params)]] * 2, 0,
                                          lbr=lbr)
    return net


def _batch(seed: int, b: int = B, t: int = T):
    """(feats, n_re, n_im, c_re, c_im) as numpy, the synth_batch recipe."""
    rng = np.random.default_rng(seed)
    c_re, c_im = (rng.standard_normal((b, t, 161)).astype(np.float32) for _ in range(2))
    n_re = (c_re + 0.5 * rng.standard_normal((b, t, 161))).astype(np.float32)
    n_im = (c_im + 0.5 * rng.standard_normal((b, t, 161))).astype(np.float32)
    feats = np.log10(np.maximum(n_re**2 + n_im**2, 1e-12)).astype(np.float32)
    return feats, n_re, n_im, c_re, c_im


def _jax_grads(params, batch):
    # A fresh jit a call: the precision switches are read when it traces.
    loss, grads = jax.jit(jax.value_and_grad(jtrain.spectral_loss))(params, *map(jnp.asarray, batch))
    return float(loss), _leaves(grads)


def _port_grads(net, batch):
    for p in net.parameters():
        p.grad = None
    loss = train.spectral_loss(net, *map(torch.from_numpy, batch))
    loss.backward()
    return loss.item(), [p.grad.numpy().copy() for p in net.parameters()]


def test_parameter_order_is_nsnet2params_leaf_order():
    net = _port_net(_jax_params())
    for a, p in zip(_leaves(_jax_params()), net.parameters(), strict=True):
        assert tuple(a.shape) == tuple(p.shape) and a.tobytes() == p.detach().numpy().tobytes()


@pytest.mark.parametrize("decimate", [1, 3])
@pytest.mark.parametrize("initial", [False, True])
def test_segment_stft_matches_jax_stft_segmat(decimate, initial):
    """The trainer's STFT (``segmat_prod`` + ``segmat_spectra``: a strided
    decimation, then the segment basis) against JAX's ``stft_segmat``
    (decimation folded into the basis), the initial segment as
    ``raw_tail``: the spectra at atol 2e-5 (|X| up to ~10: one float32
    product summed in another order)."""
    hop = 160
    rng = np.random.default_rng(decimate)
    x = rng.standard_normal((3, 6 * hop * decimate)).astype(np.float32)
    init = rng.standard_normal((3, hop * decimate)).astype(np.float32) if initial else None
    window = denoiser.WINDOW
    assert window.tobytes() == np.asarray(jdenoiser._WINDOW, np.float32).tobytes()
    want = jstft.stft_segmat(jnp.asarray(x), jdenoiser._WINDOW, 320, decimate,
                             None if init is None else jnp.asarray(init))
    prod = stft.segmat_prod(torch.from_numpy(x), None if init is None else torch.from_numpy(init), window, 320, decimate)
    got = stft.segmat_spectra(prod, 320)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 6, 161)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


@pytest.mark.parametrize("lbr", [1, 0])
def test_apply_matches_jax(lbr):
    """``apply`` against the JAX ``nsnet2.apply`` at 'highest': atol 1e-5
    on gains in (0, 1), as tests/test_torch_nsnet2.py holds the scoring
    forward."""
    params = _jax_params(lbr)
    feats = _batch(1)[0]
    want = np.asarray(jnsnet2.apply(params, jnp.asarray(feats)))
    with torch.no_grad():
        got = train.apply(_port_net(params), torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (B, T, 161)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("lbr", [1, 0])
def test_loss_and_gradients_match_jax(lbr):
    """The loss and all 16 gradient arrays against ``jax.value_and_grad(
    spectral_loss)``: the loss at rtol 1e-5, each gradient within 1e-4 of
    its largest element (float32 sums in other orders through 8 steps of
    the recurrence give ~1e-6). Every gradient is nonzero: fc_in and both
    GRUs train too."""
    params = _jax_params(lbr)
    batch = _batch(2)
    want_loss, want = _jax_grads(params, batch)
    got_loss, got = _port_grads(_port_net(params), batch)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert len(got) == len(want) == 16
    for name, g, w in zip(PARAM_NAMES, got, want):
        scale = np.max(np.abs(w))
        assert scale > 0 and np.max(np.abs(g)) > 0, name
        assert np.max(np.abs(g - w)) <= 1e-4 * scale, (name, np.max(np.abs(g - w)), scale)


def test_adam_matches_optax():
    """``torch.optim.Adam`` against ``optax.adam`` fed the same gradient
    sequence for 3 steps, gradients spanning 1e-12 to 1: after step k the
    parameters within k x (2 float32 ulps of their value + 1e-5 lr) and the
    moments at rtol 1e-5. The ulps: each package rounds the update and its
    addition otherwise (1-3 seen). The 1e-5 lr: optax computes the bias
    correction 1 - 0.999^t in float32, 1.3e-5 below its value at t = 1,
    which moves its update by 6.4e-6 of lr (torch computes it in float64)."""
    rng = np.random.default_rng(7)
    shapes = [(5, 7), (7,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-12, 1, s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    opt = optax.adam(LR)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    topt = torch.optim.Adam(tp, lr=LR)
    for k, g in enumerate(grads, 1):
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step()
        for p, w, m, v in zip(tp, jp, state[0].mu, state[0].nu):
            w = np.asarray(w)
            assert np.all(np.abs(p.detach().numpy() - w) <= k * (2 * np.spacing(np.abs(w)) + 1e-5 * LR))
            np.testing.assert_allclose(topt.state[p]["exp_avg"].numpy(), np.asarray(m), rtol=1e-5, atol=0)
            np.testing.assert_allclose(topt.state[p]["exp_avg_sq"].numpy(), np.asarray(v), rtol=1e-5, atol=0)
    assert all(float(topt.state[p]["step"]) == int(state[0].count) == 3 for p in tp)


def _jax_steps(params, batches):
    step = jtrain.make_train_step(optax.adam(LR))
    params = jax.tree_util.tree_map(jnp.array, params)
    opt_state = optax.adam(LR).init(params)
    losses = []
    for b in batches:
        params, opt_state, loss = step(params, opt_state, tuple(map(jnp.asarray, b)))
        losses.append(float(loss))
    return params, opt_state, losses


def _port_steps(net, opt, batches):
    step = train.make_train_step(opt, net)
    return [float(step(tuple(map(torch.from_numpy, b)))) for b in batches]


def _params_close(net, params, steps_apart: int):
    """The port's parameters against the JAX ones after full steps. Adam's
    update of an element is lr * m / (sqrt(v) + eps): about lr whatever the
    gradient's size, so an element whose tiny gradients differ between the
    packages (sign, or size near eps) may move otherwise by up to 2 lr a
    step. Bound: every element within 2 lr x ``steps_apart``; all but 1e-3
    of them within 1e-3 lr (those whose gradients agree)."""
    for name, p, w in zip(PARAM_NAMES, net.parameters(), _leaves(params)):
        d = np.abs(p.detach().numpy() - w)
        assert np.max(d) <= 2 * LR * steps_apart, (name, np.max(d))
        assert np.mean(d > 1e-3 * LR) <= 1e-3, (name, np.mean(d > 1e-3 * LR))


def test_three_steps_match_jax():
    """Three full steps of ``make_train_step`` from the same parameters on
    the same three batches: the losses at rtol 1e-5, then the parameters
    (``_params_close``, 3 steps apart)."""
    params = _jax_params()
    batches = [_batch(10 + i) for i in range(3)]
    want_params, _, want_losses = _jax_steps(params, batches)
    net, opt = train.train_state_from_numpy(_leaves(params), *[[np.zeros_like(a) for a in _leaves(params)]] * 2, 0,
                                            learning_rate=LR)
    got_losses = _port_steps(net, opt, batches)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    _params_close(net, want_params, 3)


def test_train_state_from_numpy_continues_a_jax_run():
    """JAX takes 2 steps; the port resumes from its parameters and Adam
    state (``train_state_from_numpy``) and takes step 3; against JAX's 3
    steps: the third loss at rtol 1e-5, the parameters one step apart."""
    params = _jax_params()
    batches = [_batch(20 + i) for i in range(3)]
    two, state, _ = _jax_steps(params, batches[:2])
    three, _, want_losses = _jax_steps(params, batches)
    adam = state[0]
    net, opt = train.train_state_from_numpy(_leaves(two), _leaves(adam.mu), _leaves(adam.nu), int(adam.count),
                                            learning_rate=LR)
    assert all(float(opt.state[p]["step"]) == 2 for p in net.parameters())
    (got,) = _port_steps(net, opt, batches[2:])
    assert got == pytest.approx(want_losses[2], rel=1e-5)
    _params_close(net, three, 1)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


_JNP_MATMUL = jnp.matmul
_LEVEL_NAMES = {jax.lax.Precision.HIGHEST: "highest", jax.lax.Precision.HIGH: "high",
                jax.lax.Precision.DEFAULT: "default"}


def _tpu_product(a, b, level: str):
    """``a @ b`` (float32) as the TPU's MXU computes it at ``level``:
    'default' one pass of bf16 operands with float32 sums, 'high' bf16_3x
    (the two small products, then the large one), as
    tests/test_torch_precision.py holds the port's products."""

    def dot(x, y):
        return _JNP_MATMUL(x.astype(jnp.bfloat16), y.astype(jnp.bfloat16), preferred_element_type=jnp.float32)

    if level == "default":
        return dot(a, b)

    def lo(x):
        return x - x.astype(jnp.bfloat16).astype(jnp.float32)

    return (dot(a, lo(b)) + dot(lo(a), b)) + dot(a, b)


def _tpu_matmul(level: str):
    """``_tpu_product`` whose gradients are products at the same level, as
    JAX transposes a matmul at its precision (``b`` a weight matrix)."""

    @jax.custom_vjp
    def product(a, b):
        return _tpu_product(a, b, level)

    def bwd(res, g):
        a, b = res
        flat = a.reshape(-1, a.shape[-1])
        return _tpu_product(g, b.T, level), _tpu_product(flat.T, g.reshape(-1, g.shape[-1]), level)

    product.defvjp(lambda a, b: (product(a, b), (a, b)), bwd)
    return product


def _round_products_as_the_tpu(monkeypatch):
    """Every float32 ``jnp.matmul`` at 'default' or 'high' becomes
    ``_tpu_matmul``: XLA:CPU computes every precision level in float32
    (tests/test_stage_precision.py), so this is the JAX trainer's graph
    with its products rounded as on the TPU."""
    fns = {level: _tpu_matmul(level) for level in ("default", "high")}

    def matmul(a, b, precision=None, **kw):
        level = _LEVEL_NAMES[precision]
        if level == "highest" or jnp.bfloat16 in (a.dtype, b.dtype):
            return _JNP_MATMUL(a, b, precision=precision, **kw)
        return fns[level](a, b)

    monkeypatch.setattr(jnp, "matmul", matmul)


def _jax_grads_and_gains(params, batch):
    """(loss, the 16 gradients, apply's gains) of the JAX trainer, one jit."""

    def loss(p, *b):
        return jtrain.spectral_loss(p, *b), jnsnet2.apply(p, b[0])

    (value, gains), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, *map(jnp.asarray, batch))
    return float(value), _leaves(grads), np.asarray(gains, np.float64)


def _port_grads_and_gains(params, batch, level: str = "highest", io: str = "f32"):
    """(loss, the 16 gradients, apply's gains) of the port at a tier."""
    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)
    try:
        net = _port_net(params)
        loss, grads = _port_grads(net, batch)
        with torch.no_grad():
            gains = train.apply(net, torch.from_numpy(batch[0])).float().numpy()
    finally:
        precision.set_matmul_precision("highest")
        precision.set_io_dtype("f32")
    return loss, grads, gains


# level: (gains max, gains mean, each gradient's relative l2 distance)
TIER_BARS = {"high": (2e-6, 3e-7, 2e-5), "default": (2e-3, 2e-5, 5e-3)}


@pytest.mark.parametrize("level", sorted(TIER_BARS))
def test_precision_tiers_train_as_the_jax_trainer_does(level, monkeypatch):
    """FVAD_PRECISION=high and default: the port's trainer against the JAX
    trainer's graph (per-gate products at 'default', its split3 form) with
    every product, forward and in the gradients, rounded as the TPU rounds
    it (``_round_products_as_the_tpu``). Bars: on ``apply``'s gains the
    scoring forward's tier bars (tests/test_torch_precision.py: high max
    2e-6, mean 3e-7; default max 2e-3, mean 2e-5), the loss at rtol 1e-5,
    each gradient's relative l2 distance 2e-5 (high) or 5e-3 (default):
    float32 sums in other orders, which at 'default' now and then move an
    operand across a bf16 rounding step (seen: 3.8e-6 and 1.2e-3).
    Controls, the port at 'highest': at 'default' it fails the gains' mean
    bar and the gradients' bar; 'high' differs from float32 by less than
    the summation order does, so there every gradient of the port at
    'high' must be nearer to the reference than its float32 one."""
    params = _jax_params()
    batch = _batch(3)
    max_bar, mean_bar, grad_bar = TIER_BARS[level]
    jprecision.set_matmul_precision(level)
    _round_products_as_the_tpu(monkeypatch)
    try:
        want_loss, want, want_gains = _jax_grads_and_gains(params, batch)
    finally:
        jprecision.set_matmul_precision("highest")
        monkeypatch.undo()
    got_loss, got, gains = _port_grads_and_gains(params, batch, level)
    d = np.abs(gains - want_gains)
    assert d.max() <= max_bar and d.mean() <= mean_bar, (d.max(), d.mean())
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    dist = [_rel_l2(g, w) for g, w in zip(got, want)]
    assert max(dist) <= grad_bar, dict(zip(PARAM_NAMES, dist))
    _, f32, f32_gains = _port_grads_and_gains(params, batch)
    f32_dist = [_rel_l2(g, w) for g, w in zip(f32, want)]
    if level == "default":
        assert np.abs(f32_gains - want_gains).mean() > 4 * mean_bar and max(f32_dist) > 3 * grad_bar
    else:
        assert all(x < y for x, y in zip(dist, f32_dist)), (dist, f32_dist)


def _jax_apply_rounding_each_op(params, feats):
    """The JAX ``nsnet2.apply`` with each op rounded once: jitted with
    XLA's excess precision off (by default XLA:CPU keeps float32 between
    fused bf16 ops), and sigmoid and tanh computed in float32 and rounded
    (XLA:CPU expands a bf16 sigmoid into bf16 steps that round in
    between). Under bf16 storage each op then rounds once to bf16, as a
    bf16 op of PyTorch does: another rounding of the same graph."""
    sigmoid, tanh = jax.nn.sigmoid, jnp.tanh
    jax.nn.sigmoid = lambda x: sigmoid(x.astype(jnp.float32)).astype(x.dtype)
    jnp.tanh = lambda x: tanh(x.astype(jnp.float32)).astype(x.dtype)
    try:
        x = jnp.asarray(feats)
        fn = jax.jit(lambda p, f: jnsnet2.apply(p, f)).lower(params, x).compile({"xla_allow_excess_precision": False})
        return np.asarray(fn(params, x).astype(jnp.float32), np.float64)
    finally:
        jax.nn.sigmoid, jnp.tanh = sigmoid, tanh


def test_bf16_storage_trains_as_the_jax_trainer_does():
    """Under bf16 activation storage the JAX trainer trains (bf16 forward,
    float32 gradients of float32 parameters); so does the port.
    - ``apply``'s gains against the JAX graph with each op rounded once
      (``_jax_apply_rounding_each_op``) at the storage tier's bars of
      tests/test_torch_precision.py (max 4e-3, mean 2e-5; seen: equal bit
      for bit). Control: the port in float32 is off by more than 10x the
      mean bar.
    - The loss and the gradients against the jitted JAX trainer: the loss
      at rtol 2e-3 (bf16 keeps 8 bits; the loss is a mean over 5,152
      terms), each gradient within 5e-2 of its largest element, every one
      nonzero. bf16 rounds through the whole backward: two roundings of it
      differ by ~2e-2 in relative l2, about as far as either is from
      float32. Controls: the port's bf16 gradients are more than 1e-3 from
      its float32 ones in relative l2 on every array (two float32 orders
      differ by ~1e-6), and nearer to JAX's in sum over the 16 arrays than
      its float32 ones, by a factor 0.8 (seen: 0.66)."""
    params = _jax_params()
    batch = _batch(3)
    try:
        jprecision.set_io_dtype("bf16")
        want_loss, want, _ = _jax_grads_and_gains(params, batch)
        want_gains = _jax_apply_rounding_each_op(params, batch[0])
    finally:
        jprecision.set_io_dtype("f32")
    got_loss, got, gains = _port_grads_and_gains(params, batch, io="bf16")
    _, f32, f32_gains = _port_grads_and_gains(params, batch)
    d = np.abs(gains - want_gains)
    assert d.max() <= 4e-3 and d.mean() <= 2e-5, (d.max(), d.mean())
    assert np.abs(f32_gains - want_gains).mean() > 10 * 2e-5
    assert got_loss == pytest.approx(want_loss, rel=2e-3)
    for name, g, w in zip(PARAM_NAMES, got, want):
        assert g.dtype == np.float32 and np.max(np.abs(g)) > 0, name
        assert np.max(np.abs(g - w)) <= 5e-2 * np.max(np.abs(w)), (name, np.max(np.abs(g - w)), np.max(np.abs(w)))
    assert min(_rel_l2(g, f) for g, f in zip(got, f32)) > 1e-3
    dist = sum(_rel_l2(g, w) for g, w in zip(got, want))
    f32_dist = sum(_rel_l2(f, w) for f, w in zip(f32, want))
    assert dist <= 0.8 * f32_dist, (dist, f32_dist)


def test_int8_tier_is_refused():
    """The JAX trainer under the int8 tier gets zero gradients for fc_in
    and both GRUs (its rounding has no gradient); the port refuses it."""
    params = _jax_params()
    try:
        jprecision.set_quant("int8")
        _, grads = _jax_grads(params, _batch(4, b=1, t=2))
    finally:
        jprecision.set_quant("off")
    assert all(not np.any(g) for g in grads[:10]) and all(np.any(g) for g in grads[10:])
    net = _port_net(params)
    try:
        precision.set_quant("int8")
        with pytest.raises(ValueError, match="FVAD_QUANT=int8"):
            train.spectral_loss(net, *map(torch.from_numpy, _batch(4, b=2)))
        with pytest.raises(ValueError, match="FVAD_QUANT=int8"):
            train_app.main(["--synthetic", "2", "--steps", "1", "--batch", "1", "--frames", "4", "--device", "cpu"])
    finally:
        precision.set_quant("off")


def test_refuse_grad():
    """The guard every ctypes route calls: it raises only where autograd
    records and a tensor of the call requires grad (the CUDA wrappers'
    own cases are in tests/test_torch_cuda.py)."""
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    _build.refuse_grad("k", x, None)
    with pytest.raises(RuntimeError, match="nsnet2_train.apply"):
        _build.refuse_grad("k", x, w)
    with pytest.raises(RuntimeError, match="^k: "):
        _build.refuse_grad("k", x * w)
    with torch.no_grad():
        _build.refuse_grad("k", x, w)
    with torch.inference_mode():
        _build.refuse_grad("k", w)


def test_synth_batch_and_demo_steps():
    feats, n_re, n_im, c_re, c_im = train.synth_batch(torch.Generator().manual_seed(0), 3, 5)
    assert all(x.shape == (3, 5, 161) and x.dtype == torch.float32 for x in (feats, n_re, n_im, c_re, c_im))
    torch.testing.assert_close(feats, torch.log10(torch.clamp(n_re**2 + n_im**2, min=1e-12)), rtol=0, atol=0)
    net = nsnet2.init_params(torch.Generator().manual_seed(0))
    before = [p.clone() for p in net.parameters()]
    trained, losses = train.train_demo_steps(net, n_steps=6, batch=4, n_frames=8, learning_rate=3e-3)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(torch.equal(a, p) and not p.requires_grad for a, p in zip(before, net.parameters()))
    assert all(p.requires_grad for p in trained.parameters())


def test_train_checkpoint_round_trip(tmp_path):
    """save_train_state / load_train_state / latest_step: the parameters
    and Adam's state come back bit for bit; a structure or shape mismatch
    raises."""
    net = nsnet2.init_params(torch.Generator().manual_seed(1))
    trained, _ = train.train_demo_steps(net, n_steps=2, batch=2, n_frames=4)
    opt = torch.optim.Adam(trained.parameters())
    train.make_train_step(opt, trained)(train.synth_batch(torch.Generator().manual_seed(9), 2, 4))
    ck = str(tmp_path / "ck")
    assert checkpoint.latest_step(ck) is None
    checkpoint.save_train_state(ck, trained, opt, 7)
    assert checkpoint.latest_step(ck) == 7
    net2 = train.trainable(nsnet2.init_params(torch.Generator().manual_seed(2)))
    opt2 = torch.optim.Adam(net2.parameters())
    got_net, got_opt = checkpoint.load_train_state(ck, net2, opt2, 7)
    assert got_net is net2 and got_opt is opt2
    for p, q in zip(trained.parameters(), net2.parameters()):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt2.state[q][key]), key
    with pytest.raises(ValueError, match="structure"):
        other = torch.nn.Linear(2, 2)
        checkpoint.load_train_state(ck, other, torch.optim.Adam(other.parameters()), 7)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_train_state(ck, net2, opt2, 8)


# --------------------------------------------------------------------------- the CLI

BASE = ["--synthetic", "4", "--batch", "2", "--frames", "8", "--device", "cpu"]


def test_cli_writes_weights_the_jax_package_loads(tmp_path):
    out = str(tmp_path / "w.npz")
    assert train_app.main(BASE + ["--steps", "3", "--out", out]) == 0
    assert train_app.main.last_run["steps"] == 3
    net = nsnet2.load_npz(out)
    jp = jnsnet2.load_npz(out)
    for a, p in zip(_leaves(jp), net.parameters(), strict=True):
        assert a.dtype == np.float32 and a.tobytes() == p.numpy().tobytes()
    assert jp.gru1.linear_before_reset == jp.gru2.linear_before_reset == 1
    fresh = nsnet2.init_params(torch.Generator().manual_seed(0))
    assert not all(torch.equal(p, q) for p, q in zip(net.parameters(), fresh.parameters()))


def test_cli_trains_on_a_wav_pair(tmp_path):
    rng = np.random.default_rng(0)
    clean = (0.2 * rng.standard_normal((1, 48000))).astype(np.float32)
    noisy = clean + (0.05 * rng.standard_normal((1, 48000))).astype(np.float32)
    write_wav(str(tmp_path / "a.clean.wav"), clean, 48000)
    write_wav(str(tmp_path / "a.noisy.wav"), noisy, 48000)
    out = str(tmp_path / "w.npz")
    argv = ["--data", str(tmp_path), "--steps", "2", "--batch", "2", "--frames", "10", "--out", out, "--device", "cpu"]
    assert train_app.main(argv) == 0
    assert np.all(np.isfinite(train_app.main.last_run["losses"]))
    nsnet2.load_npz(out)
    # The examples: the JAX trainer's windows at atol 1e-4 (log10 features
    # and spectra of ~1e2 through one float32 STFT product).
    want = jtrain_app.load_pairs(str(tmp_path), 10)
    got = train_app.load_pairs(str(tmp_path), 10)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


def test_cli_onnx_out_loads_through_both_importers(tmp_path):
    out = str(tmp_path / "w.onnx")
    assert train_app.main(BASE + ["--steps", "2", "--device-data", "--out", out]) == 0
    got = onnx_import.load_nsnet2_onnx(out)
    want = jonnx.load_nsnet2_onnx(out)
    for name, a in zip(PARAM_NAMES, _leaves(want)):
        assert np.asarray(got[name]).tobytes() == a.tobytes(), name
    net = nsnet2.load(out)
    gains = train.apply(net, torch.from_numpy(_batch(0, b=2)[0]))
    assert torch.isfinite(gains).all()


def test_cli_eval_prints_the_jax_fields(tmp_path, capsys):
    """--eval prints one JSON line with the JAX trainer's fields, the
    numbers of ``evaluate`` on the saved weights."""
    out = str(tmp_path / "w.npz")
    argv = BASE + ["--steps", "2", "--out", out, "--eval", "--eval-pairs", "1", "--eval-seconds", "8"]
    assert train_app.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1])["denoise_quality"]
    assert set(rec) == {"pairs", "n_pairs", "seconds", "seed", "mean_si_sdr_impr_db"}
    assert rec["n_pairs"] == 1 and len(rec["pairs"]) == 1
    assert set(rec["pairs"][0]) == {"si_sdr_noisy_db", "si_sdr_denoised_db", "si_sdr_impr_db"}
    assert rec == dq.evaluate(nsnet2.load_npz(out), n_pairs=1, seconds=8.0, device="cpu")
    # An eval-only run from the checkpointless start writes nothing.
    capsys.readouterr()
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert train_app.main(["--steps", "0", "--eval", "--eval-pairs", "1", "--eval-seconds", "8", "--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    assert not os.path.exists(tmp_path / "nsnet2_weights.npz")


def test_cli_checkpoint_resume_reaches_the_step(tmp_path):
    ck = str(tmp_path / "ck")
    args = BASE + ["--out", str(tmp_path / "w.npz"), "--ckpt-dir", ck, "--ckpt-every", "1"]
    assert train_app.main(args + ["--steps", "2"]) == 0
    assert checkpoint.latest_step(ck) == 2
    assert train_app.main(args + ["--steps", "4"]) == 0
    assert checkpoint.latest_step(ck) == 4
    assert train_app.main.last_run["start_step"] == 2 and train_app.main.last_run["steps"] == 2


@pytest.mark.parametrize("device_data", [False, True])
def test_cli_resumed_run_matches_an_uninterrupted_one(tmp_path, device_data):
    """Batch draws are seeded per step, the checkpoint holds Adam's state:
    an interrupted and resumed run gives the same weights bit for bit."""
    base = BASE + (["--device-data"] if device_data else [])
    straight = str(tmp_path / "straight.npz")
    assert train_app.main(base + ["--steps", "4", "--out", straight]) == 0
    ck = str(tmp_path / "ck")
    resumed = str(tmp_path / "resumed.npz")
    assert train_app.main(base + ["--steps", "2", "--out", resumed, "--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    assert train_app.main(base + ["--steps", "4", "--out", resumed, "--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    for p, q in zip(nsnet2.load_npz(straight).parameters(), nsnet2.load_npz(resumed).parameters()):
        assert torch.equal(p, q)


def test_cli_draws_the_jax_clis_batches(tmp_path, monkeypatch):
    """The first batches the port's CLI feeds its step are the JAX CLI's
    (the same per-step numpy draws over the same WAV windows), at the
    windows' atol 1e-4. Both steps are replaced by recorders."""
    rng = np.random.default_rng(1)
    clean = (0.2 * rng.standard_normal((1, 48000))).astype(np.float32)
    write_wav(str(tmp_path / "a.clean.wav"), clean, 48000)
    write_wav(str(tmp_path / "a.noisy.wav"), clean + 0.05 * rng.standard_normal((1, 48000)).astype(np.float32), 48000)
    seen = {"jax": [], "port": []}

    def jax_step(opt, mesh=None):
        def step(params, opt_state, batch):
            seen["jax"].append([np.asarray(x) for x in batch])
            return params, opt_state, jnp.float32(0.0)
        return step

    def port_step(opt, net, mesh=None):
        def step(batch):
            seen["port"].append([x.numpy() for x in batch])
            return torch.zeros(())
        return step

    monkeypatch.setattr(jtrain_app.nsnet2_train, "make_train_step", jax_step)
    monkeypatch.setattr(train_app.nsnet2_train, "make_train_step", port_step)
    # batch 8: the JAX CLI rounds the batch up to its data axis (8 CPU devices here)
    common = ["--data", str(tmp_path), "--steps", "3", "--batch", "8", "--frames", "10", "--seed", "5"]
    assert jtrain_app.main(common + ["--out", str(tmp_path / "j.npz")]) == 0
    assert train_app.main(common + ["--out", str(tmp_path / "p.npz"), "--device", "cpu"]) == 0
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for got, want in zip(seen["port"], seen["jax"]):
        for a, b in zip(got, want):
            assert a.shape == b.shape == (8, 10, 161)
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_cli_refusals():
    # --tp 2 on the one CPU device: the JAX data_model_mesh's refusal.
    with pytest.raises(ValueError, match="1 devices not divisible by model axis 2"):
        train_app.main(BASE + ["--steps", "1", "--tp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_app.main(["--synthetic", "2", "--steps", "1"])
