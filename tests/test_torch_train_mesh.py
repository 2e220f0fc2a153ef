"""The trainer's ("data", "model") grid in the port (``train/nsnet2_train.py``:
``param_pspecs``, ``shard_params``, ``shard_batch``, the sharded forward and
step; ``apps/train.py --tp``; ``parallel/mesh.py::DataModelMesh``) against
the unsharded port and the JAX package's mesh trainer, on the CPU.

The port's grid lies in one process and its devices may repeat: ``["cpu"]
* n`` stands in for the JAX tests' virtual CPU devices, of which conftest
makes 8. Weights are the JAX ``init_params`` with random biases
(``test_torch_train._jax_params``), batches numpy draws
(``test_torch_train._batch``); B = 4, T = 8, full width. Tolerances, each
stated with its test: sharding splits no dot product but ff2's (the
all-reduce of its row shards), so the sharded forward and gradients differ
from the unsharded port's only by GEMM blocking and that one sum order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from formula_vad_tpu.apps import train as jtrain_app
from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.parallel import mesh as jmesh
from formula_vad_tpu.train import nsnet2_train as jtrain
from formula_vad_tpu_torch.apps import train as train_app
from formula_vad_tpu_torch.models import nsnet2
from formula_vad_tpu_torch.ops import precision
from formula_vad_tpu_torch.parallel import mesh as mesh_lib
from formula_vad_tpu_torch.train import nsnet2_train as train
from formula_vad_tpu_torch.utils import checkpoint
from test_torch_train import (LR, PARAM_NAMES, _batch, _jax_params, _jax_steps, _leaves, _params_close, _port_net,
                              _rel_l2)

B, T = 4, 8
GRIDS = [(1, 2), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensor ops, for which torch's intra-op threads only add
    overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rows: int, cols: int) -> mesh_lib.DataModelMesh:
    return mesh_lib.data_model_mesh(cols, ["cpu"] * (rows * cols))


def _grads(net, batch) -> tuple[float, list[np.ndarray]]:
    """The loss and the 16 gradients, unsharded (a sharded net's gathered;
    backward has summed them over its data rows)."""
    tensors = tuple(map(torch.from_numpy, batch))
    if isinstance(net, train.ShardedNSNet2):
        loss = net.loss(tensors)
        loss.backward()
        return loss.item(), [g.numpy() for g in net.gathered_grads().values()]
    loss = train.spectral_loss(net, *tensors)
    loss.backward()
    return loss.item(), [p.grad.numpy().copy() for p in net.parameters()]


# --------------------------------------------------------------------------- the layout


def test_param_pspecs_match_jax():
    """The sharded dimension of each of the 16 leaves, in leaf order:
    JAX's P(None, "model") is 1, P("model") and P("model", None) 0, P()
    None."""
    specs = jax.tree_util.tree_leaves(jtrain.param_pspecs(), is_leaf=lambda x: isinstance(x, P))
    want = [tuple(s).index("model") if "model" in tuple(s) else None for s in specs]
    got = train.param_pspecs()
    assert len(want) == len(got) == 16
    assert list(got.values()) == want
    assert list(got) == [name for name, _ in nsnet2.NSNet2().named_parameters()]


@pytest.mark.parametrize("tp", [1, 2, 4, 5])
def test_shard_then_gather_is_bit_for_bit(tp):
    """The shards gather back to the network bit for bit; GRU shards are
    unit-major (shard j: z, r, n columns of its units); the shards are held
    once whatever the data axis (13 sharded leaves a column, the 3
    replicated ones in column 0 only)."""
    net = _port_net(_jax_params())
    sharded = train.shard_params(net, _grid(2, tp))
    for p, q in zip(net.parameters(), sharded.gather().parameters(), strict=True):
        assert p.detach().numpy().tobytes() == q.numpy().tobytes()
    assert len(sharded.parameters()) == 13 * tp + 3
    u = 400 // tp
    for j, shards in enumerate(sharded.shards):
        want = torch.cat([net.gru1.wi[:, g * 400 + j * u: g * 400 + (j + 1) * u] for g in range(3)], 1)
        assert torch.equal(shards["gru1.wi"], want)
        assert shards["ff2.w"].shape == (600 // tp, 600) and shards["fc_in.w"].shape == (161, u)
        assert ("out.w" in shards) == (j == 0)


def test_uneven_and_multi_process_grids_are_refused():
    net = _port_net(_jax_params())
    with pytest.raises(ValueError, match="does not divide"):
        train.shard_params(net, _grid(1, 3))
    grid = mesh_lib.DataModelMesh(_grid(1, 2).grid, n_processes=2, rank=0)
    with pytest.raises(ValueError, match="JAX CLI trains in one"):
        train.shard_params(net, grid)


# --------------------------------------------------------------------------- forward and gradients


@pytest.mark.parametrize("lbr", [1, 0])
@pytest.mark.parametrize("shape", GRIDS)
def test_sharded_forward(shape, lbr):
    """The sharded forward against the unsharded port's, max |dgain| <=
    1e-6, and against the JAX ``nsnet2.apply`` at the unsharded test's
    bar (atol 1e-5; tests/test_torch_train.py)."""
    params = _jax_params(lbr)
    feats = _batch(1)[0]
    net = _port_net(params)
    with torch.no_grad():
        want = train.apply(net, torch.from_numpy(feats)).numpy()
        got = train.shard_params(net, _grid(*shape)).apply(torch.from_numpy(feats)).numpy()
    assert got.shape == (B, T, 161)
    assert np.max(np.abs(got - want)) <= 1e-6
    np.testing.assert_allclose(got, np.asarray(jnsnet2.apply(params, jnp.asarray(feats))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("lbr", [1, 0])
def test_sharded_gradients_on_2x2(lbr):
    """The loss at rtol 1e-6 and each gathered gradient within 1e-5 of
    that array's largest element, against the unsharded port on the same
    batch; every gradient nonzero."""
    params = _jax_params(lbr)
    batch = _batch(2)
    want_loss, want = _grads(_port_net(params), batch)
    got_loss, got = _grads(train.shard_params(_port_net(params), _grid(2, 2)), batch)
    assert got_loss == pytest.approx(want_loss, rel=1e-6)
    for name, g, w in zip(PARAM_NAMES, got, want):
        scale = np.max(np.abs(w))
        assert scale > 0, name
        assert np.max(np.abs(g - w)) <= 1e-5 * scale, (name, np.max(np.abs(g - w)), scale)


# tier: (matmul level, activation storage)
TIERS = {"default": ("default", "f32"), "bf16": ("highest", "bf16")}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tiers_on_a_1x2_grid(tier):
    """FVAD_PRECISION=default and FVAD_IO_DTYPE=bf16: a (1, 2) step's
    loss and gradients against the unsharded port's at the same tier, the
    loss at rtol 1e-4 and each gradient's relative l2 within 1e-2. Every
    product keeps its stage and level; under bf16 storage ff2's row shards
    sum in float32 and round once. Readings on this batch: the losses equal
    (relative difference 0) in both tiers; the largest gradient relative l2
    4.4e-4 at default and 5.1e-3 under bf16 storage (a float32 sum in
    another order now and then moves an operand across a bf16 rounding
    step)."""
    level, io = TIERS[tier]
    params = _jax_params()
    batch = _batch(3)
    precision.set_matmul_precision(level)
    precision.set_io_dtype(io)
    try:
        want_loss, want = _grads(_port_net(params), batch)
        got_loss, got = _grads(train.shard_params(_port_net(params), _grid(1, 2)), batch)
    finally:
        precision.set_matmul_precision("highest")
        precision.set_io_dtype("f32")
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    dist = [_rel_l2(g, w) for g, w in zip(got, want)]
    assert max(dist) <= 1e-2, dict(zip(PARAM_NAMES, dist))
    assert all(np.max(np.abs(g)) > 0 for g in got)


# --------------------------------------------------------------------------- full steps


@pytest.fixture(scope="module")
def jax_mesh_steps():
    """The JAX trainer's step on a 2 x 2 mesh of the session's virtual CPU
    devices, compiled once (weights and Adam state are jit arguments)."""
    mesh = jmesh.data_model_mesh(n_model=2, devices=jax.devices()[:4])
    opt = optax.adam(LR)
    return mesh, opt, jtrain.make_train_step(opt, mesh)


def test_three_steps_match_jax_on_a_2x2_mesh(jax_mesh_steps):
    """Three full steps on the port's (2, 2) grid against JAX's
    ``make_train_step(optax.adam(LR), mesh)`` on a 2 x 2 mesh, the same
    parameters and numpy batches: the losses at rtol 1e-5, then the
    gathered parameters (``_params_close``, 3 steps apart). The state
    starts unsharded (``train_state_from_numpy``) and is laid out over the
    grid (``shard_train_state``)."""
    mesh, opt, step = jax_mesh_steps
    params = _jax_params()
    batches = [_batch(10 + i) for i in range(3)]
    jp = jtrain.shard_params(jax.tree_util.tree_map(jnp.array, params), mesh)
    state = opt.init(jp)
    want_losses = []
    for b in batches:
        jp, state, loss = step(jp, state, tuple(map(jnp.asarray, b)))
        want_losses.append(float(loss))
    zeros = [np.zeros_like(a) for a in _leaves(params)]
    net, adam = train.train_state_from_numpy(_leaves(params), zeros, zeros, 0, learning_rate=LR)
    sharded, sopt = train.shard_train_state(net, adam, _grid(2, 2))
    port_step = train.make_train_step(sopt, sharded, sharded.mesh)
    got_losses = []
    for b in batches:
        got_losses.append(float(port_step(tuple(map(torch.from_numpy, b)))))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    _params_close(sharded.gather(), jp, 3)


def test_a_jax_state_carried_across_continues_on_the_grid():
    """JAX takes 2 unsharded steps; the port carries its parameters and
    Adam state across (``train_state_from_numpy``), lays them out over a
    (2, 2) grid (``shard_train_state``) and takes step 3; against JAX's 3
    steps: the third loss at rtol 1e-5, the parameters one step apart
    (``_params_close``)."""
    params = _jax_params()
    batches = [_batch(20 + i) for i in range(3)]
    two, state, _ = _jax_steps(params, batches[:2])
    three, _, want_losses = _jax_steps(params, batches)
    adam = state[0]
    net, opt = train.train_state_from_numpy(_leaves(two), _leaves(adam.mu), _leaves(adam.nu), int(adam.count),
                                            learning_rate=LR)
    sharded, sopt = train.shard_train_state(net, opt, _grid(2, 2))
    assert all(float(sopt.state[p]["step"]) == 2 for p in sharded.parameters())
    got = float(train.make_train_step(sopt, sharded, sharded.mesh)(tuple(map(torch.from_numpy, batches[2]))))
    assert got == pytest.approx(want_losses[2], rel=1e-5)
    _params_close(sharded.gather(), three, 1)


def test_demo_steps_on_a_grid_match_unsharded():
    """``train_demo_steps(mesh=...)`` as JAX's sharded-against-unsharded
    test holds it (tests/test_train_and_entry.py): two steps on a (2, 2)
    grid, the losses at rtol 1e-4 of the unsharded ones and the trained
    ff2.w within 1e-5; the trained copy comes back unsharded with
    gradients on."""
    net = nsnet2.init_params(torch.Generator().manual_seed(1))
    p1, l1 = train.train_demo_steps(net, n_steps=2, batch=4, n_frames=8)
    p2, l2 = train.train_demo_steps(net, n_steps=2, batch=4, n_frames=8, mesh=_grid(2, 2))
    np.testing.assert_allclose(l1, l2, rtol=1e-4)
    assert float((p1.ff2.w - p2.ff2.w).detach().abs().max()) <= 1e-5
    assert all(p.requires_grad for p in p2.parameters())


# --------------------------------------------------------------------------- checkpoints and the CLI

BASE = ["--synthetic", "8", "--frames", "8", "--device", "cpu"]


@pytest.fixture
def four_cpus(monkeypatch):
    """The CLI's grid over 4 CPU devices (the JAX tests' virtual devices)."""
    monkeypatch.setattr(train_app, "grid_devices", lambda dev: [torch.device("cpu")] * 4)


def test_cli_tp2_writes_weights_the_jax_package_loads(tmp_path, four_cpus):
    """``--tp 2`` on a 2 x 2 grid, as tests/test_train_cli_and_state.py
    runs the JAX CLI: the weights load in the JAX package with fc_in_w
    (161, 400), bit for bit with the port's load; batch 3 trains as 4."""
    out = str(tmp_path / "w.npz")
    assert train_app.main(BASE + ["--steps", "3", "--batch", "3", "--tp", "2", "--out", out]) == 0
    run = train_app.main.last_run
    assert run["grid"] == {"data": 2, "model": 2} and run["batch"] == 4 and np.all(np.isfinite(run["losses"]))
    jp = jnsnet2.load(out)
    assert np.asarray(jp.fc_in_w).shape == (161, 400)
    for a, p in zip(_leaves(jp), nsnet2.load_npz(out).parameters(), strict=True):
        assert a.tobytes() == p.numpy().tobytes()


@pytest.mark.parametrize("tp", [1, 2])
def test_cli_rounds_the_batch_up_as_the_jax_cli(tmp_path, monkeypatch, tp):
    """On 8 devices the batch is rounded up to the data axis as the JAX
    CLI rounds it (``pad_batch`` of its mesh)."""
    monkeypatch.setattr(train_app, "grid_devices", lambda dev: [torch.device("cpu")] * 8)
    jax_mesh = jmesh.data_model_mesh(tp)
    for batch in (3, 5):
        argv = BASE + ["--steps", "0", "--batch", str(batch), "--tp", str(tp), "--out", str(tmp_path / "w.npz")]
        assert train_app.main(argv) == 0
        assert train_app.main.last_run["batch"] == jmesh.pad_batch(batch, jax_mesh), batch
        assert train_app.main.last_run["grid"] == dict(jax_mesh.shape)


def test_cli_tp2_resumes_bit_for_bit_and_loads_at_tp1(tmp_path, monkeypatch, four_cpus):
    """A tp = 2 run stopped at a checkpoint and resumed at tp = 2 writes
    the straight run's weights bit for bit (the pool staged, each row's
    batch gathered on its device); the tp = 2 checkpoint (the unsharded
    format) loads into an unsharded network with identical parameters and
    Adam steps, and an unsharded run's checkpoint resumes at tp = 2."""
    base = BASE + ["--batch", "4", "--device-data"]
    straight, resumed, ck = str(tmp_path / "s.npz"), str(tmp_path / "r.npz"), str(tmp_path / "ck")
    tp2 = ["--tp", "2"]
    assert train_app.main(base + tp2 + ["--steps", "4", "--out", straight]) == 0
    assert train_app.main(base + tp2 + ["--steps", "2", "--out", resumed, "--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    assert train_app.main(base + tp2 + ["--steps", "4", "--out", resumed, "--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    assert train_app.main.last_run["start_step"] == 2
    for p, q in zip(nsnet2.load_npz(straight).parameters(), nsnet2.load_npz(resumed).parameters()):
        assert torch.equal(p, q)
    net = train.trainable(nsnet2.NSNet2())
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    checkpoint.load_train_state(ck, net, opt, 4)
    for p, q in zip(net.parameters(), nsnet2.load_npz(resumed).parameters()):
        assert torch.equal(p.detach(), q)
    assert all(float(opt.state[p]["step"]) == 4 for p in net.parameters())
    ck1 = str(tmp_path / "ck1")
    with monkeypatch.context() as one_device:
        one_device.setattr(train_app, "grid_devices", lambda dev: [dev])
        assert train_app.main(base + ["--steps", "2", "--out", resumed, "--ckpt-dir", ck1, "--ckpt-every", "2"]) == 0
        assert train_app.main.last_run["grid"] is None
    assert train_app.main(base + tp2 + ["--steps", "4", "--out", resumed, "--ckpt-dir", ck1]) == 0
    assert train_app.main.last_run["start_step"] == 2 and train_app.main.last_run["grid"] == {"data": 2, "model": 2}


def test_cli_tp2_on_one_cpu_device_raises():
    """As the JAX ``data_model_mesh`` refuses it."""
    with pytest.raises(ValueError, match="1 devices not divisible by model axis 2"):
        train_app.main(BASE + ["--steps", "1", "--batch", "2", "--tp", "2"])
    with pytest.raises(ValueError, match="1 devices not divisible by model axis 2"):
        jmesh.data_model_mesh(2, jax.devices()[:1])
