"""The port's NSNet2 and its GRU-stack recurrence against the JAX package.

Both packages get the same weights: the packaged demo weights, and the JAX
package's random init carried over with ``nsnet2.from_numpy``. Tolerance
atol = 1e-5 (float32 products summed in different orders over 54 steps).
The CUDA kernel itself is tested on a GPU by test_torch_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.models import nsnet2_pallas
from formula_vad_tpu.models import onnx_import as jonnx
from formula_vad_tpu.models.registry import DEMO_WEIGHTS
from formula_vad_tpu_torch.models import nsnet2, nsnet2_cuda, registry

ATOL = 1e-5


def _flat(params) -> dict:
    """JAX NSNet2Params -> the flat numpy dict ``save_npz`` writes."""
    flat = {}
    for name in ("fc_in", "ff1", "ff2", "out"):
        flat[f"{name}_w"] = np.asarray(getattr(params, f"{name}_w"))
        flat[f"{name}_b"] = np.asarray(getattr(params, f"{name}_b"))
    for name in ("gru1", "gru2"):
        g = getattr(params, name)
        for key in ("wi", "wh", "bi", "bh"):
            flat[f"{name}_{key}"] = np.asarray(getattr(g, key))
        flat[f"{name}_lbr"] = np.int32(g.linear_before_reset)
    return flat


@pytest.fixture(scope="module", params=["demo", "init5"])
def pair(request):
    """(JAX params, port module) holding the same weights."""
    if request.param == "demo":
        jp = jnsnet2.load_npz(DEMO_WEIGHTS)
        return jp, nsnet2.load_npz(DEMO_WEIGHTS)
    jp = jnsnet2.init_params(jax.random.PRNGKey(5))
    return jp, nsnet2.from_numpy(_flat(jp))


def _feats(n, t=54, seed=0):
    return np.random.default_rng(seed).normal(-3.0, 1.5, (n, t, 161)).astype(np.float32)


def test_weights_carried_over(pair):
    jp, net = pair
    flat = _flat(jp)
    assert net.gru1.linear_before_reset == int(flat["gru1_lbr"])
    for name in ("fc_in", "ff1", "ff2", "out"):
        assert getattr(net, name).w.numpy().tobytes() == flat[f"{name}_w"].astype(np.float32).tobytes()
    for key in ("wi", "wh", "bi", "bh"):
        assert getattr(net.gru2, key).numpy().tobytes() == flat[f"gru2_{key}"].astype(np.float32).tobytes()


def test_apply_matches_jax(pair):
    jp, net = pair
    x = _feats(7)
    want = np.asarray(jnsnet2.apply(jp, jnp.asarray(x), out_frames=50))
    with torch.inference_mode():
        got = net(torch.from_numpy(x), out_frames=50).numpy()
    assert got.shape == want.shape == (7, 50, 161)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_apply_leading_batch_shape(pair):
    jp, net = pair
    x = _feats(6, t=10, seed=1).reshape(2, 3, 10, 161)
    want = np.asarray(jnsnet2.apply(jp, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rows", [5, nsnet2_pallas.ROW_TILE + 3])
def test_gru_stack_reference_matches_pallas(pair, rows):
    """Row counts that do not fill the TPU kernel's 256-row tile."""
    jp, net = pair
    t = 54 if rows < 100 else 6
    gi1 = (np.random.default_rng(rows).standard_normal((rows, t, 1200)) * 0.8).astype(np.float32)
    want = np.asarray(nsnet2_pallas.gru_stack_pallas(jp, jnp.asarray(gi1), interpret=True))
    got = nsnet2_cuda.gru_stack_reference(net, torch.from_numpy(gi1)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_gru_stack_on_cpu_runs_plain_version(pair):
    _, net = pair
    gi1 = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 5, 1200)).astype(np.float32))
    before = nsnet2_cuda.gru_stack.launches
    assert torch.equal(nsnet2_cuda.gru_stack(net, gi1), nsnet2_cuda.gru_stack_reference(net, gi1))
    assert nsnet2_cuda.gru_stack.launches == before


def test_lbr0_plain_version_matches_jax():
    """linear_before_reset = 0 weights run through the plain version on CPU
    (the CUDA kernel refuses them)."""
    jp = jnsnet2.init_params(jax.random.PRNGKey(9))
    jp = dataclasses.replace(
        jp,
        gru1=dataclasses.replace(jp.gru1, linear_before_reset=0),
        gru2=dataclasses.replace(jp.gru2, linear_before_reset=0),
    )
    net = nsnet2.from_numpy(_flat(jp))
    assert net.gru1.linear_before_reset == 0
    x = _feats(4, t=12, seed=2)
    want = np.asarray(jnsnet2.apply(jp, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_lbr0_forward_runs_the_plain_loop_on_any_device(monkeypatch):
    """NSNet2.forward sends lbr = 0 weights to the plain per-step loop, not
    to the kernel wrapper (which refuses them on the card), in the float
    tier and in the int8 tier's fallback."""
    from formula_vad_tpu_torch.ops import precision

    def no_kernel(*args, **kw):
        raise AssertionError("gru_stack called for lbr = 0 weights")

    monkeypatch.setattr(nsnet2_cuda, "gru_stack", no_kernel)
    jp = jnsnet2.init_params(jax.random.PRNGKey(9))
    net = nsnet2.from_numpy(dict(_flat(jp), gru2_lbr=np.int32(0)))
    x = torch.from_numpy(_feats(3, t=8, seed=4))
    with torch.inference_mode():
        want = net(x)
        precision.set_quant("int8")
        try:
            again = net(x)
        finally:
            precision.set_quant("off")
    assert torch.equal(again, want)


def test_registry_specs(tmp_path):
    load = functools.partial(registry.load_denoiser, device="cpu")
    demo = load(None)
    assert torch.equal(demo.gru1.wh, load("demo").gru1.wh)
    a = load("random", seed=3)
    b = load("random", seed=3)
    assert torch.equal(a.ff2.w, b.ff2.w) and not torch.equal(a.ff2.w, load("random", seed=4).ff2.w)
    assert float(a.ff2.w.abs().max()) <= float(np.sqrt(6.0 / 1200)) + 1e-7
    # The rest of the registry loads: an ONNX file through the importer (the
    # demo weights written by the JAX writer, back bit for bit), the gate
    # with its defaults and with explicit fields.
    path = tmp_path / "model.onnx"
    path.write_bytes(jonnx.export_nsnet2_onnx(jnsnet2.load_npz(DEMO_WEIGHTS)))
    assert all(torch.equal(a, b) for a, b in zip(load(str(path)).parameters(), demo.parameters()))
    gate = load("spectral_gate")
    assert (gate.quantile, gate.alpha, gate.floor) == (0.1, 1.5, 0.1)
    gate = load("spectral_gate:0.2,0.9,0.1")
    assert (gate.quantile, gate.alpha, gate.floor) == (0.2, 0.9, 0.1)


def test_registry_defaults_to_the_card(monkeypatch):
    """Without ``device="cpu"`` the model goes to the GPU, and without one
    visible the call raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.load_denoiser("demo")
    assert registry.load_denoiser("demo", device=torch.device("cpu")).fc_in.w.device.type == "cpu"


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("n_rows", [1, 16, 37, 1680, 1690, 4000])
def test_gru_launch_plan_covers_every_pair_once(n_rows, sm_count):
    """The CUDA kernel's tiling, computed on the host: every (row, unit)
    pair in exactly one tile, every tile in exactly one CTA, the grid no
    larger than the card holds at once (one CTA per SM), tiles no larger
    than the kernel's register tile."""
    plan = nsnet2_cuda.launch_plan(n_rows, sm_count, 1)
    assert plan.grid <= sm_count and plan.tiles == plan.row_groups * plan.unit_groups
    assert 1 <= plan.row_tile <= nsnet2_cuda.ROW_TILE_MAX and plan.unit_groups * plan.unit_tile == nsnet2.HIDDEN
    cover = np.zeros((n_rows, nsnet2.HIDDEN), np.int32)
    seen = []
    for block in range(plan.grid):
        for tile in plan.block_tiles(block):
            rows, units = plan.tile_span(tile)
            assert len(rows) > 0
            cover[rows.start : rows.stop, units.start : units.stop] += 1
            seen.append(tile)
    assert sorted(seen) == list(range(plan.tiles))
    assert (cover == 1).all()


@pytest.mark.parametrize("sm_count, n_rows, waves", [(132, 1680, 1), (132, 4000, 3), (114, 1680, 2)])
def test_gru_launch_plan_fills_the_last_wave(sm_count, n_rows, waves):
    """The batched scoring shape (1,680 rows) on 132 SMs is one wave of at
    least 120 tiles; on more rows or fewer SMs every wave, the last too,
    fills at least 90% of the SMs."""
    plan = nsnet2_cuda.launch_plan(n_rows, sm_count, 1)
    assert -(-plan.tiles // plan.grid) == waves
    last = plan.tiles - (waves - 1) * plan.grid
    assert last >= 0.9 * sm_count
    if (sm_count, n_rows) == (132, 1680):
        assert plan.tiles == plan.grid == 130 and plan.row_tile == 130


def test_gru_launch_plan_scales_with_blocks_per_sm():
    plan = nsnet2_cuda.launch_plan(1680, 132, 2)
    assert plan.grid <= 264 and plan.tiles - plan.grid * (-(-plan.tiles // plan.grid) - 1) >= 240
    with pytest.raises(ValueError):
        nsnet2_cuda.launch_plan(0, 132, 1)


def test_gru_packed_weights_layout_and_cache():
    """The kernel's weight layout: [unit group, k, gate * 40 + unit] holds
    column gate * 400 + group * 40 + unit; the cache repacks after an
    in-place load (same data_ptr, new version)."""
    net = registry.load_denoiser("random", seed=3, device="cpu")
    w = net.gru2.wi
    packed = nsnet2_cuda.pack(w)
    assert packed.shape == (10, 400, 120) and packed.is_contiguous()
    ug, k, g, u = np.meshgrid(np.arange(10), np.arange(400), np.arange(3), np.arange(40), indexing="ij")
    assert torch.equal(packed.reshape(10, 400, 3, 40), w[k, g * 400 + ug * 40 + u])
    first = nsnet2_cuda.packed_weights(net)
    assert nsnet2_cuda.packed_weights(net) is first
    demo = registry.load_denoiser("demo", device="cpu")
    net.load_state_dict(demo.state_dict())
    again = nsnet2_cuda.packed_weights(net)
    assert again is not first and torch.equal(again[1], nsnet2_cuda.pack(demo.gru2.wi))

