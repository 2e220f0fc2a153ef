"""NSNet2 training: the differentiable forward, the loss and the train step
(port of ``formula_vad_tpu/train/nsnet2_train.py``).

The JAX trainer differentiates ``nsnet2.apply``, a layer-by-layer
``lax.scan`` that runs outside any Pallas kernel, with
``jax.value_and_grad`` and steps optax's Adam. Here the same network runs
as PyTorch ops (``apply``), autograd computes the gradient and
``torch.optim.Adam`` steps it. The scoring path's recurrence kernels
(``models/nsnet2_cuda.py``, ``nsnet2_gates_cuda.py``, the int8 products)
are forward-only ctypes launches that autograd cannot see; they refuse a
call that would need a gradient (``_build.refuse_grad``), so training
never goes through them.

Every product goes through ``ops/precision.matmul`` with the JAX stages
(fc_in, gru_i, gru_h, ff), so ``FVAD_PRECISION`` and bf16 activation
storage (``FVAD_IO_DTYPE=bf16``) act as in the JAX trainer. The int8 tier
(``FVAD_QUANT=int8``) is refused: its rounding has no gradient, and the
JAX trainer under it gets zero gradients for fc_in and both GRUs while the
head trains on.

The ("data", "model") grid (``parallel/mesh.py::DataModelMesh``, in one
process, as the JAX CLI trains in one) runs the JAX trainer's Megatron
layout (``param_pspecs``): fc_in, both GRUs' gate kernels and ff1
column-sharded over "model", ff2 row-sharded, so that the FF pair needs
one all-reduce, ``ff2.b`` and ``out`` replicated; the batch is split over
"data" (``shard_batch``). A GRU's columns are sharded by hidden unit: shard
j holds the z, r and n columns of its units, so each step gathers only the
400-wide h (and, for linear_before_reset = 0, r * h), where JAX's
contiguous column split of the fused [400, 1200] would gather the gate
pre-activations. The collectives are in-process tensor ops that autograd
records: an all-gather moves each shard with ``.to(device)`` and joins
them, an all-reduce sums. The shards are held once, on data row 0's
devices; each row's forward moves them to its own with ``.to``, so
backward sums the rows' gradients into them (the all-reduce over "data")
and one ``torch.optim.Adam`` steps them (``make_train_step``).
Checkpoints and saved weights are in the unsharded layout
(``ShardedNSNet2.gather``, ``gathered_state``).
"""

from __future__ import annotations

import copy
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.nsnet2 import FF1, HIDDEN, N_BINS, NSNet2
from ..models.nsnet2_cuda import _gates, gru_stack_reference
from ..ops import precision
from ..parallel.mesh import DataModelMesh

COMPRESSION = 0.3  # spectral compression exponent (DNS-Challenge loss)
ALPHA = 0.3  # complex-loss weight


def check_tier() -> None:
    """Refuse a tier that cannot train (``ValueError`` naming its switch)."""
    if precision.quant_int8():
        raise ValueError(
            "FVAD_QUANT=int8 cannot train: the int8 tier's rounding has no gradient (the JAX trainer under it "
            "gets zero gradients for fc_in and both GRUs); train in float and quantize the trained weights"
        )


def trainable(net: NSNet2) -> NSNet2:
    """Turn gradients on for every parameter of ``net`` (they are off as
    loaded) and return it."""
    for p in net.parameters():
        p.requires_grad_(True)
    return net


def apply(net: NSNet2, features: torch.Tensor) -> torch.Tensor:
    """features [..., T, 161] -> gains [..., T, 161], from h = 0: the port of
    the JAX ``nsnet2.apply`` that its trainer differentiates, in PyTorch ops
    that autograd records. fc_in, then layer 1's input projection over the
    whole sequence (stage gru_i), then the layer-by-layer time loop of the
    scoring path's plain version (``nsnet2_cuda.gru_stack_reference``, the
    port of the JAX ``gru_cell_pre`` / ``gru_cell`` loop at the gru_i and
    gru_h levels), then the head. Under bf16 activation storage the
    features, the weights and the state are cast to bf16 as the JAX package
    casts them (the casts pass the gradient back). On a grid:
    ``ShardedNSNet2.apply``."""
    check_tier()
    cast = precision.io_cast
    lead, t = features.shape[:-2], features.shape[-2]
    x = net.fc_in(cast(features.reshape((-1, t, N_BINS))))
    gi1 = precision.matmul(x, cast(net.gru1.wi), "gru_i") + cast(net.gru1.bi)  # [N, T, 1200]
    gains = net.head(gru_stack_reference(net, gi1))
    return gains.reshape(lead + gains.shape[-2:])


def spectral_loss(net: NSNet2, feats, noisy_re, noisy_im, clean_re, clean_im) -> torch.Tensor:
    """Compressed spectral MSE, magnitude and complex terms (Braun & Tashev):
    feats [B, T, 161] log-power features of the noisy audio, the spectra
    [B, T, 161] each. On a grid: ``ShardedNSNet2.loss``."""
    return _compressed_mse(apply(net, feats), noisy_re, noisy_im, clean_re, clean_im)


def _compressed_mse(gains, noisy_re, noisy_im, clean_re, clean_im) -> torch.Tensor:
    est_re, est_im = noisy_re * gains, noisy_im * gains
    eps = 1e-9
    est_mag = torch.sqrt(est_re**2 + est_im**2 + eps)
    clean_mag = torch.sqrt(clean_re**2 + clean_im**2 + eps)
    est_c = est_mag**COMPRESSION
    clean_c = clean_mag**COMPRESSION
    mag_loss = torch.mean((est_c - clean_c) ** 2)
    # phase-aware term on compressed complex spectra
    scale_e = est_c / est_mag
    scale_s = clean_c / clean_mag
    cplx = torch.mean((est_re * scale_e - clean_re * scale_s) ** 2 + (est_im * scale_e - clean_im * scale_s) ** 2)
    return (1.0 - ALPHA) * mag_loss + ALPHA * cplx


# ---------------------------------------------------------------------------
# The ("data", "model") grid


def param_pspecs() -> dict[str, Optional[int]]:
    """The Megatron tensor-parallel layout (JAX ``param_pspecs``): for each
    parameter of ``NSNet2.named_parameters()``, in that order, the dimension
    sharded over the grid's "model" axis, or None where it is replicated.
    JAX's ``P(None, "model")`` is 1, ``P("model")`` and ``P("model", None)``
    are 0, ``P()`` is None."""
    specs = {"fc_in.w": 1, "fc_in.b": 0}
    for g in ("gru1", "gru2"):
        specs.update({f"{g}.wi": 1, f"{g}.wh": 1, f"{g}.bi": 0, f"{g}.bh": 0})  # gates column-sharded
    # ff1 column-sharded, ff2 row-sharded: the pair needs one all-reduce.
    specs.update({"ff1.w": 1, "ff1.b": 0, "ff2.w": 0, "ff2.b": None, "out.w": None, "out.b": None})
    return specs


_SPECS = param_pspecs()


def _model_axis(mesh: DataModelMesh) -> int:
    """The grid's "model" axis, checked: the grid lies in one process and
    the axis divides NSNet2's widths 400 and 600 (it divides 200), as
    JAX's ``device_put`` refuses an uneven split (``ValueError``)."""
    mesh.check_one_process()
    tp = mesh.shape["model"]
    if HIDDEN % tp or FF1 % tp:
        raise ValueError(f"model axis {tp} does not divide NSNet2's widths {HIDDEN} and {FF1} (it must divide 200)")
    return tp


def shard_index(name: str, tp: int, j: int) -> Optional[torch.Tensor]:
    """The indices along parameter ``name``'s sharded dimension that model
    shard ``j`` of ``tp`` holds (None: replicated). A GRU's 1,200 gate
    columns are sharded by hidden unit: shard j holds the z, r and n columns
    of units [j * 400 / tp, (j + 1) * 400 / tp), in that order."""
    if _SPECS[name] is None:
        return None
    layer = name.split(".")[0]
    if layer.startswith("gru"):
        u = HIDDEN // tp
        units = torch.arange(j * u, (j + 1) * u)
        return torch.cat([units + gate * HIDDEN for gate in range(3)])
    width = (HIDDEN if layer == "fc_in" else FF1) // tp
    return torch.arange(j * width, (j + 1) * width)


class ShardedNSNet2:
    """NSNet2's training parameters laid out over a ("data", "model") grid
    of this process's devices (``shard_params``): ``shards[j]`` maps each
    parameter name that model column j holds to its shard, a leaf tensor
    with gradients on, on data row 0's device of that column. Replicated
    parameters (``ff2.b``, ``out``) are held once, by column 0, which also
    computes the head's last layers and a row's loss. Each data row's
    forward moves the shards to its own devices (``row_shards``), so
    backward sums every row's gradient into the one set of leaves (the
    all-reduce over "data") and one optimizer over ``parameters()`` steps
    every row's parameters at once."""

    def __init__(self, net: NSNet2, mesh: DataModelMesh):
        self.tp = _model_axis(mesh)
        self.mesh = mesh
        self.lbr = (net.gru1.linear_before_reset, net.gru2.linear_before_reset)
        full = {name: p.detach() for name, p in net.named_parameters()}
        self.shards = [self._shards_of(full, j, dev) for j, dev in enumerate(mesh.grid[0])]

    def _shards_of(self, full: dict, j: int, dev: torch.device) -> dict[str, torch.Tensor]:
        out = {}
        for name, x in full.items():
            idx = shard_index(name, self.tp, j)
            if idx is None and j:
                continue
            part = x if idx is None else x.index_select(_SPECS[name], idx.to(x.device))
            out[name] = part.to(dev, copy=True).requires_grad_(True)
        return out

    @property
    def home(self) -> torch.device:
        """Row 0's first device: where the loss and the gathered state live."""
        return self.mesh.grid[0][0]

    def named_shards(self):
        """(name, column, shard), in parameter order."""
        for name in _SPECS:
            for j, shards in enumerate(self.shards):
                if name in shards:
                    yield name, j, shards[name]

    def parameters(self) -> list[torch.Tensor]:
        """The shards: what the optimizer steps."""
        return [p for _, _, p in self.named_shards()]

    def row_shards(self, row: int) -> list[dict[str, torch.Tensor]]:
        """The shards as data row ``row`` computes with them: each column's
        moved to the row's device of that column by ``.to``, which autograd
        records (and which hands back the shard itself where the devices
        repeat)."""
        return [{k: v.to(d) for k, v in s.items()} for s, d in zip(self.shards, self.mesh.grid[row])]

    def apply(self, features: torch.Tensor) -> torch.Tensor:
        """``apply`` on the grid: the batch's rows split over the data rows
        (``shard_batch``), each through the sharded forward, the gains
        joined on ``home``."""
        check_tier()
        rows = shard_batch((features,), self.mesh)
        return torch.cat([_apply_row(self, r, f).to(self.home) for r, (f,) in enumerate(rows)], 0)

    def loss(self, batch) -> torch.Tensor:
        """``spectral_loss`` on the grid: batch (feats, n_re, n_im, c_re,
        c_im) [B, ...] each, or a list of row batches (``shard_batch``) ->
        the mean of the data rows' losses, on ``home``: the batch's mean, as
        the rows are equal."""
        check_tier()
        losses = [_compressed_mse(_apply_row(self, r, b[0]), *b[1:]).to(self.home)
                  for r, b in enumerate(shard_batch(batch, self.mesh))]
        return functools.reduce(torch.add, losses) / len(losses)

    def _join(self, name: str, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The unsharded parameter from its shards (in column order), on
        ``home``: the shards joined along the sharded dimension and, for a
        GRU's gate columns, put back in z|r|n order. Bit for bit."""
        dim = _SPECS[name]
        if dim is None:
            return parts[0].to(self.home)
        joined = torch.cat([x.to(self.home) for x in parts], dim)
        if name.startswith("gru") and self.tp > 1:
            order = torch.cat([shard_index(name, self.tp, j) for j in range(self.tp)])
            joined = joined.index_select(dim, torch.argsort(order).to(self.home))
        return joined

    def _parts(self, name: str) -> list[torch.Tensor]:
        return [shards[name] for shards in self.shards if name in shards]

    def gather(self) -> NSNet2:
        """The parameters as one unsharded ``NSNet2`` on ``home``, gradients
        off (as loaded)."""
        net = NSNet2(*self.lbr).to(self.home)
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(self._join(name, [x.detach() for x in self._parts(name)]))
        return net

    def gathered_grads(self) -> dict[str, torch.Tensor]:
        """The gradients, unsharded, on ``home`` (after a step: summed over
        the data rows, the gradient of the batch's mean loss)."""
        return {name: self._join(name, [p.grad for p in self._parts(name)]) for name in _SPECS}

    def gathered_state(self, optimizer: torch.optim.Optimizer) -> tuple[dict, dict]:
        """(name -> parameter, name -> Adam's state: ``step``, ``exp_avg``,
        ``exp_avg_sq``, or {} before the first step), unsharded, on
        ``home``: what a checkpoint holds."""
        params, adam = {}, {}
        for name in _SPECS:
            parts = self._parts(name)
            params[name] = self._join(name, [p.detach() for p in parts])
            states = [optimizer.state.get(p, {}) for p in parts]
            adam[name] = {} if not all("exp_avg" in st for st in states) else {
                "step": states[0]["step"],
                **{k: self._join(name, [st[k] for st in states]) for k in ("exp_avg", "exp_avg_sq")},
            }
        return params, adam

    def load_state(self, optimizer: torch.optim.Optimizer, params: dict, adam: dict) -> None:
        """Set the shards from unsharded ``params`` and their Adam state in
        ``optimizer`` from ``adam`` (as ``gathered_state`` gives them; an
        empty state clears it)."""
        for name, j, p in self.named_shards():
            with torch.no_grad():
                p.copy_(self._shard(params[name], name, j))
            st = adam.get(name) or {}
            if "exp_avg" not in st:
                optimizer.state.pop(p, None)
                continue
            # Each shard its own step tensor: Adam increments it in place.
            optimizer.state[p] = {"step": torch.as_tensor(st["step"]).detach().clone(),
                                  **{k: self._shard(st[k], name, j).to(p.device) for k in ("exp_avg", "exp_avg_sq")}}

    def _shard(self, x: torch.Tensor, name: str, j: int) -> torch.Tensor:
        idx = shard_index(name, self.tp, j)
        return x.detach().clone() if idx is None else x.detach().index_select(_SPECS[name], idx.to(x.device))


def shard_params(net: NSNet2, mesh: DataModelMesh) -> ShardedNSNet2:
    """``net``'s parameters laid out over ``mesh`` (copies; ``net`` stays as
    it is), as JAX's ``shard_params`` places them."""
    return ShardedNSNet2(net, mesh)


def shard_train_state(net: NSNet2, optimizer: torch.optim.Adam,
                      mesh: DataModelMesh) -> tuple[ShardedNSNet2, torch.optim.Adam]:
    """An unsharded training state (``net`` and its ``torch.optim.Adam``, as
    ``train_state_from_numpy`` carries a JAX run across) laid out over
    ``mesh``: the sharded network and a new Adam over its shards with the
    same hyperparameters and the sharded moments."""
    sharded = shard_params(net, mesh)
    opt = torch.optim.Adam(sharded.parameters(), **optimizer.defaults)
    adam = {name: dict(optimizer.state.get(p, {})) for name, p in net.named_parameters()}
    sharded.load_state(opt, {name: p.detach() for name, p in net.named_parameters()}, adam)
    return sharded, opt


def shard_batch(batch, mesh: DataModelMesh) -> list[tuple]:
    """The counterpart of JAX's ``batch_pspec()`` (``P("data", None,
    None)``): a batch of tensors [B, ...] split into the grid's data rows,
    row r the rows [r B / R, (r + 1) B / R) on its first device (B a
    multiple of R: ``parallel/mesh.py::pad_batch``). A list of R row
    batches is taken as already split."""
    n = len(mesh.grid)
    if not torch.is_tensor(batch[0]):
        if len(batch) != n:
            raise ValueError(f"{len(batch)} row batches for a grid of {n} data rows")
        return [tuple(x.to(row[0]) for x in b) for b, row in zip(batch, mesh.grid)]
    b = batch[0].shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not divide over {n} data rows (round it up: pad_batch)")
    per = b // n
    return [tuple(x[r * per:(r + 1) * per].to(row[0]) for x in batch) for r, row in enumerate(mesh.grid)]


def _gather(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> dict:
    """The all-gather over "model": {device: the shards moved there and
    joined along the last axis}, once a distinct device of the row."""
    if len(parts) == 1:
        return {devices[0]: parts[0]}
    return {d: torch.cat([p.to(d) for p in parts], -1) for d in dict.fromkeys(devices)}


def _layer_step(weights, lbr: int, h: list, h_full: dict, gi: list, level: str, devices) -> tuple[list, dict]:
    """One step of a GRU layer over its unit shards (``gru_cell`` sharded):
    ``weights[j]`` = (wh, bh) of shard j, ``h`` the shards' own units,
    ``h_full`` the gathered state on each device -> (new h, its gather).
    For linear_before_reset = 0, r * h is gathered too: (r h) Wh_n needs
    all units."""
    if lbr:
        h = [_gates(g, precision.matmul(h_full[d], wh, level=level) + bh, x)
             for g, (wh, bh), x, d in zip(gi, weights, h, devices)]
        return h, _gather(h, devices)
    zs, rh, ns = [], [], []
    for g, (wh, bh), x, d in zip(gi, weights, h, devices):
        u = x.shape[-1]
        z_i, r_i, n_i = g.split(u, dim=-1)
        wh_z, wh_r, wh_n = wh.split(u, dim=-1)
        bh_z, bh_r, bh_n = bh.split(u, dim=-1)
        zs.append(torch.sigmoid(z_i + precision.matmul(h_full[d], wh_z, level=level) + bh_z))
        rh.append(torch.sigmoid(r_i + precision.matmul(h_full[d], wh_r, level=level) + bh_r) * x)
        ns.append((n_i, wh_n, bh_n))
    rh_full = _gather(rh, devices)
    h = [(1.0 - z) * torch.tanh(n_i + precision.matmul(rh_full[d], wh_n, level=level) + bh_n) + z * x
         for z, (n_i, wh_n, bh_n), x, d in zip(zs, ns, h, devices)]
    return h, _gather(h, devices)


def _recurrence(lbr: tuple, devices: list, shards: list, gi1: list) -> dict:
    """Both GRU layers over a data row's unit shards (``row_shards``, on
    ``devices``) from h = 0 (the plain loop ``gru_stack_reference``
    sharded): gi1[j] [N, T, 3u] -> {device: the gathered h2 sequence
    [N, T, 400]}. h1 is gathered once a step, for layer 1's next step and
    layer 2's input projection; h2 once a step."""
    level_i, level_h = precision.gru_levels()
    dt = gi1[0].dtype
    w = [{k: s[k].to(dt) for k in ("gru1.wh", "gru1.bh", "gru2.wi", "gru2.bi", "gru2.wh", "gru2.bh")} for s in shards]
    n, t = gi1[0].shape[:2]
    h1 = [g.new_zeros((n, g.shape[-1] // 3)) for g in gi1]
    h2 = [x.clone() for x in h1]
    h1_full, h2_full = (_gather(x, devices) for x in (h1, h2))
    ys = []
    for step in range(t):
        h1, h1_full = _layer_step([(x["gru1.wh"], x["gru1.bh"]) for x in w], lbr[0], h1, h1_full,
                                  [g[:, step] for g in gi1], level_h, devices)
        gi2 = [precision.matmul(h1_full[d], x["gru2.wi"], level=level_i) + x["gru2.bi"] for x, d in zip(w, devices)]
        h2, h2_full = _layer_step([(x["gru2.wh"], x["gru2.bh"]) for x in w], lbr[1], h2, h2_full, gi2,
                                  level_h, devices)
        ys.append(h2_full)
    return {d: torch.stack([y[d] for y in ys], dim=1) for d in dict.fromkeys(devices)}


def _partial(a: torch.Tensor, w: torch.Tensor, stage: str) -> torch.Tensor:
    """A row shard's partial product of a row-sharded layer in float32:
    ``precision.matmul`` at the stage's level, but for two bf16 operands
    (bf16 storage) the float32 sums unrounded, so that the all-reduced sum
    rounds to bf16 once, as the unsharded product does."""
    if a.dtype == w.dtype == torch.bfloat16:
        return a.float() @ w.float()
    return precision.matmul(a, w, stage)


def _apply_row(net: ShardedNSNet2, row: int, features: torch.Tensor) -> torch.Tensor:
    """``apply`` on data row ``row`` of the grid: features [..., T, 161] ->
    gains on the row's first device. fc_in column shards, one all-gather of
    its output; gru_i for each shard's units; the sharded recurrence; ff1
    column shards, which ff2's row shards consume with no gather; one
    all-reduce of ff2's float32 partial products, then ``ff2.b`` once and
    relu; ``out`` replicated. Every product keeps its stage."""
    cast = precision.io_cast
    devices, shards = net.mesh.grid[row], net.row_shards(row)
    lead, t = features.shape[:-2], features.shape[-2]
    feats = {d: cast(features.reshape((-1, t, N_BINS))).to(d) for d in dict.fromkeys(devices)}
    x = _gather([precision.matmul(feats[d], cast(s["fc_in.w"]), "fc_in") + cast(s["fc_in.b"])
                 for s, d in zip(shards, devices)], devices)
    gi1 = [precision.matmul(x[d], cast(s["gru1.wi"]), "gru_i") + cast(s["gru1.bi"]) for s, d in zip(shards, devices)]
    y = _recurrence(net.lbr, devices, shards, gi1)
    home, first = devices[0], shards[0]
    parts = [_partial(torch.relu(precision.matmul(y[d], cast(s["ff1.w"]), "ff") + cast(s["ff1.b"])),
                      cast(s["ff2.w"]), "ff").to(home) for s, d in zip(shards, devices)]
    z = torch.relu(cast(functools.reduce(torch.add, parts)) + cast(first["ff2.b"]))
    gains = torch.sigmoid(precision.matmul(z, cast(first["out.w"]), "ff") + cast(first["out.b"]))
    return gains.reshape(lead + gains.shape[-2:])


def make_train_step(optimizer: torch.optim.Optimizer, net, mesh: Optional[DataModelMesh] = None):
    """A train step of ``net`` under ``optimizer``: batch (feats, n_re,
    n_im, c_re, c_im) -> the loss, a 0-d tensor (no synchronisation inside
    the step). It zeroes the gradients, computes the loss, runs backward
    and steps the optimizer.

    A ``ShardedNSNet2`` trains on its grid (``mesh``, the JAX step's
    argument, is that grid or None): the batch is split over the data rows
    (a list of row batches is taken as split), the loss is the batch's mean
    on ``net.home``, and backward sums the rows' gradients into the shards
    that ``optimizer`` steps."""
    sharded = isinstance(net, ShardedNSNet2)
    if mesh is not None and not (sharded and net.mesh == mesh):
        raise ValueError("a train step on a grid takes the ShardedNSNet2 that shard_params laid out on it")
    loss_of = net.loss if sharded else (lambda batch: spectral_loss(net, *batch))

    def train_step(batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of(batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def synth_batch(generator: torch.Generator, batch: int, n_frames: int):
    """A synthetic (noisy, clean) spectral training batch for smoke runs:
    (feats, n_re, n_im, c_re, c_im), each [batch, n_frames, 161] float32 on
    the CPU, drawn from ``generator``. The JAX package draws the same
    distributions from ``jax.random`` keys, so the numbers differ."""
    shape = (batch, n_frames, N_BINS)
    c_re = torch.randn(shape, generator=generator)
    c_im = torch.randn(shape, generator=generator)
    n_re = c_re + 0.5 * torch.randn(shape, generator=generator)
    n_im = c_im + 0.5 * torch.randn(shape, generator=generator)
    feats = torch.log10(torch.clamp(n_re**2 + n_im**2, min=1e-12))
    return feats, n_re, n_im, c_re, c_im


def train_demo_steps(net: NSNet2, n_steps: int = 2, batch: int = 4, n_frames: int = 16,
                     mesh: Optional[DataModelMesh] = None, learning_rate: float = 1e-4) -> tuple[NSNet2, list[float]]:
    """A few training steps of a copy of ``net`` (the caller's stays as it
    is), on its device or, with ``mesh``, laid out over that grid, each on
    ``synth_batch`` of a generator seeded with the step's index, as the JAX
    helper keys each step. -> (trained copy, unsharded, gradients on;
    losses)."""
    net = trainable(copy.deepcopy(net))
    if mesh is not None:
        net = shard_params(net, mesh)
    dev = net.home if mesh is not None else next(net.parameters()).device
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)
    step = make_train_step(opt, net, mesh)
    losses = []
    for i in range(n_steps):
        b = synth_batch(torch.Generator().manual_seed(i), batch, n_frames)
        losses.append(float(step(b if mesh is not None else tuple(x.to(dev) for x in b))))
    return (trainable(net.gather()) if mesh is not None else net), losses


def train_state_from_numpy(params, mu, nu, count: int, learning_rate: float = 1e-4,
                           lbr: tuple[int, int] = (1, 1)) -> tuple[NSNet2, torch.optim.Adam]:
    """A training state carried across from the JAX trainer: ``params``,
    ``mu`` and ``nu`` (optax Adam's moments) as sequences of 16 numpy arrays
    in ``NSNet2Params`` leaf order (fc_in_w, fc_in_b, gru1 wi, wh, bi, bh,
    gru2 ..., ff1_w, ff1_b, ff2_w, ff2_b, out_w, out_b; ``net.parameters()``
    follows the same order), and optax's step ``count``. -> (the port's
    network on the CPU with gradients on, a ``torch.optim.Adam`` over it at
    ``learning_rate`` whose ``state[p]`` holds ``step``, ``exp_avg`` and
    ``exp_avg_sq``). Both optimizers use b1 = 0.9, b2 = 0.999, eps = 1e-8."""
    net = trainable(NSNet2(*lbr))
    ps = list(net.parameters())
    for name, arrays in (("params", params), ("mu", mu), ("nu", nu)):
        if len(arrays) != len(ps):
            raise ValueError(f"{name}: {len(arrays)} arrays, expected {len(ps)}")
        for a, p in zip(arrays, ps):
            if tuple(np.shape(a)) != tuple(p.shape):
                raise ValueError(f"{name}: an array of shape {np.shape(a)} where the network has {tuple(p.shape)}")
    with torch.no_grad():
        for a, p in zip(params, ps):
            p.copy_(torch.from_numpy(np.array(a, np.float32)))
    opt = torch.optim.Adam(ps, lr=learning_rate)
    if count:
        for p, m, v in zip(ps, mu, nu):
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.from_numpy(np.array(m, np.float32)),
                "exp_avg_sq": torch.from_numpy(np.array(v, np.float32)),
            }
    return net, opt
