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

Not ported: the mesh layout (``param_pspecs``, ``shard_params``,
``batch_pspec``; ROADMAP §1 item 11, multi-GPU).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.nsnet2 import N_BINS, NSNet2
from ..models.nsnet2_cuda import gru_stack_reference
from ..ops import precision

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
    casts them (the casts pass the gradient back)."""
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
    [B, T, 161] each."""
    gains = apply(net, feats)
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


def make_train_step(optimizer: torch.optim.Optimizer, net: NSNet2):
    """A train step of ``net`` under ``optimizer``: batch (feats, n_re,
    n_im, c_re, c_im) -> the loss, a 0-d tensor on the batch's device (no
    synchronisation inside the step). It zeroes the gradients, computes the
    loss, runs backward and steps the optimizer."""

    def train_step(batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = spectral_loss(net, *batch)
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
                     learning_rate: float = 1e-4) -> tuple[NSNet2, list[float]]:
    """A few training steps of a copy of ``net`` (the caller's stays as it
    is), on its device, each on ``synth_batch`` of a generator seeded with
    the step's index, as the JAX helper keys each step. -> (trained copy,
    losses)."""
    net = trainable(copy.deepcopy(net))
    dev = next(net.parameters()).device
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)
    step = make_train_step(opt, net)
    losses = []
    for i in range(n_steps):
        b = tuple(x.to(dev) for x in synth_batch(torch.Generator().manual_seed(i), batch, n_frames))
        losses.append(float(step(b)))
    return net, losses


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
