"""The per-gate GRU-stack kernels on one GPU: port of the experiment tool
``benchmarks/gru_kernel_exp.py``.

    python -m formula_vad_tpu_torch.tools.gru_kernel_exp [--variants vk,vkb,...] [--device cuda|cpu]

Every variant computes the NSNet2 forward over the same features: the fc_in
Dense and the per-gate layer-1 input projections with the biases folded
(``_gi_gates``), a GRU-stack recurrence, then the FF head (``_ff_head``).
They differ in the recurrence:

- ``v0``: the float model, ``NSNet2.forward`` (the ``gru_stack`` kernel);
- ``vk``, ``vkb``: kernel 4, ``models/nsnet2_gates_cuda.gru_gates``, with
  float32 or bf16 weights;
- ``vkp``, ``vkpb``: kernel 5, ``gru_gates_p`` (two products per step);
- ``vf``, ``vfb``, ``vfb840``, ``vfb416``: kernel 6, ``gru_gates_f``, f32 or
  bf16, whole batch or 840- and 416-row tiles; h2 is stored in the weight
  dtype.

The shape is the TPU tool's: N = streams x 2 x chunks rows (21 x 2 x 40 =
1,680 by default), T = 54 frames, two feature arrays drawn with numpy seed
0 (standard normal - 6). The weights are Glorot-random with zero biases,
as the TPU tool's ``nsnet2.load(None)``, drawn from a torch seed (torch
cannot reproduce ``jax.random``'s numbers; the packaged demo weights
saturate the gains on these features).
Each variant's line gives its time (the median of ``--iters`` CUDA-event-
timed calls, alternating the two arrays, after one warm-up call) and its
max |d gains| against v0, after the ``nvidia-smi`` card line. With
``--device cpu`` the variants run their plain versions and no time is
taken.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from .. import device as device_mod
from ..models import nsnet2_gates_cuda as gates
from ..models.nsnet2 import N_BINS, NSNet2
from ..models.registry import load_denoiser

T = 54
BF16 = torch.bfloat16


def _gi_gates(net: NSNet2, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fc_in, then the per-gate layer-1 projections with the biases folded."""
    return gates.gi_gates(net, net.fc_in(features))


def _ff_head(net: NSNet2, y: torch.Tensor) -> torch.Tensor:
    return net.head(y)


def apply_v0(net: NSNet2, features: torch.Tensor) -> torch.Tensor:
    return net(features)


def apply_vk(net: NSNet2, features: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _ff_head(net, gates.gru_gates(net, *_gi_gates(net, features), dtype=dtype))


def apply_vkp(net: NSNet2, features: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _ff_head(net, gates.gru_gates_p(net, *_gi_gates(net, features), dtype=dtype))


def apply_vf(
    net: NSNet2, features: torch.Tensor, dtype: torch.dtype = torch.float32,
    tile: int | None = None, out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    y = gates.gru_gates_f(net, *_gi_gates(net, features), dtype=dtype, tile=tile, out_dtype=out_dtype)
    return _ff_head(net, y.float())


VARIANTS = {
    "vk": ("VK per-gate f32", lambda net, f: apply_vk(net, f)),
    "vkb": ("VKb per-gate bf16", lambda net, f: apply_vk(net, f, dtype=BF16)),
    "vkp": ("VKp 2-product f32", lambda net, f: apply_vkp(net, f)),
    "vkpb": ("VKpb 2-product bf16", lambda net, f: apply_vkp(net, f, dtype=BF16)),
    "vf": ("VF prefetch f32 (whole batch)", lambda net, f: apply_vf(net, f)),
    "vfb": ("VFb prefetch bf16 (whole batch)", lambda net, f: apply_vf(net, f, dtype=BF16)),
    "vfb840": ("VFb prefetch bf16 tile=840", lambda net, f: apply_vf(net, f, dtype=BF16, tile=840)),
    "vfb416": ("VFb prefetch bf16 tile=416", lambda net, f: apply_vf(net, f, dtype=BF16, tile=416)),
}


def features(n_rows: int, device: torch.device) -> list[torch.Tensor]:
    rng = np.random.default_rng(0)
    return [
        torch.from_numpy((rng.standard_normal((n_rows, T, N_BINS)) - 6.0).astype(np.float32)).to(device)
        for _ in range(2)
    ]


def run(net: NSNet2, feats: list[torch.Tensor], names: list[str], iters: int = 10) -> list[dict]:
    """v0, then each named variant: {"name", "label", "ms" (None on the
    CPU), "max_abs_diff" against v0}. Prints a line per variant."""
    on_card = feats[0].device.type == "cuda"
    rows = []
    with torch.inference_mode():
        ref = apply_v0(net, feats[0])
        for name in ["v0"] + names:
            label, fn = ("V0 float model", apply_v0) if name == "v0" else VARIANTS[name]
            out = fn(net, feats[0])
            diff = float((out - ref).abs().max())
            ms = None
            if on_card:
                from . import cuda_ms

                calls = itertools.count()
                ms = cuda_ms(lambda: fn(net, feats[next(calls) % len(feats)]), reps=iters)
            took = f"{ms:8.3f} ms" if ms is not None else "time not measured (cpu)"
            print(f"{label:34s} {took}  max|diff| vs V0 = {diff:.3e}", flush=True)
            rows.append({"name": name, "label": label, "ms": ms, "max_abs_diff": diff})
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--device", choices=device_mod.DEVICES, default="cuda")
    ap.add_argument("--streams", type=int, default=21)
    ap.add_argument("--chunks", type=int, default=40)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    names = [v.strip() for v in args.variants.split(",") if v.strip()]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    dev = device_mod.resolve(args.device)
    n_rows = args.streams * 2 * args.chunks
    if dev.type == "cuda":
        from . import card

        print(f"gru_kernel_exp on {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"features [{n_rows}, {T}, {N_BINS}], random weights, device {dev}", flush=True)
    net = load_denoiser("random", device=dev)
    run(net, features(n_rows, dev), names, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
