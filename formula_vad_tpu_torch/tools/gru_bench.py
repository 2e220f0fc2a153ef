"""The GRU-stack kernel against its plain version on one GPU.

    python -m formula_vad_tpu_torch.tools.gru_bench

Four contenders on the same ``gi1 [1680, 54, 1200]`` (21 streams x 2
channels x 40 chunks, the batched scoring shape) and the packaged
demo weights: the CUDA kernel (``nsnet2_cuda.gru_stack``), the plain
per-step loop run eagerly (``gru_stack_reference``), the same loop
captured once in a CUDA graph and replayed, which takes the host's launch
cost out of the plain version, and cuDNN's float32 two-layer GRU
(``torch.nn.GRU`` on the same weights and the fc_in output; it also
computes layer 1's input projection, 87 GFLOP more). Each round times all
four in a rotating order, each as the median of 5 CUDA-event-timed calls;
the script prints the launch plan, every round, the medians over rounds,
and each other contender's max |dh2| against the kernel.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from .. import device as device_mod
from ..models import nsnet2_cuda
from ..models.registry import load_denoiser
from . import card, cuda_ms, cudnn_gru

ROWS, STEPS, ROUNDS = 1680, 54, 8


def main() -> int:
    dev = device_mod.resolve("cuda")
    print(f"gru_bench on {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    net = load_denoiser("demo", device=dev)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(-3.0, 1.5, (ROWS, STEPS, 161)).astype(np.float32)).to(dev)

    print(f"launch plan: {nsnet2_cuda.device_plan(ROWS, dev)}", flush=True)
    gru = cudnn_gru(net, dev)
    with torch.no_grad():
        x = net.fc_in(feats)
        gi1 = (x @ net.gru1.wi + net.gru1.bi).contiguous()
        kernel_out = nsnet2_cuda.gru_stack(net, gi1)
        eager_out = nsnet2_cuda.gru_stack_reference(net, gi1)
        cudnn_out = gru(x)[0]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                nsnet2_cuda.gru_stack_reference(net, gi1)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graph_out = nsnet2_cuda.gru_stack_reference(net, gi1)
        graph.replay()
        torch.cuda.synchronize()
        for name, out in (("eager plain", eager_out), ("graph plain", graph_out), ("cuDNN GRU", cudnn_out)):
            print(f"{name} vs kernel: max |dh2| = {float((out - kernel_out).abs().max()):.3e}")

        contenders = {
            "kernel": lambda: nsnet2_cuda.gru_stack(net, gi1),
            "eager plain": lambda: nsnet2_cuda.gru_stack_reference(net, gi1),
            "graph plain": graph.replay,
            "cuDNN GRU": lambda: gru(x),
        }
        names = list(contenders)
        times: dict[str, list[float]] = {name: [] for name in names}
        for r in range(ROUNDS):
            order = names[r % len(names) :] + names[: r % len(names)]
            for name in order:
                times[name].append(cuda_ms(contenders[name]))
            print(f"round {r}: " + ", ".join(f"{n} {times[n][-1]:.3f} ms" for n in names), flush=True)

    gflop = 3 * 2 * ROWS * 400 * 1200 * STEPS / 1e9
    for name in names:
        med = statistics.median(times[name])
        print(f"{name}: median {med:.3f} ms over {ROUNDS} rounds "
              f"(min {min(times[name]):.3f}, max {max(times[name]):.3f}), {gflop / med:.2f} TFLOP/s")
    for other in ("graph plain", "cuDNN GRU"):
        wins = sum(k < o for k, o in zip(times["kernel"], times[other]))
        print(f"kernel faster than {other} in {wins} of {ROUNDS} rounds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
