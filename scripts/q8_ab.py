"""Two checkouts' ``matmul_q8`` side by side, in one process on one card, at
the int8 tier's six product shapes: device time per call and host time per
wrapper call.

    python3 scripts/q8_ab.py --root PARENT_CHECKOUT --root . [--calls 20] [--rounds 21]

Each ``--root`` names a checkout whose ``formula_vad_tpu_torch`` is loaded
under a name of its own, so both versions of the wrapper and of the kernel
run on the same inputs. Per shape, after one warm-up call each, both
outputs must be equal. Device time: CUDA-graph replays (``tools.graph_ms``
of the last checkout) in the order A B B A, the mean of each checkout's
two. Host time: ``tools.host_us`` of the last checkout, the two wrappers
in turns, as ``chip_smoke.py`` phase 6 times one (there with 7 rounds).
Prints one line per shape and a JSON line of the numbers.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

# (name, R, K, N, epilogue order, with a row scale, launches per forward):
# the int8 tier's products on the 21-stream slice (models/nsnet2_q8.py).
SHAPES = (
    ("fc_in", 90720, 161, 400, "row_col", True, 1),
    ("gi1", 90720, 400, 1200, "row_col", True, 1),
    ("in_scan", 1680, 400, 1200, "col_row", False, 162),
    ("ff1", 84000, 400, 600, "col_row", False, 1),
    ("ff2", 84000, 600, 600, "row_col", True, 1),
    ("out", 84000, 600, 161, "row_col", True, 1),
)


def _package(root: str, alias: str):
    """The ``formula_vad_tpu_torch`` of the checkout at ``root``, loaded as ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "formula_vad_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True, help="a checkout (give two)")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=21)
    args = ap.parse_args(argv)
    import torch

    if len(args.root) != 2:
        ap.error("give exactly two --root checkouts")
    if not torch.cuda.is_available():
        print("q8_ab: needs a CUDA device", file=sys.stderr)
        return 2
    pkgs = [_package(root, f"_q8_ab_checkout_{i}") for i, root in enumerate(args.root)]
    wrappers = [importlib.import_module(f"{p.__name__}.ops.matmul_q8") for p in pkgs]
    tools = importlib.import_module(f"{pkgs[-1].__name__}.tools")
    dev = torch.device("cuda")
    result = {"device": torch.cuda.get_device_name(0), "roots": [os.path.abspath(r) for r in args.root],
              "ms": {}, "host_us": {}}
    for i, (name, r, k, n, order, with_row, per_forward) in enumerate(SHAPES):
        gen = torch.Generator(device=dev).manual_seed(i)
        a8 = torch.randint(-127, 128, (r, k), dtype=torch.int8, device=dev, generator=gen)
        b8 = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
        scale, bias = torch.rand(n, device=dev, generator=gen), torch.randn(n, device=dev, generator=gen)
        row = torch.rand((r, 1), device=dev, generator=gen) if with_row else None
        calls = []
        for mq in wrappers:
            w = mq.Q8Weight.pack(b8, scale, bias)
            calls.append(lambda mq=mq, w=w: mq.matmul_q8(a8, w, row, order=order))
        with torch.inference_mode():
            outs = [fn() for fn in calls]
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"q8_ab: the two checkouts disagree at {name}")
            per_replay = 20 if per_forward > 1 else 2
            ms = [[], []]
            for j in (0, 1, 1, 0):
                ms[j].append(tools.graph_ms(calls[j], per_replay))
            ms = [statistics.mean(m) for m in ms]
            host = tools.host_us(calls, args.calls, args.rounds)
        result["ms"][name], result["host_us"][name] = ms, host
        print(f"{name} [{r}, {k}] x [{k}, {n}]: device {ms[0] * 1e3:.1f} / {ms[1] * 1e3:.1f} us, "
              f"host {host[0]:.2f} / {host[1]:.2f} us a call ({' / '.join(args.root)})", flush=True)
    per_forward = {name: f for name, *_, f in SHAPES}
    result["ms_per_forward"] = [sum(per_forward[s] * v[j] for s, v in result["ms"].items()) for j in (0, 1)]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
