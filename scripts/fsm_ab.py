"""Two checkouts' FSM window scan (``fsm_cuda.scan_windows``, kernel 2) side
by side, in one process on one card.

    python3 scripts/fsm_ab.py --root PARENT_CHECKOUT --root . [--rounds 8]

Each ``--root`` names a checkout whose ``formula_vad_tpu_torch`` is loaded
under a name of its own, so both versions of the wrapper and the kernel run
on the same inputs: ``testing.synth.fsm_inputs`` (numpy seed 0) at each of
``SHAPES``, with the default VAD configuration and a fresh carry, as on the
main path. Both checkouts' seven outputs and carries are held to the last
checkout's native host decoder bit for bit, and to each other. Then
``--rounds`` rounds, each timing A B B A at every shape: a single call
(``tools.cuda_ms``), calls queued back to back (``tools.queued_ms``) and,
at the 937-window shapes, the host time of a wrapper call
(``tools.host_us``). Prints one line per round and shape and one JSON line
of the numbers.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

import numpy as np

SHAPES = ((21, 937), (21, 56_250), (660, 937))
HOST_TIMED = {(21, 937), (660, 937)}  # the parent's host time at 56,250 windows waits on its kernel


def _package(root: str, alias: str):
    """The ``formula_vad_tpu_torch`` of the checkout at ``root``, loaded as ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "formula_vad_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def _same(out, carry, want, want_carry) -> bool:
    import torch

    def raw(x):
        return np.ascontiguousarray(x.cpu().numpy() if torch.is_tensor(x) else x).tobytes()

    return all(raw(a) == raw(b) for a, b in zip(out, want)) and all(
        raw(carry[k]) == raw(want_carry[k]) for k in want_carry)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True, help="a checkout (give two)")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    import torch

    if len(args.root) != 2:
        ap.error("give exactly two --root checkouts")
    if not torch.cuda.is_available():
        print("fsm_ab: needs a CUDA device", file=sys.stderr)
        return 2
    pkgs = [_package(root, f"_fsm_ab_checkout_{i}") for i, root in enumerate(args.root)]
    scans = [importlib.import_module(f"{p.__name__}.pipeline.fsm_cuda") for p in pkgs]
    last = pkgs[-1].__name__
    fsm = importlib.import_module(f"{last}.pipeline.fsm")
    fsm_host = importlib.import_module(f"{last}.pipeline.fsm_host")
    synth = importlib.import_module(f"{last}.testing.synth")
    config = importlib.import_module(f"{last}.config")
    tools = importlib.import_module(f"{last}.tools")
    shape, params = fsm.statics_from_config(config.VADMachineConfig(), 48000, 1024)
    dev = torch.device("cuda")
    result = {"device": torch.cuda.get_device_name(0), "card": tools.card(),
              "roots": [os.path.abspath(r) for r in args.root], "shapes": {}}
    calls = {}
    for rows, windows in SHAPES:
        mv, vr, valid = synth.fsm_inputs(rows, windows, seed=0)
        x = [torch.from_numpy(a).to(dev) for a in (mv, vr, valid)]
        want, want_carry = fsm_host.scan_windows_host(shape, params, mv, vr, valid)
        fns = [lambda s=s, x=x: s.scan_windows(shape, params, *x) for s in scans]
        outs = [fn() for fn in fns]
        torch.cuda.synchronize()
        same = [_same(*o, want, want_carry) for o in outs]
        between = _same(*outs[0], outs[1][0], outs[1][1])
        key = f"{rows}x{windows}"
        result["shapes"][key] = {"equal_host_decoder": same, "identical": between,
                                 "single_ms": [[], []], "queued_ms": [[], []], "host_us": [[], []]}
        print(f"[{rows}, {windows}]: equal to the host decoder {same}, identical to each other {between}", flush=True)
        if not (all(same) and between):
            raise AssertionError(f"fsm_ab: outputs differ at [{rows}, {windows}]")
        calls[key] = ((rows, windows), fns)
    for r in range(args.rounds):
        for key, (shp, fns) in calls.items():
            rec = result["shapes"][key]
            for j in (0, 1, 1, 0):
                rec["single_ms"][j].append(tools.cuda_ms(fns[j]))
                rec["queued_ms"][j].append(tools.queued_ms(fns[j]))
            if shp in HOST_TIMED:
                for j, us in enumerate(tools.host_us(fns, rounds=3)):
                    rec["host_us"][j].append(us)
            single = [statistics.mean(rec["single_ms"][j][-2:]) for j in (0, 1)]
            queued = [statistics.mean(rec["queued_ms"][j][-2:]) for j in (0, 1)]
            host = [rec["host_us"][j][-1] for j in (0, 1)] if shp in HOST_TIMED else None
            print(f"round {r} [{key}]: single {single[0]:.4f} / {single[1]:.4f} ms, queued {queued[0]:.4f} / "
                  f"{queued[1]:.4f} ms" + (f", host {host[0]:.1f} / {host[1]:.1f} us" if host else "")
                  + f" ({' / '.join(args.root)})", flush=True)
    for rec in result["shapes"].values():
        q = rec["queued_ms"]
        rec["faster_queued_rounds"] = sum(
            statistics.mean(q[1][2 * r:2 * r + 2]) < statistics.mean(q[0][2 * r:2 * r + 2]) for r in range(args.rounds))
        rec["median_single_ms"] = [statistics.median(x) for x in rec["single_ms"]]
        rec["median_queued_ms"] = [statistics.median(x) for x in rec["queued_ms"]]
        if rec["host_us"][0]:
            rec["median_host_us"] = [statistics.median(x) for x in rec["host_us"]]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
