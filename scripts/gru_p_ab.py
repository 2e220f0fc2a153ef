"""Two checkouts' bf16 form of a per-gate GRU kernel side by side, in one
process on one card, at the bf16 tier's shape [1680, 54]: kernel 5
(``nsnet2_gates_cuda.gru_gates_p``, the default), 4 (``gru_gates``) or 6
(``gru_gates_f``, bf16 out); kernel 1 (``nsnet2_cuda.gru_stack``, the
float tier's recurrence, on its float32 gi1 and within its 1e-4 bar);
kernel A (``gru_gates_3x``, the 'high' tier's bf16_3x recurrence) at its
three (gru_i, gru_h) level pairs, each stateless and from a carried state;
or kernel B (``nsnet2_cuda.gru_stack_mixed``, a class at 'highest' beside
one at 'high' or 'default') at its four mixes.

    python3 scripts/gru_p_ab.py --root PARENT_CHECKOUT --root . [--rounds 8] [--kernel 1|4|5|6|A|B]

Each ``--root`` names a checkout whose ``formula_vad_tpu_torch`` is loaded
under a name of its own, so both versions of the wrapper and of the kernel
run on the same inputs: the experiment tool's features (numpy seed 0)
through the network's fc_in and ``gi_gates``, as on the bf16 tier (cast
to bf16 before the timed calls for kernels 4 and 6, whose kernels take
bf16 gi), on the random-init network with N(0, 0.3) GRU biases (numpy
seed 3), each checkout building its own copy of the same weights. Both
outputs are held to the last checkout's plain version (the kernel's
``*_reference``) within ``chip_smoke.py``'s bf16 bars (mean |dh2| <=
3e-5, max <= 6e-3); the distance between the two checkouts' outputs, and
each one's distance from the plain version on random gi, with whether the
two agree bit for bit there, are printed for the record: at each of ``RANDOM_SHAPES``, gi
N(0, 0.8) of numpy seed rows x steps on the demo network with the same
biases, the inputs of ``tests/test_torch_cuda.py``'s float32 ragged-shape
test. Then ``--rounds`` rounds, each timing A B B A: a single call
(``tools.cuda_ms``) and calls queued back to back (``tools.queued_ms``).
Prints one line per round and one JSON line of the numbers.

Kernel A: float32 gi as kernel 5's, run at each level pair (``A_LEVELS``)
stateless and from a nonzero state (numpy seed 6, tanh of N(0, 0.8)),
at [1680, 54] and at ``RANDOM_SHAPES``, the two checkouts compared bit for
bit. At [1680, 54] each output (and the final h1) is held to the last
checkout's plain version at the level pair (``gru_gates_p_reference(...,
levels=)``) within ``chip_smoke.py``'s bars (max 5e-6 at all-'high', the
bf16 bars where a class is 'default'); on random gi the distances are
printed, as for the other kernels (a 'default' class's rounding cascade,
ROADMAP fault 3, can miss the bf16 bars there). The timed rounds take each
level pair stateless at [1680, 54], then all-'high' at ``A_SHAPES``: a
chunk step [42, 54], a low-latency step [42, 1] from a state, and 4,000
rows.

Kernel B: float32 gi1 as kernel 1's, at each mix (``B_LEVELS``), stateless
and from a nonzero state at [1680, 54], each checkout's output (and final
h1) held to the last checkout's ``gru_stack_reference`` at the mix within
``chip_smoke.py``'s bars (max 2e-6 where no class is 'default', else the
bf16 bars), with max |d| between the two checkouts (another summation
order: not bit for bit). The timed rounds take each mix at ``B_SHAPES``:
[1680, 54], a chunk step [42, 54], a low-latency step [42, 1] from a state
and 4,000 rows; each round also times the last checkout's kernel 1 on the
same gi1 (and state).
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

ROWS, STEPS = 1680, 54
RANDOM_SHAPES = tuple((n, 54) for n in (1, 15, 17, 337, 1680, 4000))
WRAPPERS = {"1": "gru_stack", "4": "gru_gates", "5": "gru_gates_p", "6": "gru_gates_f", "A": "gru_gates_3x",
            "B": "gru_stack_mixed"}
BF16_MEAN, BF16_MAX = 3e-5, 6e-3
GRU_TOL = 1e-4  # kernel 1's bar (chip_smoke.py)
A_HIGH_TOL = 5e-6  # kernel A's bar at all-'high' (chip_smoke.py)
A_LEVELS = (("high", "high"), ("default", "high"), ("high", "default"))  # (gru_i, gru_h)
A_SHAPES = ((42, 54, False), (42, 1, True), (4000, 54, False))  # rows, steps, from a state
B_HIGH_TOL = 2e-6  # kernel B's bar where no class is 'default' (chip_smoke.py)
B_LEVELS = (("high", "highest"), ("highest", "high"), ("default", "highest"), ("highest", "default"))
B_SHAPES = ((ROWS, STEPS, False), (42, 54, False), (42, 1, True), (4000, 54, False))


def _package(root: str, alias: str):
    """The ``formula_vad_tpu_torch`` of the checkout at ``root``, loaded as ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "formula_vad_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def _net(pkg, dev, spec="random"):
    """The ``spec`` network of checkout ``pkg`` with N(0, 0.3) GRU biases (numpy seed 3)."""
    import torch

    registry = importlib.import_module(f"{pkg.__name__}.models.registry")
    net = registry.load_denoiser(spec, device=dev)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for g in (net.gru1, net.gru2):
            for b in (g.bi, g.bh):
                b.copy_(torch.from_numpy(rng.normal(0.0, 0.3, tuple(b.shape)).astype(np.float32)))
    return net


def _dist(a, b) -> tuple[float, float]:
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True, help="a checkout (give two)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--kernel", choices=sorted(WRAPPERS), default="5")
    args = ap.parse_args(argv)
    import torch

    if len(args.root) != 2:
        ap.error("give exactly two --root checkouts")
    if not torch.cuda.is_available():
        print("gru_p_ab: needs a CUDA device", file=sys.stderr)
        return 2
    pkgs = [_package(root, f"_gru_p_ab_checkout_{i}") for i, root in enumerate(args.root)]
    if args.kernel == "A":
        return _kernel_a(args, pkgs)
    if args.kernel == "B":
        return _kernel_b(args, pkgs)
    module = "nsnet2_cuda" if args.kernel == "1" else "nsnet2_gates_cuda"
    kernels = [importlib.import_module(f"{p.__name__}.models.{module}") for p in pkgs]
    tools = importlib.import_module(f"{pkgs[-1].__name__}.tools")
    exp = importlib.import_module(f"{pkgs[-1].__name__}.tools.gru_kernel_exp")
    dev = torch.device("cuda")
    name = WRAPPERS[args.kernel]
    wrappers = [getattr(k, name) for k in kernels]
    plain = getattr(kernels[-1], f"{name}_reference")
    bf16 = torch.bfloat16
    if args.kernel == "1":  # float32 gi1 [N, T, 1200]; the plain version takes the network
        gi_dtype, gi_width, bar_max, bar_mean = torch.float32, 1200, GRU_TOL, GRU_TOL

        def run(w, net, gi):
            return w(net, *gi)

        def reference(net, gi):
            return plain(net, *gi)

        def gi_of(net, feats):
            return ((net.fc_in(feats) @ net.gru1.wi + net.gru1.bi).contiguous(),)
    else:
        gi_dtype = torch.float32 if args.kernel == "5" else bf16  # the kernel's own gi dtype
        gi_width, bar_max, bar_mean = 400, BF16_MAX, BF16_MEAN

        def run(w, net, gi):
            return w(net, *gi, dtype=bf16)

        def reference(net, gi):
            return plain(kernels[-1].gate_weights(net, bf16), *gi)

        def gi_of(net, feats):
            return tuple(g.to(gi_dtype) for g in exp._gi_gates(net, feats))
    nets = [_net(p, dev) for p in pkgs]
    with torch.inference_mode():
        gi = gi_of(nets[-1], exp.features(ROWS, dev)[0])
        want = reference(nets[-1], gi)
        calls = [lambda w=w, net=net: run(w, net, gi) for w, net in zip(wrappers, nets)]
        outs = [fn() for fn in calls]
        random_gi = {}
        demos = [_net(p, dev, "demo") for p in pkgs]
        for n, t in RANDOM_SHAPES:
            rng = np.random.default_rng(n * t)
            rgi = [torch.from_numpy((rng.standard_normal((n, t, gi_width)) * 0.8).astype(np.float32)).to(dev, gi_dtype)
                   for _ in range(1 if args.kernel == "1" else 3)]
            want_random = reference(demos[-1], rgi)
            random_outs = [run(w, net, rgi) for w, net in zip(wrappers, demos)]
            random_gi[f"{n}x{t}"] = {"vs_plain": [_dist(o, want_random) for o in random_outs],
                                     "identical": bool(torch.equal(*random_outs))}
        torch.cuda.synchronize()
        result = {"device": torch.cuda.get_device_name(0), "card": tools.card(),
                  "roots": [os.path.abspath(r) for r in args.root], "kernel": args.kernel, "shape": [ROWS, STEPS],
                  "vs_plain": [_dist(o, want) for o in outs], "random_gi": random_gi,
                  "between": _dist(outs[0], outs[1]), "identical": bool(torch.equal(outs[0], outs[1]))}
        print(f"{result['card']}, kernel {args.kernel} ({name}) {'float32' if args.kernel == '1' else 'bf16'}: vs plain "
              f"(max, mean) {result['vs_plain']}; between the checkouts {result['between']}, identical "
              f"{result['identical']}", flush=True)
        for shape, r in random_gi.items():
            print(f"random gi [{shape}]: vs plain (max, mean) {r['vs_plain']}, identical {r['identical']}", flush=True)
        for root, (worst, mean) in zip(args.root, result["vs_plain"]):
            if not (worst <= bar_max and mean <= bar_mean):
                raise AssertionError(f"gru_p_ab: {root} misses the kernel's bars: max {worst}, mean {mean}")
        single, queued = [[], []], [[], []]
        for r in range(args.rounds):
            for j in (0, 1, 1, 0):
                single[j].append(tools.cuda_ms(calls[j]))
                queued[j].append(tools.queued_ms(calls[j]))
            row = [statistics.mean(single[j][-2:]) for j in (0, 1)], [statistics.mean(queued[j][-2:]) for j in (0, 1)]
            print(f"round {r}: single {row[0][0]:.3f} / {row[0][1]:.3f} ms, queued {row[1][0]:.3f} / "
                  f"{row[1][1]:.3f} ms ({' / '.join(args.root)})", flush=True)
    result.update(_summary(single, queued, args.rounds))
    print(json.dumps(result))
    return 0


def _summary(single, queued, rounds) -> dict:
    """The timed rounds' numbers: every time, the rounds in which the second
    checkout's single call was faster, and each checkout's medians."""
    return {"single_ms": single, "queued_ms": queued,
            "faster_rounds": sum(statistics.mean(single[1][2 * r:2 * r + 2]) < statistics.mean(single[0][2 * r:2 * r + 2])
                                 for r in range(rounds)),
            "median_single_ms": [statistics.median(s) for s in single],
            "median_queued_ms": [statistics.median(q) for q in queued]}


def _kernel_a(args, pkgs) -> int:
    """``--kernel A``: both checkouts' kernel A at each level pair,
    stateless and carried, against the plain version and each other; then
    the timed rounds, a level pair at a time."""
    import torch

    gates = [importlib.import_module(f"{p.__name__}.models.nsnet2_gates_cuda") for p in pkgs]
    tools = importlib.import_module(f"{pkgs[-1].__name__}.tools")
    exp = importlib.import_module(f"{pkgs[-1].__name__}.tools.gru_kernel_exp")
    dev = torch.device("cuda")
    f32 = torch.float32
    nets = [_net(p, dev) for p in pkgs]
    demos = [_net(p, dev, "demo") for p in pkgs]

    def state_of(n):
        rng = np.random.default_rng(6)
        return tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (n, 400))).astype(np.float32)).to(dev)
                     for _ in range(2))

    def compare(label, levels, gi, which, state=None, hold=True) -> dict:
        """Both checkouts' outputs (and, with a state, final h1) against the
        last one's plain version, held to its bars where ``hold``, and each
        other."""
        plain = gates[-1].gru_gates_p_reference(gates[-1].gate_weights(which[-1], f32), *gi, state=state,
                                                levels=levels)
        outs = [g.gru_gates_3x(net, *gi, levels, state=state) for g, net in zip(gates, which)]
        if state is not None:  # (out, final h1) each
            plain, outs = torch.cat([plain[0].flatten(), plain[1][0].flatten()]), [
                torch.cat([o[0].flatten(), o[1][0].flatten()]) for o in outs]
        row = {"vs_plain": [_dist(o, plain) for o in outs], "identical": bool(torch.equal(outs[0], outs[1]))}
        for root, (worst, mean) in zip(args.root, row["vs_plain"] if hold else ()):
            ok = worst <= BF16_MAX and mean <= BF16_MEAN if "default" in levels else worst <= A_HIGH_TOL
            if not ok:
                raise AssertionError(f"gru_p_ab: {root}'s kernel A misses its bars at {label}: max {worst}, mean {mean}")
        print(f"kernel A {levels} {label}: vs plain (max, mean) {row['vs_plain']}, identical {row['identical']}",
              flush=True)
        return row

    result = {"device": torch.cuda.get_device_name(0), "card": tools.card(),
              "roots": [os.path.abspath(r) for r in args.root], "kernel": "A", "shape": [ROWS, STEPS], "levels": {}}
    with torch.inference_mode():
        gi = tuple(g.float().contiguous() for g in exp._gi_gates(nets[-1], exp.features(ROWS, dev)[0]))
        state = state_of(ROWS)
        for levels in A_LEVELS:
            rows = {"stateless": compare(f"[{ROWS}, {STEPS}]", levels, gi, nets),
                    "carried": compare(f"[{ROWS}, {STEPS}] from a state", levels, gi, nets, state)}
            for n, t in RANDOM_SHAPES:
                rng = np.random.default_rng(n * t)
                rgi = tuple(torch.from_numpy((rng.standard_normal((n, t, 400)) * 0.8).astype(np.float32)).to(dev)
                            for _ in range(3))
                rows[f"random {n}x{t}"] = compare(f"random gi [{n}, {t}]", levels, rgi, demos, hold=False)
                rows[f"random {n}x{t} carried"] = compare(f"random gi [{n}, {t}] from a state", levels, rgi, demos,
                                                          state_of(n), hold=False)
            result["levels"][" ".join(levels)] = {"checks": rows}
        result["identical"] = all(r["identical"] for lv in result["levels"].values() for r in lv["checks"].values())

        def rounds(label, calls) -> dict:
            single, queued = [[], []], [[], []]
            for r in range(args.rounds):
                for j in (0, 1, 1, 0):
                    single[j].append(tools.cuda_ms(calls[j]))
                    queued[j].append(tools.queued_ms(calls[j]))
                row = ([statistics.mean(single[j][-2:]) for j in (0, 1)],
                       [statistics.mean(queued[j][-2:]) for j in (0, 1)])
                print(f"kernel A {label} round {r}: single {row[0][0]:.3f} / {row[0][1]:.3f} ms, queued "
                      f"{row[1][0]:.3f} / {row[1][1]:.3f} ms ({' / '.join(args.root)})", flush=True)
            return _summary(single, queued, args.rounds)

        for levels in A_LEVELS:
            result["levels"][" ".join(levels)].update(rounds(f"{levels} [{ROWS}, {STEPS}]", [
                lambda g=g, net=net, levels=levels: g.gru_gates_3x(net, *gi, levels) for g, net in zip(gates, nets)]))
        result["shapes"] = {}
        for n, t, carried in A_SHAPES:
            sgi = tuple(g.float().contiguous() for g in exp._gi_gates(nets[-1], exp.features(n, dev)[0][:, :t]))
            state = state_of(n) if carried else None
            label = f"[{n}, {t}]{' from a state' if carried else ''}"
            result["shapes"][label] = rounds(f"('high', 'high') {label}", [
                lambda g=g, net=net: g.gru_gates_3x(net, *sgi, ("high", "high"), state=state)
                for g, net in zip(gates, nets)])
    print(f"{result['card']}: kernel A bit for bit between the checkouts at every check: {result['identical']}",
          flush=True)
    print(json.dumps(result))
    return 0


def _kernel_b(args, pkgs) -> int:
    """``--kernel B``: both checkouts' kernel B at each mix, stateless and
    carried, against the plain version and each other; then the timed
    rounds, a mix and a shape at a time, with kernel 1 in each round."""
    import torch

    cudas = [importlib.import_module(f"{p.__name__}.models.nsnet2_cuda") for p in pkgs]
    tools = importlib.import_module(f"{pkgs[-1].__name__}.tools")
    exp = importlib.import_module(f"{pkgs[-1].__name__}.tools.gru_kernel_exp")
    dev = torch.device("cuda")
    nets = [_net(p, dev) for p in pkgs]

    def state_of(n):
        rng = np.random.default_rng(6)
        return tuple(torch.from_numpy(np.tanh(rng.normal(0.0, 0.8, (n, 400))).astype(np.float32)).to(dev)
                     for _ in range(2))

    def gi1_of(n, t):
        net = nets[-1]
        return (net.fc_in(exp.features(n, dev)[0][:, :t]) @ net.gru1.wi + net.gru1.bi).contiguous()

    result = {"device": torch.cuda.get_device_name(0), "card": tools.card(),
              "roots": [os.path.abspath(r) for r in args.root], "kernel": "B", "shape": [ROWS, STEPS], "levels": {}}
    with torch.inference_mode():
        gi1 = gi1_of(ROWS, STEPS)
        for levels in B_LEVELS:
            checks = {}
            for label, state in (("stateless", None), ("carried", state_of(ROWS))):
                plain = cudas[-1].gru_stack_reference(nets[-1], gi1, state, levels=levels)
                outs = [c.gru_stack_mixed(net, gi1, levels, state) for c, net in zip(cudas, nets)]
                if state is not None:  # (out, final h1) each
                    plain = torch.cat([plain[0].flatten(), plain[1][0].flatten()])
                    outs = [torch.cat([o[0].flatten(), o[1][0].flatten()]) for o in outs]
                row = {"vs_plain": [_dist(o, plain) for o in outs], "between": _dist(outs[0], outs[1])}
                for root, (worst, mean) in zip(args.root, row["vs_plain"]):
                    ok = worst <= BF16_MAX and mean <= BF16_MEAN if "default" in levels else worst <= B_HIGH_TOL
                    if not ok:
                        raise AssertionError(f"gru_p_ab: {root}'s kernel B misses its bars at {levels} {label}: "
                                             f"max {worst}, mean {mean}")
                print(f"kernel B {levels} [{ROWS}, {STEPS}] {label}: vs plain (max, mean) {row['vs_plain']}, between "
                      f"the checkouts {row['between']}", flush=True)
                checks[label] = row
            result["levels"][" ".join(levels)] = {"checks": checks, "shapes": {}}

        for n, t, carried in B_SHAPES:
            sgi = gi1 if (n, t) == (ROWS, STEPS) else gi1_of(n, t)
            state = state_of(n) if carried else None
            label = f"[{n}, {t}]{' from a state' if carried else ''}"
            k1 = lambda: cudas[-1].gru_stack(nets[-1], sgi, state)  # noqa: E731
            for levels in B_LEVELS:
                calls = [lambda c=c, net=net: c.gru_stack_mixed(net, sgi, levels, state) for c, net in zip(cudas, nets)]
                single, queued, k1_single, k1_queued = [[], []], [[], []], [], []
                for r in range(args.rounds):
                    for j in (0, 1, 1, 0):
                        single[j].append(tools.cuda_ms(calls[j]))
                        queued[j].append(tools.queued_ms(calls[j]))
                    k1_single.append(tools.cuda_ms(k1))
                    k1_queued.append(tools.queued_ms(k1))
                    print(f"kernel B {levels} {label} round {r}: queued {statistics.mean(queued[0][-2:]):.3f} / "
                          f"{statistics.mean(queued[1][-2:]):.3f} ms, single {statistics.mean(single[0][-2:]):.3f} / "
                          f"{statistics.mean(single[1][-2:]):.3f} ({' / '.join(args.root)}); kernel 1 "
                          f"{k1_queued[-1]:.3f} queued", flush=True)
                row = _summary(single, queued, args.rounds)
                row.update(kernel_1_median_single_ms=statistics.median(k1_single),
                           kernel_1_median_queued_ms=statistics.median(k1_queued))
                result["levels"][" ".join(levels)]["shapes"][label] = row
                print(f"kernel B {levels} {label}: medians queued {row['median_queued_ms'][0]:.3f} / "
                      f"{row['median_queued_ms'][1]:.3f} ms, single {row['median_single_ms'][0]:.3f} / "
                      f"{row['median_single_ms'][1]:.3f}; kernel 1 {row['kernel_1_median_queued_ms']:.3f} / "
                      f"{row['kernel_1_median_single_ms']:.3f}; on {result['card']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
