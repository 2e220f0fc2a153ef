"""Threshold tuner: grid-search VAD machine configs in one device pass (port
of ``formula_vad_tpu/apps/tune.py``).

The reference ships the mechanism for this, ``alt_vad_machine_configs``:
many state machines over one FFT stream (VADPipeline.zig:24,111-123, "used
for training"), but no tool that drives it. This one builds a grid over the
machine config and runs it as K machines behind one denoise and FFT front
end: the primary machine and the K candidates are (stream, config) rows of
one FSM scan (``vad.stack_machine_params``; the front end, ~98% of the
work, is paid once a statics group). It scores every candidate against the
plan's labels with the reference's scoring math and prints a leaderboard.

    python -m formula_vad_tpu_torch.apps.tune -i plan.json \\
        --grid speech_threshold_factor=6,8,10,14 \\
        --grid channel_vol_ratio_threshold=0.3,0.5,0.7 \\
        [--top 10] [--out best.json] [--device cuda|cpu]

Every VADMachineConfig parameter is tunable. *Dynamic* parameters (the
``pipeline/fsm.py::FSMParams`` fields: thresholds, open/gap/duration, the
initial noise floor) are per-row values of the scan, so any mix shares one
pass. *Static* parameters (rolling-window lengths, the speech band) change
the rings' sizes or the scored band: candidates are split into groups of
identical statics and each group runs one batched pass (the front end runs
again for each group, so grids over static parameters cost
proportionally more). ``--device cuda`` is the default and raises without
a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

from .. import device as device_mod
from ..config import SIMULATOR_STAT_CONFIG, StatConfig
from ..eval import formats, init_and_run, statistics
from .simulator import load_plan, run_batched, vad_segments_to_eval

# Dynamic parameters are per-row FSMParams values: any mix of values runs
# as K machines in one batched pass.
DYNAMIC = (
    "speech_threshold_factor",
    "channel_vol_ratio_threshold",
    "min_consecutive_sec_to_open",
    "max_speech_gap_sec",
    "min_vad_duration_sec",
    "initial_long_term_avg",
)
# Static parameters change the rings' sizes or the scored band: candidates
# are split into groups of identical statics, one batched pass each (the
# front end runs again for each group).
STATIC = (
    "speech_min_freq",
    "speech_max_freq",
    "long_term_speech_avg_sec",
    "short_term_speech_avg_sec",
    "channel_vol_ratio_avg_sec",
)
TUNABLE = DYNAMIC + STATIC


def parse_grid(specs: list[str]) -> dict[str, list[float]]:
    grid: dict[str, list[float]] = {}
    for spec in specs:
        key, _, vals = spec.partition("=")
        if key not in TUNABLE:
            raise SystemExit(
                f"--grid key {key!r} is not tunable (dynamic, one pass: "
                f"{', '.join(DYNAMIC)}; static, one pass per value group: "
                f"{', '.join(STATIC)})"
            )
        if not vals:
            raise SystemExit(f"--grid {spec!r}: expected key=v1,v2,...")
        grid[key] = [float(v) for v in vals.split(",")]
    return grid


def group_key(cfg, fft_size: int, sample_rate: int = 48000):
    """Candidates sharing this key can run as one stack of machines."""
    from ..ops import dft
    from ..pipeline import fsm

    shape, _ = fsm.statics_from_config(cfg, sample_rate, fft_size)
    return (
        shape,
        dft.freq_to_bin(cfg.speech_min_freq, fft_size, sample_rate),
        dft.freq_to_bin(cfg.speech_max_freq, fft_size, sample_rate),
    )


def grid_configs(base, grid: dict[str, list[float]]):
    """Cartesian product of grid values over the base VADMachineConfig."""
    keys = sorted(grid)
    out = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        out.append(dataclasses.replace(base, **dict(zip(keys, combo))))
    return keys, out


def score(instances, segments_per_instance, min_vad_duration_sec: float):
    """Aggregate stats for one candidate across all plan instances."""
    stat_config = StatConfig(
        ignore_shorter_than_sec=min_vad_duration_sec,
        extrude_start=SIMULATOR_STAT_CONFIG.extrude_start,
        extrude_end=SIMULATOR_STAT_CONFIG.extrude_end,
        fill_gaps=SIMULATOR_STAT_CONFIG.fill_gaps,
    )
    singles = []
    for inst, segs in zip(instances, segments_per_instance):
        ev = init_and_run(vad_segments_to_eval(segs or [], 48000), inst.reference_segments)
        singles.append(statistics.from_evaluator(ev, stat_config))
    return statistics.aggregate(singles)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Grid-search VAD thresholds (one device pass).")
    ap.add_argument("-i", "--input", required=True, help="Simulation plan JSON (with labels)")
    ap.add_argument("--grid", action="append", default=[], metavar="KEY=V1,V2,...",
                    help="Values for one tunable parameter (repeatable)")
    ap.add_argument("--top", type=int, default=10, help="Leaderboard rows to print")
    ap.add_argument("--max-configs", type=int, default=256,
                    help="Refuse larger grids (each config adds FSM rows and state)")
    ap.add_argument("--out", default=None, metavar="BEST.json",
                    help="Write the best config as a plan-mergeable snippet")
    ap.add_argument("--device", choices=device_mod.DEVICES, default="cuda",
                    help="Device to score on (default cuda; raises when no GPU is visible)")
    args = ap.parse_args(argv)

    grid = parse_grid(args.grid)
    if not grid:
        raise SystemExit("no --grid given; nothing to tune")
    device = device_mod.resolve(args.device)

    instances, config, _base, _plan_text = load_plan(args.input)
    base_mc = config.vad_config.vad_machine_config
    keys, candidates = grid_configs(base_mc, grid)
    if len(candidates) > args.max_configs:
        raise SystemExit(
            f"grid has {len(candidates)} configs > --max-configs {args.max_configs}")

    for inst in instances:
        with open(inst.ref_path) as f:
            inst.reference_segments = formats.parse_audacity_segments(f.read(), side="ref")
        inst.out_dir = None  # the tuner never writes clips

    # Split the candidates by statics (ring shapes and scored band): each
    # group runs as one batched pass with the group's first config as the
    # primary machine and the whole group as alternative machines. A
    # dynamic-only grid is exactly one group. The base config rides its
    # matching group (or its own) for the baseline row.
    fft_size = config.vad_config.fft_size
    groups: dict = {}
    for cand in candidates:
        groups.setdefault(group_key(cand, fft_size), []).append(cand)
    base_key = group_key(base_mc, fft_size)
    groups.setdefault(base_key, [])
    base_idx = len(groups[base_key])
    groups[base_key].append(base_mc)

    rows = []
    base_agg = None
    for g, (gkey, cands) in enumerate(groups.items()):
        if len(groups) > 1:
            print(f"[group {g + 1}/{len(groups)}: {len(cands)} configs]", file=sys.stderr)
        gconfig = dataclasses.replace(
            config,
            vad_config=dataclasses.replace(
                config.vad_config,
                vad_machine_config=cands[0],
                alt_vad_machine_configs=tuple(cands),
            ),
        )
        run_batched(instances, gconfig, device)
        for k, cand in enumerate(cands):
            # All candidates score with the SAME ignore floor (the base
            # config's, 0.7 s by default) so rows are comparable: the
            # reference hardcodes this floor in its eval config too
            # (simulator.zig:127-133), independent of the machine's own
            # min_vad_duration_sec.
            agg = score(instances, [inst.alt_vad_segments[k] for inst in instances],
                        base_mc.min_vad_duration_sec)
            if gkey == base_key and k == base_idx:
                base_agg = agg
            else:
                rows.append((agg, cand))

    def sort_key(row):
        agg = row[0]
        f = agg.f_score if agg.f_score == agg.f_score else -1.0  # NaN-safe
        fm = agg.fm_index if agg.fm_index == agg.fm_index else -1.0
        return (f, fm)

    rows.sort(key=sort_key, reverse=True)

    width = max(15, max(len(k) for k in keys))
    hdr = "  ".join(k.ljust(width) for k in keys)
    print(f"{'rank':<5} {hdr} {'TPR':>7} {'PPV':>7} {'F(0.7)':>7} {'FM':>7}")

    def row_txt(label, agg, cfg):
        vals = "  ".join(f"{getattr(cfg, k):<{width}.3g}" for k in keys)
        return (f"{label:<5} {vals} "
                f"{100 * agg.true_positive_rate.avg:>6.1f}% "
                f"{100 * agg.precision.avg:>6.1f}% "
                f"{100 * agg.f_score:>6.1f}% {100 * agg.fm_index:>6.1f}%")

    for rank, (agg, cand) in enumerate(rows[: args.top], 1):
        print(row_txt(str(rank), agg, cand))
    print(row_txt("base", base_agg, base_mc))

    if args.out:
        best = rows[0][1]
        snippet = {"vad_config": {"vad_machine_config": dataclasses.asdict(best)}}
        with open(args.out, "w") as f:
            json.dump(snippet, f, indent=2)
        print(f"\nbest config written: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
