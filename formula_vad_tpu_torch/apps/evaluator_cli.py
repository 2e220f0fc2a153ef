"""Standalone VAD scorer CLI — the ``vad-evaluator`` executable
(src/Evaluator.zig:32-88).

Usage: python -m formula_vad_tpu.apps.evaluator_cli -i vad.txt -r reference.txt
"""

from __future__ import annotations

import argparse
import sys

from ..config import StatConfig
from ..eval import formats, init_and_run, report, statistics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Evaluate VAD output against reference labels.")
    ap.add_argument("-i", "--input", required=True, help="Input file to evaluate.")
    ap.add_argument("-r", "--reference", required=True, help="Reference file to evaluate against.")
    args = ap.parse_args(argv)

    with open(args.input) as f:
        input_segments = formats.parse_audacity_segments(f.read(), side="vad")
    with open(args.reference) as f:
        ref_segments = formats.parse_audacity_segments(f.read(), side="ref")

    ev = init_and_run(input_segments, ref_segments)
    # Matches the reference CLI's hardcoded config (Evaluator.zig:69-75).
    stats = statistics.from_evaluator(ev, StatConfig(ignore_shorter_than_sec=0.7))
    sys.stdout.write(report.evaluator_report(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
