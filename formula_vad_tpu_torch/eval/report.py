"""Simulation report rendering — byte-compatible with the reference's
``src/simulator/report_generator.zig`` output (the table in README.md:26-61).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..config import StatConfig
from . import statistics
from .evaluator import Evaluator

DEFINITIONS = (
    "P   (Positives):                            Total duration of real speech segments (from reference labels)\n"
    "TP  (True positives):                       Duration of correctly detected speech segments\n"
    "FP  (False positives):                      Duration of incorrectly detected speech segments\n"
    "FN  (False negatives):                      Duration of missed speech segments\n"
    "TPR (True positive rate, sensitivity):      Probability that VAD detects a real speech segment. = TP / P \n"
    "PPV (Precision, Positive predictive value): Probability that detected speech segment is true.   = TP / (TP + FP) \n"
    "FNR (False negative rate, miss rate):       Probability that VAD misses a speech segment.       = FN / P \n"
    "FDR (False discovery rate):                 Probability that detected speech segment is false.  = FP / (TP + FP) "
)


def _row(name: str, s: statistics.SingleStats) -> str:
    return (
        f"| {name: >30} | {s.total_positives_sec: >4.0f} | {s.true_positives_sec: >4.0f} "
        f"| {s.false_positives_sec: >4.0f} | {s.false_negatives_sec: >4.0f} "
        f"| {s.true_positive_rate * 100: >5.1f}% | {s.precision * 100: >5.1f}% "
        f"| {s.false_negative_rate * 100: >7.1f}% | {s.false_discovery_rate * 100: >7.1f}% |\n"
    )


def simulation_report(
    names: Sequence[str],
    evaluators: Sequence[Optional[Evaluator]],
    stat_config: StatConfig,
) -> str:
    """Render the per-instance table + aggregate block
    (report_generator.zig:29-116)."""
    out: List[str] = []
    out.append(f"\n\n=> Definitions\n\n{DEFINITIONS}")
    out.append("\n\n=> Performance Report\n\n")
    out.append(
        f"| {'Name': >30} | {'P': >4} | {'TP': >4} | {'FP': >4} | {'FN': >4} "
        f"| {'TPR': >6} | {'PPV': >6} | {'FNR (!)': >8} | {'FDR (!)': >8} |\n"
    )
    out.append(
        f"| {'':->30} | {'':->4} | {'':->4} | {'':->4} | {'':->4} "
        f"| {'':->6} | {'':->6} | {'':->8} | {'':->8} |\n"
    )

    all_stats: List[statistics.SingleStats] = []
    for name, ev in zip(names, evaluators):
        if ev is None:
            continue
        stats = statistics.from_evaluator(ev, stat_config)
        all_stats.append(stats)
        out.append(_row(name, stats))

    agg = statistics.aggregate(all_stats)
    out.append("\n=> Aggregate stats \n\n")
    out.append(f"Total speech duration  (P): {agg.total_positives_sec: >7.1f} sec\n")
    out.append(f"True positives        (TP): {agg.true_positives_sec: >7.1f} sec\n")
    out.append(f"False positives       (FP): {agg.false_positives_sec: >7.1f} sec\n")
    out.append(f"False negatives       (FN): {agg.false_negatives_sec: >7.1f} sec")
    out.append("    Min.    Avg.    Max. \n")
    for label, a in (
        ("True positive rate   (TPR)", agg.true_positive_rate),
        ("Precision            (PPV)", agg.precision),
        ("False negative rate  (FNR)", agg.false_negative_rate),
        ("False discovery rate (FDR)", agg.false_discovery_rate),
    ):
        out.append(
            f"{label}:   {a.overall * 100: >5.1f}%  |  {a.min * 100: >5.1f}% /{a.avg * 100: >5.1f}% /{a.max * 100: >5.1f}% \n"
        )
    out.append(f"F-Score (β = {agg.f_score_beta: >5.2f})       :   {agg.f_score * 100: >5.1f}% \n")
    out.append(f"Fowlkes-Mallows index     :   {agg.fm_index * 100: >5.1f}% \n")
    return "".join(out)


def evaluator_report(stats: statistics.SingleStats) -> str:
    """Standalone scorer output (Evaluator.zig:69-88)."""
    out: List[str] = []
    out.append("\n=> Definitions: \n\n")
    out.append(DEFINITIONS)
    out.append("\n\n=> Report: \n\n")
    out.append(f"Total speech duration  (P):  {stats.total_positives_sec: >5.1f} sec\n")
    out.append(f"True positives        (TP):  {stats.true_positives_sec: >5.1f} sec\n")
    out.append(f"False positives       (FP):  {stats.false_positives_sec: >5.1f} sec\n")
    out.append(f"False negatives       (FN):  {stats.false_negatives_sec: >5.1f} sec\n")
    out.append(f"True positive rate   (TPR):  {stats.true_positive_rate * 100: >6.2f} %\n")
    out.append(f"False negative rate  (FNR):  {stats.false_negative_rate * 100: >6.2f} %\n")
    out.append(f"Precision            (PPV):  {stats.precision * 100: >6.2f} %\n")
    out.append(f"False discovery rate (FDR):  {stats.false_discovery_rate * 100: >6.2f} %\n")
    return "".join(out)
