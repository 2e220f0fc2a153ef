"""Duration-weighted TP/FP/FN statistics with extrude/fill-gap semantics.

Mirrors ``src/Evaluator/statistics.zig`` exactly:

* For each VAD segment, its matched reference segments are *extruded*
  (first start -extrude_start, last end +extrude_end) and gaps <= fill_gaps
  between consecutive matches are bridged (statistics.zig:191-256) before FP
  is computed — early/late VAD edges are deliberately not penalized because
  they cost nothing downstream.
* FP = max(0, vad_duration - overlap_with_extruded); TP = duration - FP.
* FN per reference segment = max(0, duration - overlap with matched VAD
  segments); references shorter than ignore_shorter_than_sec are skipped
  (statistics.zig:96-102).
* Total P = sum(TP) + sum(FN) — note P is *derived*, not the raw label sum.
* Derived rates, F-score (beta=0.7) and Fowlkes-Mallows (statistics.zig:104-113).

All accumulation is float32, like the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from ..config import StatConfig
from .evaluator import Evaluator, SpeechSegment

F32 = np.float32


@dataclasses.dataclass
class SingleStats:
    total_positives_sec: float = 0.0
    true_positives_sec: float = 0.0
    false_positives_sec: float = 0.0
    false_negatives_sec: float = 0.0
    true_positive_rate: float = float("nan")
    false_negative_rate: float = float("nan")
    false_discovery_rate: float = float("nan")
    precision: float = float("nan")
    fm_index: float = float("nan")
    f_score: float = float("nan")
    f_score_beta: float = 0.7


@dataclasses.dataclass
class AggStat:
    overall: float = float("nan")
    min: float = 2.0
    max: float = -2.0
    avg: float = float("nan")


@dataclasses.dataclass
class AggregateStats:
    total_positives_sec: float = 0.0
    true_positives_sec: float = 0.0
    false_positives_sec: float = 0.0
    false_negatives_sec: float = 0.0
    true_positive_rate: AggStat = dataclasses.field(default_factory=AggStat)
    false_negative_rate: AggStat = dataclasses.field(default_factory=AggStat)
    false_discovery_rate: AggStat = dataclasses.field(default_factory=AggStat)
    precision: AggStat = dataclasses.field(default_factory=AggStat)
    fm_index: float = float("nan")
    f_score: float = float("nan")
    f_score_beta: float = 0.7


def f_score(beta: float, precision: float, recall: float) -> float:
    b2 = F32(beta) ** 2
    return float((1 + b2) * (F32(precision) * F32(recall)) / (b2 * F32(precision) + F32(recall)))


def fm_index(precision: float, recall: float) -> float:
    return float(math.sqrt(F32(precision) * F32(recall)))


def extrude_segments(
    matches: List[SpeechSegment], config: StatConfig
) -> list[tuple[float, float]]:
    """Clone matched reference intervals, extrude ends, bridge small gaps
    (statistics.zig:219-243). ``matches`` must be in sorted order (they are:
    the evaluator sorts each side by start time)."""
    if not matches:
        return []
    spans = [[s.from_sec, s.to_sec] for s in matches]
    spans[0][0] -= config.extrude_start
    spans[-1][1] += config.extrude_end
    for i in range(len(spans) - 1):
        if spans[i + 1][0] - spans[i][1] <= config.fill_gaps:
            spans[i][1] = spans[i + 1][0]
    return [(a, b) for a, b in spans]


def _overlap_many(seg: SpeechSegment, spans: list[tuple[float, float]]) -> float:
    total = F32(0.0)
    for a, b in spans:
        total = F32(total + max(0.0, min(seg.to_sec, b) - max(seg.from_sec, a)))
    return float(total)


def calc_false_positive_sec(
    ev: Evaluator, vad_segment: SpeechSegment, config: StatConfig
) -> float:
    matches = [ev.reference_segments[j] for j in vad_segment.opposite_indices or []]
    spans = extrude_segments(matches, config)
    overlap = _overlap_many(vad_segment, spans)
    return max(0.0, float(F32(vad_segment.duration()) - F32(overlap)))


def calc_false_negative_sec(ev: Evaluator, ref_segment: SpeechSegment) -> float:
    matches = [ev.input_segments[j] for j in ref_segment.opposite_indices or []]
    overlap = F32(0.0)
    for m in matches:
        overlap = F32(overlap + max(0.0, ref_segment.overlap_with(m)))
    return max(0.0, float(F32(ref_segment.duration()) - overlap))


def from_evaluator(ev: Evaluator, config: StatConfig) -> SingleStats:
    s = SingleStats()
    tp = F32(0.0)
    fp = F32(0.0)
    fn = F32(0.0)
    p = F32(0.0)
    for seg in ev.input_segments:
        seg_fp = F32(calc_false_positive_sec(ev, seg, config))
        seg_tp = F32(max(0.0, float(F32(seg.duration()) - seg_fp)))
        fp = F32(fp + seg_fp)
        tp = F32(tp + seg_tp)
        p = F32(p + seg_tp)
    for ref in ev.reference_segments:
        if ref.duration() < config.ignore_shorter_than_sec:
            continue
        seg_fn = F32(calc_false_negative_sec(ev, ref))
        fn = F32(fn + seg_fn)
        p = F32(p + seg_fn)
    s.total_positives_sec = float(p)
    s.true_positives_sec = float(tp)
    s.false_positives_sec = float(fp)
    s.false_negatives_sec = float(fn)
    s.true_positive_rate = float(tp / p) if p else float("nan")
    s.false_negative_rate = float(fn / p) if p else float("nan")
    s.false_discovery_rate = float(fp / (fp + tp)) if (fp + tp) else float("nan")
    s.precision = float(tp / (tp + fp)) if (tp + fp) else float("nan")
    s.f_score_beta = 0.7
    s.f_score = f_score(0.7, s.precision, s.true_positive_rate)
    s.fm_index = fm_index(s.precision, s.true_positive_rate)
    return s


def aggregate(stats: List[SingleStats]) -> AggregateStats:
    agg = AggregateStats()
    sums = {"tpr": F32(0.0), "fnr": F32(0.0), "fdr": F32(0.0), "ppv": F32(0.0)}
    for s in stats:
        agg.total_positives_sec = float(F32(agg.total_positives_sec + F32(s.total_positives_sec)))
        agg.true_positives_sec = float(F32(agg.true_positives_sec + F32(s.true_positives_sec)))
        agg.false_positives_sec = float(F32(agg.false_positives_sec + F32(s.false_positives_sec)))
        agg.false_negatives_sec = float(F32(agg.false_negatives_sec + F32(s.false_negatives_sec)))
        for key, attr, agg_attr in (
            ("tpr", "true_positive_rate", agg.true_positive_rate),
            ("fnr", "false_negative_rate", agg.false_negative_rate),
            ("fdr", "false_discovery_rate", agg.false_discovery_rate),
            ("ppv", "precision", agg.precision),
        ):
            v = getattr(s, attr)
            sums[key] = F32(sums[key] + F32(v))
            agg_attr.min = min(agg_attr.min, v)
            agg_attr.max = max(agg_attr.max, v)
    n = len(stats)
    p = F32(agg.total_positives_sec)
    tp = F32(agg.true_positives_sec)
    fp = F32(agg.false_positives_sec)
    fn = F32(agg.false_negatives_sec)
    agg.true_positive_rate.overall = float(tp / p) if p else float("nan")
    agg.false_negative_rate.overall = float(fn / p) if p else float("nan")
    agg.false_discovery_rate.overall = float(fp / (fp + tp)) if (fp + tp) else float("nan")
    agg.precision.overall = float(tp / (tp + fp)) if (tp + fp) else float("nan")
    if n:
        agg.true_positive_rate.avg = float(sums["tpr"] / n)
        agg.false_negative_rate.avg = float(sums["fnr"] / n)
        agg.false_discovery_rate.avg = float(sums["fdr"] / n)
        agg.precision.avg = float(sums["ppv"] / n)
    agg.f_score_beta = 0.7
    agg.f_score = f_score(0.7, agg.precision.overall, agg.true_positive_rate.overall)
    agg.fm_index = fm_index(agg.precision.overall, agg.true_positive_rate.overall)
    return agg
