"""Audacity label-track parsing and serialization.

Mirrors ``src/Evaluator/formats.zig``: labels are TSV lines
``from_sec<TAB>to_sec<TAB>label``; parsing skips lines without two tab-split
float fields; serialization writes 4-decimal times, VAD segments first (with
their debug comment, UNMATCHED-prefixed when no reference overlaps), then
unmatched reference segments annotated ``missed``.
"""

from __future__ import annotations

from typing import List

from .evaluator import Evaluator, SpeechSegment


def parse_audacity_segments(text: str, side: str = "ref") -> List[SpeechSegment]:
    segments: List[SpeechSegment] = []
    for line in text.replace("\r", "").split("\n"):
        fields = line.split("\t")
        if len(fields) < 2:
            continue
        try:
            from_sec = float(fields[0])
            to_sec = float(fields[1])
        except ValueError:
            continue
        segments.append(SpeechSegment(from_sec=from_sec, to_sec=to_sec, side=side))
    return segments


def serialize_evaluator_to_audacity_txt(ev: Evaluator) -> str:
    out = []
    for seg in ev.input_segments:
        out.append(f"{seg.from_sec:.4f}\t{seg.to_sec:.4f}\t{seg.to_comment()}\n")
    for ref in ev.reference_segments:
        if ref.has_match():
            continue
        out.append(f"{ref.from_sec:.4f}\t{ref.to_sec:.4f}\tmissed\n")
    return "".join(out)
