"""Segment evaluator: match VAD segments against reference labels.

Mirrors ``src/Evaluator.zig``: both segment lists are sorted by start time,
re-numbered 1..N, and each segment records every opposite-side segment it
overlaps (any-overlap, strictly > 0 seconds).  The reference does this with
an O(n^2) pointer-chasing loop; here the overlap matrix is one vectorized
numpy broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SpeechSegment:
    """Evaluation-side segment (src/Evaluator/SpeechSegment.zig)."""

    from_sec: float
    to_sec: float
    side: str  # "vad" | "ref"
    id: int = -1
    opposite_indices: Optional[List[int]] = None
    debug_info: Optional[str] = None

    def duration(self) -> float:
        return self.to_sec - self.from_sec

    def overlap_with(self, other: "SpeechSegment") -> float:
        return min(self.to_sec, other.to_sec) - max(self.from_sec, other.from_sec)

    def has_match(self) -> bool:
        return bool(self.opposite_indices)

    def to_comment(self) -> str:
        # SpeechSegment.zig:33-39
        info = self.debug_info or ""
        return info if self.has_match() else f"UNMATCHED {info}"


@dataclasses.dataclass
class Evaluator:
    input_segments: List[SpeechSegment]
    reference_segments: List[SpeechSegment]


def init_and_run(
    input_segments: List[SpeechSegment], reference_segments: List[SpeechSegment]
) -> Evaluator:
    """Sort, renumber, and cross-match both sides (Evaluator.zig:90-156)."""
    inputs = sorted((dataclasses.replace(s) for s in input_segments), key=lambda s: s.from_sec)
    refs = sorted((dataclasses.replace(s) for s in reference_segments), key=lambda s: s.from_sec)
    for i, s in enumerate(inputs):
        s.id = i + 1
        s.side = "vad"
    for i, s in enumerate(refs):
        s.id = i + 1
        s.side = "ref"

    if inputs and refs:
        a_from = np.array([s.from_sec for s in inputs])[:, None]
        a_to = np.array([s.to_sec for s in inputs])[:, None]
        b_from = np.array([s.from_sec for s in refs])[None, :]
        b_to = np.array([s.to_sec for s in refs])[None, :]
        overlap = np.minimum(a_to, b_to) - np.maximum(a_from, b_from)
        matches = overlap > 0.0
        for i, s in enumerate(inputs):
            s.opposite_indices = list(np.nonzero(matches[i])[0])
        for j, s in enumerate(refs):
            s.opposite_indices = list(np.nonzero(matches[:, j])[0])
    else:
        for s in inputs:
            s.opposite_indices = []
        for s in refs:
            s.opposite_indices = []

    return Evaluator(input_segments=inputs, reference_segments=refs)
