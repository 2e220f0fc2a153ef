"""UUID v4 generation/parsing with the reference's STRICT semantics.

Mirrors ``src/uuid.zig`` (vendored zig-uuid; dead code in the reference —
imported only by its test block, SURVEY.md §2.1): ``parse`` accepts ONLY
the canonical 36-character dashed form (uuid.zig:106-122) and rejects
everything else — unlike stdlib ``uuid.UUID``, which leniently accepts
braces, ``urn:uuid:`` prefixes and undashed hex. ``format`` emits the
canonical lowercase form; ``zero`` is the all-zero UUID constant.
Test vectors from uuid.zig:133-159 pass verbatim (tests/test_utils_and_
lowlatency.py).
"""

from __future__ import annotations

import uuid as _uuid

_DASHES = (8, 13, 18, 23)
_HEX = set("0123456789abcdefABCDEF")


class InvalidUUID(ValueError):
    """Raised by parse() on any non-canonical input (uuid.zig Error)."""


zero = _uuid.UUID(int=0)


def new_v4() -> str:
    return str(_uuid.uuid4())


def parse(text: str) -> _uuid.UUID:
    """Parse the canonical dashed form ONLY (uuid.zig:106-122)."""
    if len(text) != 36:
        raise InvalidUUID(f"expected 36 characters, got {len(text)}")
    for i, ch in enumerate(text):
        if i in _DASHES:
            if ch != "-":
                raise InvalidUUID(f"expected '-' at position {i}")
        elif ch not in _HEX:
            raise InvalidUUID(f"invalid hex character at position {i}")
    return _uuid.UUID(text)


def format(u: _uuid.UUID) -> str:  # noqa: A001 — mirrors the reference name
    return str(u)
