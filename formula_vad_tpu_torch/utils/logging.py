"""Scoped logging, mirroring the reference's std.log scopes.

The reference uses per-scope log levels (main.zig:12-23, simulator.zig:21-34)
with scopes ``main, pipeline, vad, vad_sm, recorder, mrb_recorder,
sim_instance, simulator``.  Here each scope is a stdlib logger under the
``fvad`` namespace with the same names; ``configure()`` applies per-scope
levels like the reference's ``std_options.log_scope_levels``.
"""

from __future__ import annotations

import logging
import sys
from typing import Mapping, Optional

SCOPES = (
    "main",
    "pipeline",
    "vad",
    "vad_sm",
    "recorder",
    "mrb_recorder",
    "sim_instance",
    "simulator",
)


def scoped(scope: str) -> logging.Logger:
    return logging.getLogger(f"fvad.{scope}")


def configure(
    default_level: int = logging.INFO,
    scope_levels: Optional[Mapping[str, int]] = None,
    stream=None,
) -> None:
    """Configure the fvad logger tree (idempotent)."""
    root = logging.getLogger("fvad")
    root.setLevel(default_level)
    if not root.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(levelname)s [%(name)s] %(message)s")
        )
        root.addHandler(handler)
    for scope, level in (scope_levels or {}).items():
        scoped(scope).setLevel(level)


# The reference simulator runs with warn-level logging for the noisy scopes
# (simulator.zig:21-34).
SIMULATOR_SCOPE_LEVELS = {"vad_sm": logging.WARNING, "vad": logging.WARNING}
