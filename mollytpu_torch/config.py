"""Strictness levels for recoverable setup-time problems
(counterpart of mollytpu/config.py:69-87)."""

from __future__ import annotations

import os
import warnings

STRICTNESS_LEVELS = ("warn", "nowarn", "error")


def strictness(override: str | None = None) -> str:
    """Per-call override if given, else ``MOLLYTPU_STRICTNESS``, else warn."""
    level = (override or os.environ.get("MOLLYTPU_STRICTNESS", "warn")).lower()
    if level not in STRICTNESS_LEVELS:
        raise ValueError(
            f"strictness must be one of {STRICTNESS_LEVELS}, got {level!r}")
    return level


def report_issue(msg: str, level: str | None = None) -> None:
    """Raise, warn or stay silent about a setup-time problem."""
    level = strictness(level)
    if level == "error":
        raise ValueError(msg)
    if level == "warn":
        warnings.warn(msg, stacklevel=3)
