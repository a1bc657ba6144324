"""Strictness levels for recoverable setup-time problems
(counterpart of mollytpu/config.py:69-87) and the default device of the
port's entry points."""

from __future__ import annotations

import os
import warnings

import torch

STRICTNESS_LEVELS = ("warn", "nowarn", "error")


def resolve_device(device=None):
    """``device`` when one is given; otherwise the CUDA card. Raises when no
    card is present: the port never falls back to the CPU on its own, so a
    CPU run says ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mollytpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


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
