"""Strictness levels for recoverable setup-time problems and the registry
of the environment flags the port reads (counterpart of
mollytpu/config.py:21-97), and the default device of the port's entry
points."""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch

STRICTNESS_LEVELS = ("warn", "nowarn", "error")

#: every environment flag mollytpu_torch reads, with its default and
#: meaning (``describe_env`` renders it)
ENV_FLAGS = {
    "MOLLYTPU_STRICTNESS": (
        "warn", "setup-time issue handling: warn | nowarn | error"),
    "MOLLYTPU_AUTOTUNE_BUDGET": (
        "600", "wall-clock budget (s) for a cold tune_launch sweep; "
        "expansion stops early and keeps the best seen"),
    "MOLLYTPU_CACHE_DIR": (
        "~/.cache/mollytpu", "on-disk cache root (tune_launch's results in "
        "autotune_torch.json)"),
}


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


def tracks_grad(*tensors):
    """True when grad mode is on and one of ``tensors`` (None skipped)
    requires grad: the autograd force engines then keep their graph
    (``create_graph``), so that a gradient runs through the forces
    (sim.simulate.simulate_differentiable)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def atom_tensors(atoms):
    """The per-atom tensors of an Atoms (for ``tracks_grad``); none for
    anything else (a caller may pass no atoms)."""
    if not dataclasses.is_dataclass(atoms):
        return ()
    return tuple(getattr(atoms, f.name) for f in dataclasses.fields(atoms))


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


def describe_env() -> str:
    """A table of every flag of ENV_FLAGS, its current value and its
    default, in the JAX package's format."""
    lines = ["flag                        current    default    purpose"]
    for flag, (default, purpose) in sorted(ENV_FLAGS.items()):
        cur = os.environ.get(flag, "-")
        lines.append(f"{flag:<27} {cur:<10} {default:<10} {purpose}")
    return "\n".join(lines)
