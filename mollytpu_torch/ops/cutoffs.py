"""Cutoffs for pairwise interactions (counterpart of
mollytpu/ops/cutoffs.py:33-127).

A cutoff is a transform of the pair energy u(r): ``apply(u, r)`` returns
the cut energy, and forces come from the derivative of the composed energy
(ops/nonbonded.py), so force = -dE/dr holds for every cutoff by
construction. The pair kernel's spec (ops/pair_kernel.build_fused_spec)
reads the first four as tags and maps each onto an lj_mode.

Branches are ``torch.where`` with both operands finite and clamps are
``torch.minimum`` / ``torch.maximum`` on tensors, whose derivative at a
tie is 1/2 as jnp.minimum's is. ``r`` is clamped away from 0 by the
caller.
"""

from __future__ import annotations

import dataclasses

import torch


def _const(r, value):
    """A 0-d tensor of r's dtype and device (filled there: no host copy)."""
    return r.new_full((), float(value))


def _clip(x, lo, hi):
    """jnp.clip's minimum(maximum(x, lo), hi), tie derivatives included."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def _tracks_other_leaf(t, x):
    """Whether t's graph reaches a leaf that requires grad other than x
    (a walk over its autograd nodes, a few dozen for a pair energy)."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):            # AccumulateGrad: a leaf
            if fn.variable is not x:
                return True
            continue
        stack.extend(f for f, _ in fn.next_functions)
    return False


def _grad_at(u, r, at):
    """du/dr at the radius ``at``, per pair (the shape of r): JAX's
    jax.grad(u)(at). A constant in r. In grad mode, when u depends on atom
    parameters that require grad, it keeps its graph (create_graph), so
    that a gradient with respect to them includes it."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        x = torch.full_like(r, float(at)).requires_grad_(True)
        ux = u(x).sum()
        graph = outer and _tracks_other_leaf(ux, x)
        (g,) = torch.autograd.grad(ux, x, create_graph=graph)
    return g


@dataclasses.dataclass(frozen=True)
class NoCutoff:
    def apply(self, u, r):
        return u(r)


@dataclasses.dataclass(frozen=True)
class DistanceCutoff:
    """Plain truncation: the interaction is zero beyond dist_cutoff (nm)."""

    dist_cutoff: float

    def apply(self, u, r):
        rc = self.dist_cutoff
        return torch.where(r <= rc, u(torch.minimum(r, _const(r, rc))), 0.0)


@dataclasses.dataclass(frozen=True)
class ShiftedPotentialCutoff:
    """u(r) - u(rc) inside dist_cutoff, zero beyond."""

    dist_cutoff: float

    def apply(self, u, r):
        rc = _const(r, self.dist_cutoff)
        return torch.where(r <= rc, u(torch.minimum(r, rc)) - u(rc), 0.0)


@dataclasses.dataclass(frozen=True)
class ShiftedForceCutoff:
    """u(r) - u(rc) - (r - rc) u'(rc) inside dist_cutoff, zero beyond: both
    energy and force go to zero at the cutoff."""

    dist_cutoff: float

    def apply(self, u, r):
        rc = _const(r, self.dist_cutoff)
        du_rc = _grad_at(u, r, self.dist_cutoff)
        rs = torch.minimum(r, rc)
        return torch.where(r <= rc, u(rs) - u(rc) - (rs - rc) * du_rc, 0.0)


@dataclasses.dataclass(frozen=True)
class CubicSplineCutoff:
    """Hermite spline from (r_a, u(r_a), u'(r_a)) to (r_c, 0, 0); the raw
    potential below r_a."""

    dist_activation: float
    dist_cutoff: float

    def apply(self, u, r):
        ra = _const(r, self.dist_activation)
        rc = self.dist_cutoff
        width = rc - self.dist_activation
        t = _clip((r - ra) / width, 0.0, 1.0)
        pe_a = u(ra)
        dpe_a = _grad_at(u, r, self.dist_activation)
        spline = ((2 * t ** 3 - 3 * t ** 2 + 1) * pe_a
                  + (t ** 3 - 2 * t ** 2 + t) * width * dpe_a)
        raw = u(torch.minimum(r, ra))
        return torch.where(r <= ra, raw,
                           torch.where(r <= rc, spline, 0.0))


@dataclasses.dataclass(frozen=True)
class PolynomialCutoff:
    """OpenMM's fifth-order switch s(t) = 1 - 6 t^5 + 15 t^4 - 10 t^3 from
    r_a to r_c."""

    dist_activation: float
    dist_cutoff: float

    def apply(self, u, r):
        ra, rc = self.dist_activation, self.dist_cutoff
        t = _clip((r - ra) / (rc - ra), 0.0, 1.0)
        s = 1 - 6 * t ** 5 + 15 * t ** 4 - 10 * t ** 3
        return torch.where(r <= rc, s * u(torch.minimum(r, _const(r, rc))),
                           0.0)


def cutoff_distance(cutoff):
    """The outer interaction radius of a cutoff (None for NoCutoff)."""
    if isinstance(cutoff, NoCutoff):
        return None
    return float(cutoff.dist_cutoff)
