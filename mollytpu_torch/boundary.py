"""Orthorhombic periodic boxes and minimum-image math
(counterpart of mollytpu/boundary.py; triclinic boxes are not ported yet).

Infinite side lengths mark non-periodic axes, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Orthorhombic:
    """Cubic / rectangular box. ``side_lengths`` is a (3,) tensor in nm."""

    side_lengths: torch.Tensor

    def volume(self):
        return torch.prod(self.side_lengths)

    def box_matrix(self):
        return torch.diag(self.side_lengths)

    def _periodic(self):
        box = self.side_lengths
        periodic = torch.isfinite(box)
        return periodic, torch.where(periodic, box, torch.ones_like(box))

    def displacement(self, xi, xj):
        """Minimum-image vector from xi to xj, over (..., 3) tensors."""
        dr = xj - xi
        periodic, safe = self._periodic()
        shift = torch.where(periodic, torch.round(dr / safe),
                            torch.zeros_like(dr))
        return dr - shift * torch.where(periodic, self.side_lengths,
                                        torch.zeros_like(safe))

    def wrap(self, x):
        periodic, safe = self._periodic()
        wrapped = x - torch.floor(x / safe) * safe
        return torch.where(periodic, wrapped, x)

    def fractional(self, x):
        return x / self.side_lengths

    def to(self, device=None, dtype=None):
        return Orthorhombic(self.side_lengths.to(device=device, dtype=dtype))


def cubic(side, dtype=torch.float32, device=None):
    """Same side length (nm) on all three axes."""
    return Orthorhombic(torch.full((3,), float(side), dtype=dtype,
                                   device=device))


def rectangular(sides, dtype=torch.float32, device=None):
    return Orthorhombic(torch.as_tensor(sides, dtype=dtype, device=device))
