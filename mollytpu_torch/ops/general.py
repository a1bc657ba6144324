"""Whole-system interactions (counterpart of mollytpu/ops/general.py:96).

Protocol shared with ops/ewald.py:

    energy(coords, boundary, atoms) -> scalar tensor
    force_virial(coords, boundary, atoms, needs_virial) -> (forces, virial)
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LJDispersionCorrection:
    """Long-range LJ tail correction beyond a hard cutoff:

        E = (factor_6 + factor_12) / V

    with the factors of models.setup.make_dispersion_correction. Forces are
    zero; the tail virial is W_dd = 2 U6 + 4 U12."""

    factor_6: float = 0.0
    factor_12: float = 0.0
    dist_cutoff: float = 1.0

    def energy(self, coords, boundary, atoms):
        return (self.factor_6 + self.factor_12) / boundary.volume()

    def force_virial(self, coords, boundary, atoms, needs_virial=False):
        vir = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device)
        if needs_virial:
            vol = boundary.volume()
            vir = torch.eye(3, dtype=coords.dtype, device=coords.device) * (
                (2.0 * self.factor_6 + 4.0 * self.factor_12) / vol)
        return torch.zeros_like(coords), vir
