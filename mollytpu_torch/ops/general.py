"""Whole-system interactions (counterpart of mollytpu/ops/general.py).

Protocol shared with ops/ewald.py:

    energy(coords, boundary, atoms) -> scalar tensor
    force_virial(coords, boundary, atoms, needs_virial) -> (forces, virial)
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import atom_tensors, tracks_grad


class GeneralInteraction:
    """Base of a user's general interaction, which defines ``energy``: the
    forces are -dE/dx by torch.autograd, and the virial is the JAX
    package's isotropic strain estimate W = -dE/d(eps) / 3 on the diagonal,
    with coordinates and box scaled by (1 + eps) (mollytpu/ops/general.py:
    33-57). When the coordinates or an atom parameter track grad, the
    forces keep their graph (create_graph)."""

    def force_virial(self, coords, boundary, atoms, needs_virial=False):
        graph = tracks_grad(coords, *atom_tensors(atoms))
        with torch.enable_grad():
            x = (coords if graph and coords.requires_grad
                 else coords.detach().requires_grad_(True))
            (grad,) = torch.autograd.grad(self.energy(x, boundary, atoms), x,
                                          create_graph=graph)
            vir = torch.zeros((3, 3), dtype=coords.dtype,
                              device=coords.device)
            if needs_virial:
                eps = torch.zeros((), dtype=coords.dtype,
                                  device=coords.device, requires_grad=True)
                scaled = self.energy(coords.detach() * (1.0 + eps),
                                     boundary.scale(1.0 + eps), atoms)
                (de,) = torch.autograd.grad(scaled, eps)
                vir = -torch.eye(3, dtype=coords.dtype,
                                 device=coords.device) * (de / 3.0)
        return -grad, vir


#: the Muller-Brown surface's four terms (mollytpu/ops/general.py:72-79)
MULLER_BROWN = {"A": (-200.0, -100.0, -170.0, 15.0),
                "a": (-1.0, -1.0, -6.5, 0.7),
                "b": (0.0, 0.0, 11.0, 0.6),
                "c": (-10.0, -10.0, -6.5, 0.7),
                "x0": (1.0, 0.0, -0.5, -1.0),
                "y0": (0.0, 0.5, 1.5, 1.0)}


@dataclasses.dataclass(frozen=True)
class MullerBrown(GeneralInteraction):
    """The Muller-Brown 2D test surface on every atom's (x, y)
    (mollytpu/ops/general.py:59-93): sum_k A_k exp(a_k dx^2 + b_k dx dy +
    c_k dy^2) with dx = x - x0_k, dy = y - y0_k. Each field is a (4,)
    tensor, the standard surface's by default."""

    A: torch.Tensor = None
    a: torch.Tensor = None
    b: torch.Tensor = None
    c: torch.Tensor = None
    x0: torch.Tensor = None
    y0: torch.Tensor = None

    def __post_init__(self):
        for name, value in MULLER_BROWN.items():
            if getattr(self, name) is None:
                object.__setattr__(self, name, torch.tensor(
                    value, dtype=torch.float64))

    def energy(self, coords, boundary, atoms):
        p = {k: getattr(self, k).to(coords.device, coords.dtype)
             for k in MULLER_BROWN}
        dx = coords[:, 0:1] - p["x0"]
        dy = coords[:, 1:2] - p["y0"]
        return torch.sum(p["A"] * torch.exp(p["a"] * dx ** 2
                                            + p["b"] * dx * dy
                                            + p["c"] * dy ** 2))


@dataclasses.dataclass(frozen=True)
class LJDispersionCorrection(GeneralInteraction):
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
