"""Virtual (massless) interaction sites (counterpart of
mollytpu/ops/virtual_sites.py).

Four site types, each placed from up to three parent atoms p1, p2, p3 with
r12 = MIC(p2 - p1) and r13 = MIC(p3 - p1), in the JAX package's forms:

    one         x = p1
    average2    x = p1 + w2 r12
    average3    x = p1 + w2 r12 + w3 r13
    outOfPlane  x = p1 + w1 r12 + w2 r13 + w3 (r12 x r13)

All four are one formula, x = p1 + a12 r12 + a13 r13 + ac (r12 x r13), with
per-site coefficients (a12, a13, ac) set from the type at build; adding a
zero term changes no bit, so the placement equals the JAX package's.

The JAX package moves a site's force onto its parents with jax.vjp of the
placement. Here the chain rule is written out: with f the site's force,
g12 = a12 f + ac (r13 x f) and g13 = a13 f + ac (f x r12); p2 takes g12,
p3 takes g13 and p1 takes f - g12 - g13 (the minimum image's rounding has
zero gradient). Site rows are zeroed first, as in the JAX package. Sites
carry zero mass, so the integrators give them no acceleration and place
them after each move.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device

SITE_ONE = 0
SITE_AVG2 = 1
SITE_AVG3 = 2
SITE_OOP = 3

SITE_TYPES = {"one": SITE_ONE, "average2": SITE_AVG2,
              "average3": SITE_AVG3, "outOfPlane": SITE_OOP}


@dataclasses.dataclass(frozen=True)
class VirtualSites:
    """Sites as rows: atom index, type, parents (unused slots 0) and the
    three weights of the force field; ``coef`` holds (a12, a13, ac)."""

    site_idx: torch.Tensor   # (S,) int64
    site_type: torch.Tensor  # (S,) int64
    parents: torch.Tensor    # (S, 3) int64
    weights: torch.Tensor    # (S, 3)
    coef: torch.Tensor = None  # (S, 3), from site_type and weights

    def __post_init__(self):
        if self.coef is None:
            t, w = self.site_type, self.weights
            zero = torch.zeros_like(w[:, 0])
            oop = t == SITE_OOP
            a12 = torch.where(t == SITE_ONE, zero,
                              torch.where(oop, w[:, 0], w[:, 1]))
            a13 = torch.where(t == SITE_AVG3, w[:, 2],
                              torch.where(oop, w[:, 1], zero))
            ac = torch.where(oop, w[:, 2], zero)
            object.__setattr__(self, "coef",
                               torch.stack([a12, a13, ac], dim=1))

    @property
    def n_sites(self) -> int:
        return int(self.site_idx.shape[0])

    @classmethod
    def build(cls, sites, dtype=torch.float32, device=None):
        """sites: (site atom index, type name, parent indices, weights) per
        site, as the force field's templates give them."""
        device = resolve_device(device)
        idx, types, par, w = [], [], [], []
        for (s, name, parents, weights) in sites:
            idx.append(int(s))
            types.append(SITE_TYPES[name])
            par.append((list(parents) + [0, 0, 0])[:3])
            w.append((list(weights) + [0.0, 0.0, 0.0])[:3])
        return cls.from_arrays(idx, types, np.asarray(par).reshape(-1, 3),
                               np.asarray(w, dtype=np.float64).reshape(-1, 3),
                               dtype=dtype, device=device)

    @classmethod
    def from_arrays(cls, site_idx, site_type, parents, weights,
                    dtype=torch.float32, device=None):
        device = resolve_device(device)

        def index(x):
            return torch.as_tensor(np.array(x, dtype=np.int64),
                                   device=device)
        return cls(index(site_idx), index(site_type), index(parents),
                   torch.as_tensor(np.array(weights), dtype=dtype,
                                   device=device))

    def _geometry(self, coords, boundary):
        """(p1, r12, r13, coef) at the sites' parents."""
        p = coords[self.parents]                          # (S, 3, 3)
        r = boundary.displacement(p[:, :1], p[:, 1:])     # (S, 2, 3)
        return p[:, 0], r[:, 0], r[:, 1], self.coef.to(coords.dtype)

    def positions(self, coords, boundary):
        """(S, 3) site positions from their parents."""
        p1, r12, r13, c = self._geometry(coords, boundary)
        return (p1 + c[:, 0:1] * r12 + c[:, 1:2] * r13
                + c[:, 2:3] * torch.linalg.cross(r12, r13))

    def place(self, coords, boundary):
        """The coordinates with every site set from its parents."""
        return coords.index_copy(0, self.site_idx,
                                 self.positions(coords, boundary))

    def distribute_forces(self, coords, boundary, forces):
        """The forces with each site's force moved onto its parents by the
        chain rule of the placement; site rows end at zero."""
        f = forces[self.site_idx]
        _, r12, r13, c = self._geometry(coords, boundary)
        g12 = c[:, 0:1] * f + c[:, 2:3] * torch.linalg.cross(r13, f)
        g13 = c[:, 1:2] * f + c[:, 2:3] * torch.linalg.cross(f, r12)
        extra = torch.stack([f - g12 - g13, g12, g13], dim=1)  # (S, 3, 3)
        out = forces.index_fill(0, self.site_idx, 0.0)
        return out.index_add_(0, self.parents.reshape(-1),
                              extra.reshape(-1, 3))
