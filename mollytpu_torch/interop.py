"""External calculators and the calculator facade (counterpart of
mollytpu/interop.py:25-154).

``ExternalCalculator`` wraps a host Python energy/force function (an ASE
calculator, a model in another framework, ...) as a general interaction.
The JAX package crosses its jit boundary with ``jax.pure_callback``; here
the host function is called directly: the coordinates go to the host and
the energy and forces come back to the device, one host sync per call, by
design. ``Calculator`` exposes a built System's force engine as plain
energy / forces functions of the coordinates for external optimizers
and training loops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: eV -> kJ/mol (mollytpu/interop.py:104)
EV_TO_KJMOL = 96.48533212331002


def _host64(x):
    return np.asarray(x.detach().cpu().numpy(), np.float64)


@dataclasses.dataclass(frozen=True)
class ExternalCalculator:
    """General interaction backed by a host function.

    fn(coords (N, 3) nm, box (3,) nm, numpy float64) -> (energy kJ/mol,
    forces (N, 3) kJ/mol/nm). ``fn_virial(coords, box)`` -> the (3, 3)
    virial (kJ/mol). Under periodic boundaries the virial cannot be
    recovered from absolute coordinates (-sum x (x) f depends on the
    wrapping), so a periodic virial without ``fn_virial`` raises; in an
    open box the absolute form is exact."""

    fn: object
    n_atoms: int = 0
    fn_virial: object = None

    def _call(self, coords, boundary, with_virial=False):
        c = _host64(coords)
        b = _host64(boundary.side_lengths)
        e, f = self.fn(c, b)
        out = [torch.as_tensor(np.asarray(e, np.float64).reshape(()),
                               dtype=coords.dtype, device=coords.device),
               torch.as_tensor(np.asarray(f, np.float64).reshape(c.shape),
                               dtype=coords.dtype, device=coords.device)]
        if with_virial:
            v = self.fn_virial(c, b)
            out.append(torch.as_tensor(
                np.asarray(v, np.float64).reshape(3, 3), dtype=coords.dtype,
                device=coords.device))
        return tuple(out)

    def energy(self, coords, boundary, atoms):
        return self._call(coords, boundary)[0]

    def force_virial(self, coords, boundary, atoms, needs_virial=False):
        if self.fn_virial is not None:
            _, f, vir = self._call(coords, boundary, with_virial=True)
            return f, vir
        _, f = self._call(coords, boundary)
        periodic = bool(torch.isfinite(boundary.side_lengths).any())
        if not periodic:
            return f, -torch.einsum("na,nb->ab", coords, f)
        if needs_virial:
            raise ValueError(
                "ExternalCalculator cannot compute a virial under periodic "
                "boundaries from forces alone; pass fn_virial (e.g. from an "
                "ASE stress tensor) to run NPT with an external potential")
        return f, torch.zeros((3, 3), dtype=coords.dtype,
                              device=coords.device)

    @classmethod
    def from_ase(cls, ase_atoms, calc, n_atoms=0, use_stress=False):
        """Wrap an ASE calculator (duck-typed: ``set_positions``,
        ``set_cell``, ``calc``, ``get_potential_energy``, ``get_forces``,
        ``get_stress``): nm -> Angstrom in, eV -> kJ/mol out. With
        use_stress the calculator's stress supplies the periodic virial
        (W = -V sigma)."""

        def place(coords_nm, box_nm):
            ase_atoms.set_positions(coords_nm * 10.0)
            if np.all(np.isfinite(box_nm)):
                ase_atoms.set_cell(np.diag(box_nm * 10.0))
            ase_atoms.calc = calc

        def fn(coords_nm, box_nm):
            place(coords_nm, box_nm)
            e = ase_atoms.get_potential_energy() * EV_TO_KJMOL
            f = ase_atoms.get_forces() * (EV_TO_KJMOL / 0.1)
            return e, f

        fn_virial = None
        if use_stress:
            def fn_virial(coords_nm, box_nm):
                place(coords_nm, box_nm)
                s = np.asarray(ase_atoms.get_stress(voigt=False))
                s = s * (EV_TO_KJMOL * 1000.0)   # eV/A^3 -> kJ/mol/nm^3
                return -float(np.prod(box_nm)) * s

        return cls(fn=fn, n_atoms=n_atoms, fn_virial=fn_virial)


class Calculator:
    """A System's force engine as functions of the coordinates (a fresh
    list at each call), for external optimizers and training loops."""

    def __init__(self, sys):
        self.sys = sys

    def _at(self, coords):
        from .ops.neighbors import find_neighbors
        sys = self.sys
        c = torch.as_tensor(coords, dtype=sys.coords.dtype,
                            device=sys.device)
        s = sys.update(coords=c)
        return s, find_neighbors(s.neighbor_finder, c, s.boundary,
                                 s.exclusions, 0)

    def energy(self, coords):
        from .forces import potential_energy
        return potential_energy(*self._at(coords))

    def forces(self, coords):
        from .forces import forces
        return forces(*self._at(coords))

    def energy_and_forces(self, coords):
        return self.energy(coords), self.forces(coords)
