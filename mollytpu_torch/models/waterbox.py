"""TIP3P water boxes written as PDB files, the port's test and bench system.

Waters sit on a lattice in one fixed orientation (H1 at +0.9572 A along
x, H2 at (-0.2400, +0.9266, 0) A from the oxygen), the geometry of
bench._tiny_waterbox_pdb in the JAX package. ``water_box_pdb(64,
spacing=6.5)`` writes that 64-water, 26 A box byte for byte; the default
density gives liquid water (33.43 molecules/nm^3).

``angles`` other than (90, 90, 90) give a triclinic cell with a = b = c:
the lattice then lives in fractional coordinates of the cell. ``angles=
DODECAHEDRON`` is the rhombic dodecahedron with a square xy face, the
usual solvent box of GROMACS, whose volume is d^3 / sqrt(2).
"""

from __future__ import annotations

import math
import os

import numpy as np

#: liquid water at 300 K and 1 bar, molecules per nm^3
WATER_DENSITY = 33.43

#: CRYST1 angles (alpha, beta, gamma) of the xy-square rhombic dodecahedron
DODECAHEDRON = (60.0, 60.0, 90.0)

#: the force field the water boxes are written for
TIP3P_XML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "tip3p_standard.xml")


def _cell_basis(side, angles):
    """Rows a, b, c (A) of the reduced cell with all three edges ``side``
    and CRYST1 ``angles`` in degrees (models/pdb.py reads it back so)."""
    al, be, ga = (math.radians(float(x)) for x in angles)
    cx = side * math.cos(be)
    cy = side * (math.cos(al) - math.cos(be) * math.cos(ga)) / math.sin(ga)
    return np.array([[side, 0.0, 0.0],
                     [side * math.cos(ga), side * math.sin(ga), 0.0],
                     [cx, cy, math.sqrt(max(side * side - cx * cx - cy * cy,
                                            0.0))]])


def water_box_pdb(path, n_waters, density=WATER_DENSITY, seed=0,
                  spacing=None, angles=(90.0, 90.0, 90.0)):
    """Write a PDB of ``n_waters`` TIP3P waters to ``path`` and return it.

    The lattice has m = ceil(n_waters^(1/3)) sites along each cell edge;
    ``n_waters`` of the m^3 sites are picked with
    ``numpy.random.default_rng(seed).choice`` and kept in lattice order.
    ``spacing`` (A) fixes the lattice constant and so the cell edge (m *
    spacing); otherwise the cell holds ``n_waters`` at ``density``
    molecules/nm^3. ``angles`` (degrees) shape the cell; a triclinic cell
    places site (i, j, k) at fractional ((i, j, k) + 1/2) / m."""
    m = int(math.ceil(round(n_waters ** (1.0 / 3.0), 9)))
    ortho = tuple(float(x) for x in angles) == (90.0, 90.0, 90.0)
    if spacing is None:
        cal, cbe, cga = (math.cos(math.radians(float(x))) for x in angles)
        shape = 1.0 if ortho else math.sqrt(
            1.0 - cal * cal - cbe * cbe - cga * cga + 2.0 * cal * cbe * cga)
        side = 10.0 * (n_waters / float(density) / shape) ** (1.0 / 3.0)
        spacing = side / m
    else:
        side = m * float(spacing)
    basis = None if ortho else _cell_basis(side, angles)
    rng = np.random.default_rng(seed)
    sites = np.sort(rng.choice(m ** 3, size=n_waters, replace=False))
    lines = ["CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1"
             % ((side, side, side) + tuple(float(x) for x in angles))]
    serial = 1
    for res, site in enumerate(sites, start=1):
        i, rem = divmod(int(site), m * m)
        j, k = divmod(rem, m)
        if ortho:
            half = 0.5 * spacing
            ox, oy, oz = (half + spacing * i, half + spacing * j,
                          half + spacing * k)
        else:
            ox, oy, oz = ((np.array([i, j, k]) + 0.5) / m) @ basis
        for name, (x, y, z) in (("O", (ox, oy, oz)),
                                ("H1", (ox + 0.9572, oy, oz)),
                                ("H2", (ox - 0.2400, oy + 0.9266, oz))):
            lines.append(
                "HETATM%5d %4s %-4sA%4d    %8.3f%8.3f%8.3f"
                "  1.00  0.00          %2s" % (
                    serial, (" " + name).ljust(4)[:4], "HOH",
                    res, x, y, z, name[0]))
            serial += 1
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
