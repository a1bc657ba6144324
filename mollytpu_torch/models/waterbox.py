"""TIP3P water boxes written as PDB files, the port's test and bench system.

Waters sit on a cubic lattice in one fixed orientation (H1 at +0.9572 A
along x, H2 at (-0.2400, +0.9266, 0) A from the oxygen), the geometry of
bench._tiny_waterbox_pdb in the JAX package. ``water_box_pdb(64,
spacing=6.5)`` writes that 64-water, 26 A box byte for byte; the default
density gives liquid water (33.43 molecules/nm^3).
"""

from __future__ import annotations

import math
import os

import numpy as np

#: liquid water at 300 K and 1 bar, molecules per nm^3
WATER_DENSITY = 33.43

#: the force field the water boxes are written for
TIP3P_XML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "tip3p_standard.xml")


def water_box_pdb(path, n_waters, density=WATER_DENSITY, seed=0,
                  spacing=None):
    """Write a PDB of ``n_waters`` TIP3P waters to ``path`` and return it.

    The lattice has m = ceil(n_waters^(1/3)) sites per axis; ``n_waters`` of
    the m^3 sites are picked with ``numpy.random.default_rng(seed).choice``
    and kept in lattice order. ``spacing`` (A) fixes the lattice constant
    and so the box (m * spacing); otherwise the box holds ``n_waters`` at
    ``density`` molecules/nm^3."""
    m = int(math.ceil(round(n_waters ** (1.0 / 3.0), 9)))
    if spacing is None:
        side = 10.0 * (n_waters / float(density)) ** (1.0 / 3.0)   # A
        spacing = side / m
    else:
        side = m * float(spacing)
    rng = np.random.default_rng(seed)
    sites = np.sort(rng.choice(m ** 3, size=n_waters, replace=False))
    lines = ["CRYST1%9.3f%9.3f%9.3f  90.00  90.00  90.00 P 1           1"
             % (side, side, side)]
    serial = 1
    for res, site in enumerate(sites, start=1):
        i, rem = divmod(int(site), m * m)
        j, k = divmod(rem, m)
        half = 0.5 * spacing
        ox, oy, oz = half + spacing * i, half + spacing * j, half + spacing * k
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
