"""Water boxes: TIP3P (and TIP4P-Ew) lattices written as PDB files, the
port's test and bench system, and SPC water as GROMACS files.

Waters sit on a lattice in one fixed orientation (H1 at +0.9572 A along
x, H2 at (-0.2400, +0.9266, 0) A from the oxygen), the geometry of
bench._tiny_waterbox_pdb in the JAX package. ``water_box_pdb(64,
spacing=6.5)`` writes that 64-water, 26 A box byte for byte; the default
density gives liquid water (33.43 molecules/nm^3).

``angles`` other than (90, 90, 90) give a triclinic cell with a = b = c:
the lattice then lives in fractional coordinates of the cell. ``angles=
DODECAHEDRON`` is the rhombic dodecahedron with a square xy face, the
usual solvent box of GROMACS, whose volume is d^3 / sqrt(2).

``model="tip4pew"`` writes a fourth row per water, the massless site M of
TIP4P-Ew at its average3 position from O, H1 and H2 (``TIP4PEW_XML``),
with a blank element column: both packages' PDB readers then take the
element from the atom name ("M"), which is neither O nor H, so the rigid
water triangle and the hydrogen constraints leave the site alone.

``water_box_gromacs`` writes such a TIP3P box as a .gro and a .top.
``spc_topology`` writes the topology of SPC water, rigid by [ settles ],
with the parameters of GROMACS's oplsaa.ff/spc.itp. ``SPC_TILE`` is an
equilibrated periodic box of 1,000 SPC waters (made by
``data/make_spc_tile.py``), and ``tile_gro`` lays n x n x n copies of such
a box side by side into one, as ``gmx solvate`` fills a box with copies of
spc216.gro, in the form ``read_gro`` returns, which ``system_from_gromacs``
takes in place of a file; ``write_gro`` writes waters as a .gro.
"""

from __future__ import annotations

import math
import os

import numpy as np

#: liquid water at 300 K and 1 bar, molecules per nm^3
WATER_DENSITY = 33.43

#: CRYST1 angles (alpha, beta, gamma) of the xy-square rhombic dodecahedron
DODECAHEDRON = (60.0, 60.0, 90.0)

_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

#: the force fields the water boxes are written for: TIP3P, and the
#: four-site TIP4P-Ew with its virtual site M
TIP3P_XML = os.path.join(_DATA, "tip3p_standard.xml")
TIP4PEW_XML = os.path.join(_DATA, "tip4pew.xml")

#: TIP4P-Ew's average3 weights of H1 and H2 for the site M (d_OM 0.0125 nm)
TIP4PEW_M_WEIGHT = 0.106676721

#: the water models water_box_pdb writes
WATER_MODELS = ("tip3p", "tip4pew")

#: an equilibrated periodic box of 1,000 SPC waters at 300 K
SPC_TILE = os.path.join(_DATA, "spc1000.gro")


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
                  spacing=None, angles=(90.0, 90.0, 90.0), model="tip3p"):
    """Write a PDB of ``n_waters`` waters to ``path`` and return it: TIP3P's
    three atoms each, or with ``model="tip4pew"`` also TIP4P-Ew's site M.

    The lattice has m = ceil(n_waters^(1/3)) sites along each cell edge;
    ``n_waters`` of the m^3 sites are picked with
    ``numpy.random.default_rng(seed).choice`` and kept in lattice order.
    ``spacing`` (A) fixes the lattice constant and so the cell edge (m *
    spacing); otherwise the cell holds ``n_waters`` at ``density``
    molecules/nm^3. ``angles`` (degrees) shape the cell; a triclinic cell
    places site (i, j, k) at fractional ((i, j, k) + 1/2) / m."""
    if model not in WATER_MODELS:
        raise ValueError(f"model must be one of {WATER_MODELS}, got "
                         f"{model!r}")
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
        rows = [("O", (ox, oy, oz), "O"),
                ("H1", (ox + 0.9572, oy, oz), "H"),
                ("H2", (ox - 0.2400, oy + 0.9266, oz), "H")]
        if model == "tip4pew":
            w = TIP4PEW_M_WEIGHT
            rows.append(("M", (ox + w * (0.9572 - 0.2400),
                               oy + w * 0.9266, oz), ""))
        for name, (x, y, z), element in rows:
            lines.append(
                "HETATM%5d %4s %-4sA%4d    %8.3f%8.3f%8.3f"
                "  1.00  0.00          %2s" % (
                    serial, (" " + name).ljust(4)[:4], "HOH",
                    res, x, y, z, element))
            serial += 1
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


#: TIP3P in a GROMACS topology: the in-repo XML's parameters (nm, kJ/mol,
#: e), LJ on O only, the fudge factors of its NonbondedForce
_TIP3P_TOP = """; TIP3P water, the parameters of tip3p_standard.xml
[ defaults ]
; nbfunc  comb-rule  gen-pairs  fudgeLJ  fudgeQQ
1         2          yes        0.5      0.833333

[ atomtypes ]
; name  at.num  mass      charge  ptype  sigma                epsilon
OW      8       15.99943  0.0     A      0.31507524065751241  0.635968
HW      1       1.007947  0.0     A      1.0                  0.0

[ moleculetype ]
; name  nrexcl
SOL     2

[ atoms ]
;  nr  type  resnr  res  atom  cgnr  charge  mass
   1   OW    1      SOL  OW    1     -0.834  15.99943
   2   HW    1      SOL  HW1   1     0.417   1.007947
   3   HW    1      SOL  HW2   1     0.417   1.007947

[ settles ]
; OW  funct  doh      dhh
1     1      0.09572  {dhh!r}

[ system ]
TIP3P water box

[ molecules ]
SOL  {n}
"""


def water_box_gromacs(pdb_path, gro_path, top_path):
    """Write a TIP3P water box PDB of water_box_pdb as GROMACS files: a .gro
    of its coordinates (nm, the format's 3 decimals) and orthorhombic box,
    and a .top of TIP3P's parameters with the water rigid by [ settles ]
    (d_OH 0.09572 nm, d_HH from the XML's 104.52 degree angle). Returns
    (gro_path, top_path)."""
    from .pdb import read_pdb
    struct = read_pdb(pdb_path)
    if struct.box is None or struct.box.ndim != 1:
        raise ValueError("water_box_gromacs writes orthorhombic boxes")
    write_gro(gro_path, struct.coords, struct.box, title="TIP3P water box")
    dhh = 2.0 * 0.09572 * math.sin(0.5 * 1.82421813418)
    with open(top_path, "w") as fh:
        fh.write(_TIP3P_TOP.format(dhh=dhh, n=struct.n_atoms // 3))
    return gro_path, top_path


#: SPC water in a GROMACS topology: oplsaa.ff's opls_116 (OW) and opls_117
#: (HW) and its spc.itp, rigid by [ settles ] (d_OH 0.1 nm, d_HH 0.16330 nm)
_SPC_TOP = """; SPC water, the parameters of oplsaa.ff/spc.itp
[ defaults ]
; nbfunc  comb-rule  gen-pairs  fudgeLJ  fudgeQQ
1         3          yes        0.5      0.5

[ atomtypes ]
; name  at.num  mass      charge  ptype  sigma        epsilon
OW      8       15.99940  -0.82   A      3.16557e-01  6.50194e-01
HW      1       1.00800   0.41    A      0.00000e+00  0.00000e+00

[ moleculetype ]
; name  nrexcl
SOL     2

[ atoms ]
;  nr  type  resnr  res  atom  cgnr  charge  mass
   1   OW    1      SOL  OW    1     -0.82   15.99940
   2   HW    1      SOL  HW1   1     0.41    1.00800
   3   HW    1      SOL  HW2   1     0.41    1.00800

[ settles ]
; OW  funct  doh  dhh
1     1      0.1  0.16330

[ exclusions ]
1  2  3
2  1  3
3  1  2

[ system ]
SPC water

[ molecules ]
SOL  {n}
"""

#: SPC's rigid geometry (nm)
SPC_DOH, SPC_DHH = 0.1, 0.16330


def spc_topology(path, n_waters):
    """Write the .top of ``n_waters`` SPC waters to ``path``; returns it."""
    with open(path, "w") as fh:
        fh.write(_SPC_TOP.format(n=int(n_waters)))
    return path


def write_gro(path, coords, box, title="SPC water", velocities=None):
    """Write waters (O, H1, H2 per molecule, residue SOL) as a .gro:
    coordinates (nm) with the format's 3 decimals, velocities (nm/ps) with
    4 where given, and the orthorhombic box's edges. Returns ``path``."""
    coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
    n = coords.shape[0]
    res = (np.arange(n) // 3 + 1) % 100000
    serial = (np.arange(n) + 1) % 100000
    names = np.array(["   OW", "  HW1", "  HW2"])[np.arange(n) % 3]
    fields = [np.char.mod("%5d", res), np.full(n, "SOL  "), names,
              np.char.mod("%5d", serial)]
    fields += [np.char.mod("%8.3f", coords[:, k]) for k in range(3)]
    if velocities is not None:
        v = np.asarray(velocities, dtype=np.float64).reshape(-1, 3)
        fields += [np.char.mod("%8.4f", v[:, k]) for k in range(3)]
    lines = fields[0]
    for f in fields[1:]:
        lines = np.char.add(lines, f)
    with open(path, "w") as fh:
        fh.write(f"{title}\n{n:5d}\n")
        fh.write("\n".join(lines.tolist()))
        fh.write("\n%10.5f%10.5f%10.5f\n" % tuple(np.asarray(box,
                                                             np.float64)))
    return path


def tile_gro(gro, n):
    """n x n x n copies of a periodic orthorhombic box laid side by side,
    from and as ``models.gromacs.read_gro`` gives a .gro (names, residue
    names, residue numbers, coordinates, velocities, the box's edges): the
    copy at offset (i, j, k) box before (i, j, k + 1) and so on, each with
    the box's atoms in their order and its residues numbered on from the
    copy before. Each copy is the box's own periodic image, so the tiled
    box is periodic too."""
    names, res_names, res_nums, coords, vels, box = gro
    copies = n ** 3
    box = np.asarray(box, dtype=np.float64).reshape(3)
    ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                   axis=-1).reshape(-1, 1, 3)
    coords = (np.asarray(coords, dtype=np.float64).reshape(1, -1, 3)
              + ijk * box).reshape(-1, 3)
    edges = n * box
    nums = np.asarray(res_nums, dtype=np.int64)
    span = int(nums.max()) if nums.size else 0
    nums = (nums[None, :] + span * np.arange(copies)[:, None]).reshape(-1)
    return (list(names) * copies, list(res_names) * copies, nums.tolist(),
            coords, np.tile(np.asarray(vels, dtype=np.float64), (copies, 1)),
            edges)
