"""GROMACS .gro / .top ingestion (counterpart of mollytpu/models/gromacs.py).

Parses standalone topologies ([defaults] with the combination rule and the
fudge factors, [atomtypes], [bondtypes], [angletypes], [dihedraltypes]
with wildcards, [moleculetype] blocks with [atoms], [bonds], [pairs],
[angles], [dihedrals], [settles] and [exclusions], and [molecules]
replication) and .gro coordinates, velocities and box into a System.

Bonded functs: bonds 1 harmonic; angles 1 harmonic, 5 Urey-Bradley;
dihedrals 1/9 periodic, 2 harmonic improper, 3 Ryckaert-Bellemans, 4
periodic improper. [pairs] are the 1-4 set, weighted by fudgeLJ and
fudgeQQ; the other pairs within three bonds are excluded. [settles]
become SHAKE / RATTLE triangles with ``use_settles=True``. The parser is
the JAX package's plain Python; ``system_from_gromacs`` builds the port's
tensors on the device, each molecule type once and its copies with numpy.
Its listed interactions run on a CellListNeighborFinder and the
neighbor-table engine (ops/nonbonded.py) by default, as in the JAX
package, or with ``neighbor_finder="block"`` on the cluster-pair list and
the pair kernel, the port's main path. PME takes OpenMM's rule for its
splitting parameter and mesh, or GROMACS's (ewald-rtol, fourierspacing,
pme-order). ``gen_vel_start`` is GROMACS's start of a fresh run.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import defaultdict

import numpy as np
import torch

from .. import boundary as bnd
from ..atoms import AtomData, make_atoms
from ..config import resolve_device
from ..ops import bonded
from ..ops.constraints import SHAKERattle
from ..ops.cutoffs import DistanceCutoff
from ..ops.blockpairs import BlockPairFinder
from ..ops.ewald import (PME, EwaldExclusionCorrection, ewald_rtol_alpha,
                         pme_mesh_dims_spacing)
from ..ops.mixing import GeometricMixing, LorentzMixing
from ..ops.neighbors import CellListNeighborFinder
from ..ops.pairwise import (Coulomb, CoulombEwald, CoulombReactionField,
                            LennardJones)
from ..spatial import kinetic_energy, random_velocities, remove_cm_motion
from ..system import Exclusions, System, molecule_ids_from_bonds
from ..units import KB
from .setup import (_adjacency, _max_partners, _next8, bfs_exclusions,
                    make_dispersion_correction)


def read_gro(path):
    """Returns (names, res_names, res_nums, coords (N,3) nm, vels, box)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    n = int(lines[1])
    names, res_names, res_nums = [], [], []
    coords = np.zeros((n, 3))
    vels = np.zeros((n, 3))
    for i in range(n):
        ln = lines[2 + i]
        res_nums.append(int(ln[0:5]))
        res_names.append(ln[5:10].strip())
        names.append(ln[10:15].strip())
        coords[i] = [float(ln[20:28]), float(ln[28:36]), float(ln[36:44])]
        if len(ln) >= 68:
            vels[i] = [float(ln[44:52]), float(ln[52:60]), float(ln[60:68])]
    box_fields = [float(x) for x in lines[2 + n].split()]
    if len(box_fields) == 3:
        box = np.array(box_fields)
    else:
        v1 = [box_fields[0], box_fields[3], box_fields[4]]
        v2 = [box_fields[5], box_fields[1], box_fields[6]]
        v3 = [box_fields[7], box_fields[8], box_fields[2]]
        box = np.array([v1, v2, v3])
    return names, res_names, res_nums, coords, vels, box


def _tokens(line):
    line = line.split(";")[0].strip()
    return line.split() if line else []


@dataclasses.dataclass
class GmxMolecule:
    name: str = ""
    nrexcl: int = 3
    atoms: list = dataclasses.field(default_factory=list)   # (type, charge, mass, name, resname)
    bonds: list = dataclasses.field(default_factory=list)   # (i, j, func, params)
    pairs: list = dataclasses.field(default_factory=list)   # (i, j)
    angles: list = dataclasses.field(default_factory=list)
    dihedrals: list = dataclasses.field(default_factory=list)
    settles: list = dataclasses.field(default_factory=list) # (ow, doh, dhh)
    exclusions: list = dataclasses.field(default_factory=list)


class GromacsTopology:
    def __init__(self, path):
        self.comb_rule = 2
        self.fudge_lj = 1.0
        self.fudge_qq = 1.0
        self.gen_pairs = False
        self.atomtypes = {}      # name -> (btype, mass, charge, sigma, eps)
        self.bondtypes = {}      # (bi, bj) -> (b0, kb)
        self.angletypes = {}     # (bi, bj, bk) -> (th0, k, [ub])
        self.dihedraltypes = defaultdict(list)  # key -> [(func, params)]
        self.pairtypes = {}
        self.molecules = {}
        self.molecule_order = []  # [(name, count)]
        self.defines = {}
        self._parse(path)

    def _parse(self, path):
        section = None
        mol = None
        with open(path) as fh:
            raw_lines = fh.readlines()
        for raw in raw_lines:
            line = raw.split(";")[0].strip()
            if not line:
                continue
            if line.startswith("#define"):
                t = line.split()
                if len(t) >= 3:
                    self.defines[t[1]] = [float(x) for x in t[2:]
                                          if _is_num(x)]
                continue
            if line.startswith("#"):
                continue  # other preprocessor lines (standalone tops)
            if line.startswith("["):
                section = line.strip("[] ").lower()
                if section == "moleculetype":
                    mol = None
                continue
            t = line.split()
            if section == "defaults":
                self.comb_rule = int(t[1])
                if len(t) > 2:
                    self.gen_pairs = t[2].lower() in ("yes", "true", "1")
                if len(t) > 3:
                    self.fudge_lj = float(t[3])
                if len(t) > 4:
                    self.fudge_qq = float(t[4])
            elif section == "atomtypes":
                # flexible columns: name (btype) (atnum) mass charge ptype V W
                name = t[0]
                btype = t[1] if not _is_num(t[1]) else name
                floats = [float(x) for x in t if _is_num(x)]
                v, w = floats[-2], floats[-1]
                if len(floats) >= 4:
                    mass, chg = floats[-4], floats[-3]
                elif len(floats) == 3:
                    mass, chg = floats[0], 0.0
                else:
                    mass, chg = 0.0, 0.0
                if self.comb_rule == 1:
                    # V = C6, W = C12 -> convert to sigma/eps
                    if v > 0 and w > 0:
                        sigma = (w / v) ** (1.0 / 6.0)
                        eps = v * v / (4.0 * w)
                    else:
                        sigma, eps = 0.0, 0.0
                else:
                    sigma, eps = v, w
                self.atomtypes[name] = (btype, mass, chg, sigma, eps)
                # also key by bonded-type name (first definition wins), used
                # to synthesize solvent molecules from .gro atom names
                # (reference: setup.jl:1369-1390, 1422-1452)
                self.atomtypes.setdefault(btype.upper(), (btype, mass, chg,
                                                          sigma, eps))
            elif section == "bondtypes":
                self.bondtypes[(t[0], t[1])] = (float(t[3]), float(t[4]))
            elif section == "angletypes":
                self.angletypes[(t[0], t[1], t[2])] = tuple(
                    float(x) for x in t[4:])
            elif section == "dihedraltypes":
                if _is_num(t[2]):  # two-atom form: j k func params
                    key = ("X", t[0], t[1], "X")
                    func = int(t[2])
                    params = [float(x) for x in t[3:]]
                else:
                    key = (t[0], t[1], t[2], t[3])
                    func = int(t[4])
                    params = [float(x) for x in t[5:]]
                self.dihedraltypes[key].append((func, params))
            elif section == "pairtypes":
                self.pairtypes[(t[0], t[1])] = tuple(float(x) for x in t[3:])
            elif section == "moleculetype":
                mol = GmxMolecule(name=t[0], nrexcl=int(t[1]))
                self.molecules[t[0]] = mol
            elif section == "atoms" and mol is not None:
                # nr type resnr residue atom cgnr charge (mass)
                chg = float(t[6]) if len(t) > 6 else 0.0
                mss = float(t[7]) if len(t) > 7 else self.atomtypes.get(
                    t[1], ("", 0.0, 0, 0, 0))[1]
                mol.atoms.append((t[1], chg, mss, t[4], t[3]))
            elif section == "bonds" and mol is not None:
                params = self._inline_params(t[3:])
                mol.bonds.append((int(t[0]) - 1, int(t[1]) - 1, int(t[2]), params))
            elif section == "pairs" and mol is not None:
                mol.pairs.append((int(t[0]) - 1, int(t[1]) - 1))
            elif section == "angles" and mol is not None:
                params = self._inline_params(t[4:])
                mol.angles.append((int(t[0]) - 1, int(t[1]) - 1, int(t[2]) - 1,
                                   int(t[3]), params))
            elif section == "dihedrals" and mol is not None:
                params = self._inline_params(t[5:])
                mol.dihedrals.append((int(t[0]) - 1, int(t[1]) - 1,
                                      int(t[2]) - 1, int(t[3]) - 1,
                                      int(t[4]), params))
            elif section == "settles" and mol is not None:
                mol.settles.append((int(t[0]) - 1, float(t[2]), float(t[3])))
            elif section == "exclusions" and mol is not None:
                base = int(t[0]) - 1
                for other in t[1:]:
                    mol.exclusions.append((base, int(other) - 1))
            elif section == "molecules":
                self.molecule_order.append((t[0], int(t[1])))

    def _inline_params(self, tokens):
        """Numeric inline params, expanding #define macro names."""
        if not tokens:
            return None
        out = []
        for tok in tokens:
            if _is_num(tok):
                out.append(float(tok))
            elif tok in self.defines:
                out.extend(self.defines[tok])
            else:
                return None  # unknown macro: fall back to type lookup
        return tuple(out) if out else None

    def synthesize_molecule(self, name):
        """Create SOL (3-site water) / monatomic-ion moleculetypes missing
        from the topology, as the reference does for solvent atoms present
        only in the .gro file (setup.jl:1422-1452)."""
        mol = GmxMolecule(name=name, nrexcl=3)
        if name.upper() in ("SOL", "WAT", "HOH", "H2O"):
            for tname, atname in (("OW", "OW"), ("HW", "HW1"), ("HW", "HW2")):
                bt, mass, chg, sig, eps = self.atomtypes[tname]
                mol.atoms.append((tname, chg, mass, atname, name))
            b = self.bond_params("OW", "HW")
            mol.bonds.append((0, 1, 1, b))
            mol.bonds.append((0, 2, 1, b))
            a = self.angle_params("HW", "OW", "HW")
            mol.angles.append((1, 0, 2, 1, (a[0], a[1])))
        else:
            key = name.upper()
            if key not in self.atomtypes:
                raise KeyError(f"moleculetype {name} not in topology and not "
                               "a known solvent/ion")
            bt, mass, chg, sig, eps = self.atomtypes[key]
            if key == "CL" and chg == 0.0:
                chg = -1.0  # reference's charge fix (setup.jl:1425)
            if key in ("NA", "K", "LI") and chg == 0.0:
                chg = 1.0
            mol.atoms.append((key, chg, mass, name, name))
        self.molecules[name] = mol
        return mol

    # -- type resolution -------------------------------------------------------

    def btype(self, atype):
        return self.atomtypes[atype][0]

    def bond_params(self, t1, t2):
        b1, b2 = self.btype(t1), self.btype(t2)
        for key in ((b1, b2), (b2, b1)):
            if key in self.bondtypes:
                return self.bondtypes[key]
        return None

    def angle_params(self, t1, t2, t3):
        b = [self.btype(t) for t in (t1, t2, t3)]
        for key in (tuple(b), tuple(reversed(b))):
            if key in self.angletypes:
                return self.angletypes[key]
        return None

    def dihedral_params(self, t1, t2, t3, t4, func):
        b = [self.btype(t) for t in (t1, t2, t3, t4)]
        cands = []
        for key in (tuple(b), tuple(reversed(b))):
            cands.append(key)
        # wildcard forms
        for key in (("X", b[1], b[2], "X"), ("X", b[2], b[1], "X"),
                    (b[0], b[1], b[2], "X"), ("X", b[1], b[2], b[3]),
                    ("X", b[3], b[2], "X"), (b[3], b[2], b[1], "X")):
            cands.append(key)
        for key in cands:
            if key in self.dihedraltypes:
                matches = [p for (fn, p) in self.dihedraltypes[key] if fn == func]
                if matches:
                    return matches if func in (1, 9, 4) else matches[0]
        return None


def _is_num(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


#: the columns of atom indices at the front of each bonded row kind, and
#: the row's width with its parameters
ROW_ARITY = {"bond": 2, "angle": 3, "ub": 3, "pt": 4, "rb": 4, "ht": 4}
ROW_WIDTH = {"bond": 4, "angle": 5, "ub": 7, "pt": 7, "rb": 10, "ht": 6}


def _molecule_rows(top, mol):
    """One copy of ``mol`` at atom offset 0: per-atom type, charge and
    mass, the bonds, the [pairs], the settle rows (O, H1, H2, d_OH, d_HH)
    and the bonded rows (mollytpu/models/gromacs.py:312-392)."""
    atype = [a[0] for a in mol.atoms]
    charge = [a[1] for a in mol.atoms]
    mass = [a[2] for a in mol.atoms]
    bonds, pairs, settles = [], list(mol.pairs), []
    rows = {k: [] for k in ROW_ARITY}
    for (i, j, func, params) in mol.bonds:
        if params is None or len(params) < 2:
            params = top.bond_params(mol.atoms[i][0], mol.atoms[j][0])
        if params is None:
            raise ValueError(f"no bond params for {mol.atoms[i][0]}-"
                             f"{mol.atoms[j][0]}")
        bonds.append((i, j))
        rows["bond"].append((i, j, params[1], params[0]))
    for (i, j, k, func, params) in mol.angles:
        if params is None or len(params) < 2:
            params = top.angle_params(mol.atoms[i][0], mol.atoms[j][0],
                                      mol.atoms[k][0])
        if params is None:
            raise ValueError("missing angle params")
        th0 = math.radians(params[0])
        if func == 5 and len(params) >= 4:
            rows["ub"].append((i, j, k, params[1], th0, params[3],
                               params[2]))
        else:
            rows["angle"].append((i, j, k, params[1], th0))
    for (i, j, k, l, func, params) in mol.dihedrals:
        atoms4 = (i, j, k, l)
        if params is None or len(params) == 0:
            params = top.dihedral_params(
                mol.atoms[i][0], mol.atoms[j][0], mol.atoms[k][0],
                mol.atoms[l][0], func)
            if params is None:
                raise ValueError(f"missing dihedral params func {func}")
        else:
            params = [params] if func in (1, 9, 4) else params
        if func in (1, 9, 4):
            for p in (params if isinstance(params, list) else [params]):
                p = list(p)
                kk = p[1]
                if kk != 0.0:
                    rows["pt"].append(atoms4 + (
                        p[2] if len(p) > 2 else 1.0, math.radians(p[0]), kk))
        elif func == 3:
            rows["rb"].append(atoms4 + (tuple(params) + (0.0,) * 6)[:6])
        elif func == 2:
            rows["ht"].append(atoms4 + (params[1] / 2.0,
                                        math.radians(params[0])))
    for (ow, doh, dhh) in mol.settles:
        settles.append((ow, ow + 1, ow + 2, doh, dhh))
        bonds.append((ow, ow + 1))
        bonds.append((ow, ow + 2))
    return atype, charge, mass, bonds, pairs, settles, rows


def _pair_array(pairs):
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def _molecule_block(top, mol):
    """``_molecule_rows`` of one copy with, as arrays: its bond set (sorted,
    no repeats), its excluded pairs (graph distance 1-2, and 3 unless a
    [pairs] entry makes the pair a 1-4 one), its 1-4 pairs, and its
    molecule id per atom and number of molecules (the bond graph's
    components)."""
    atype, charge, mass, bonds, pairs, settles, rows = _molecule_rows(top,
                                                                     mol)
    n = len(atype)
    bond_set = sorted(set(bonds))
    excl, spec_auto = bfs_exclusions(_adjacency(n, bond_set), n)
    spec = sorted({(min(a, b), max(a, b)) for (a, b) in pairs})
    spec_set = set(spec)
    excl = sorted(set(excl) | {p for p in spec_auto if p not in spec_set})
    mol_ids, n_mol = molecule_ids_from_bonds(n, bond_set, device="cpu")
    return dict(atype=atype, charge=np.asarray(charge, dtype=np.float64),
                mass=np.asarray(mass, dtype=np.float64),
                bonds=_pair_array(bond_set), excl=_pair_array(excl),
                spec=_pair_array(spec),
                settles=np.asarray(settles, dtype=np.float64).reshape(-1, 5),
                rows={k: np.asarray(v, dtype=np.float64).reshape(
                    -1, ROW_WIDTH[k]) for k, v in rows.items()},
                mol_ids=mol_ids.numpy().astype(np.int64), n_mol=n_mol)


def _tiled(block_rows, count, n_atoms, offset, index_cols):
    """``count`` copies of one copy's rows, the copies' atom indices (the
    first ``index_cols`` columns) moved on by ``n_atoms`` each, starting
    at ``offset``."""
    shift = offset + n_atoms * np.arange(count, dtype=block_rows.dtype)
    out = np.repeat(block_rows[None], count, axis=0)
    out[:, :, :index_cols] += shift[:, None, None]
    return out.reshape(-1, block_rows.shape[1])


def _replicate(top):
    """Every molecule of [molecules] in order, each molecule type worked
    out once (``_molecule_block``) and its copies laid out with numpy:
    per-atom type, charge and mass, the bond set, the excluded and 1-4
    pairs, the settle rows, the bonded rows, the molecule id per atom and
    the number of molecules. The result is what working out every copy on
    its own gives: the molecules share no bond, so each one's exclusions
    and components are its own."""
    atype, charge, mass, mol_ids = [], [], [], []
    parts = {k: [] for k in ("bonds", "excl", "spec", "settles")}
    rows = {k: [] for k in ROW_ARITY}
    offset = n_mol = 0
    blocks = {}
    for mol_name, count in top.molecule_order:
        mol = top.molecules.get(mol_name)
        if mol is None:
            mol = top.synthesize_molecule(mol_name)
        if not count:
            continue
        if mol_name not in blocks:
            blocks[mol_name] = _molecule_block(top, mol)
        blk = blocks[mol_name]
        na = len(blk["atype"])
        atype.extend(blk["atype"] * count)
        charge.append(np.tile(blk["charge"], count))
        mass.append(np.tile(blk["mass"], count))
        for k, cols in (("bonds", 2), ("excl", 2), ("spec", 2),
                        ("settles", 3)):
            parts[k].append(_tiled(blk[k], count, na, offset, cols))
        for k, arity in ROW_ARITY.items():
            rows[k].append(_tiled(blk["rows"][k], count, na, offset, arity))
        ids = (blk["mol_ids"][None, :] + n_mol
               + blk["n_mol"] * np.arange(count)[:, None])
        mol_ids.append(ids.reshape(-1))
        offset += na * count
        n_mol += blk["n_mol"] * count

    def cat(arrays, width):
        return (np.concatenate(arrays) if arrays
                else np.zeros((0, width)))
    return dict(atype=atype, charge=cat(charge, 0).reshape(-1),
                mass=cat(mass, 0).reshape(-1),
                bonds=cat(parts["bonds"], 2).astype(np.int64),
                excl=cat(parts["excl"], 2).astype(np.int64),
                spec=cat(parts["spec"], 2).astype(np.int64),
                settles=cat(parts["settles"], 5),
                rows={k: cat(v, ROW_WIDTH[k]) for k, v in rows.items()},
                mol_ids=cat(mol_ids, 0).reshape(-1).astype(np.int64),
                n_mol=n_mol)


def _gromacs_lists(rows, dtype, device):
    """The bonded lists in the JAX package's order: bonds, angles,
    Urey-Bradley, periodic, RB and harmonic torsions, from the (rows,
    columns) arrays of ``_replicate``."""
    kw = dict(dtype=dtype, device=device)

    def cols(name, arity):
        """The rows' atom index columns and their parameter columns."""
        arr = np.asarray(rows[name], dtype=np.float64)
        return ([arr[:, m].astype(np.int64) for m in range(arity)],
                arr[:, arity:].T)
    lists = []
    if len(rows["bond"]):
        (i, j), (k, r0) = cols("bond", 2)
        lists.append(bonded.harmonic_bonds(i, j, k=k, r0=r0, **kw))
    if len(rows["angle"]):
        (i, j, k), (ka, t0) = cols("angle", 3)
        lists.append(bonded.harmonic_angles(i, j, k, k=ka, theta0=t0, **kw))
    if len(rows["ub"]):
        # GROMACS gives theta, k_theta, r13, k_UB; the JAX package's reader
        # stores k_UB as r0 and r13 as kbond, and the port mirrors it
        # (ROADMAP Queue 3)
        (i, j, k), (ka, t0, r0, kb) = cols("ub", 3)
        lists.append(bonded.urey_bradleys(i, j, k, kangle=ka, theta0=t0,
                                          kbond=kb, r0=r0, **kw))
    if len(rows["pt"]):
        (i, j, k, l), (per, phase, kt) = cols("pt", 4)
        lists.append(bonded.periodic_torsions(
            i, j, k, l, periodicity=per, phase=phase, k=kt, **kw))
    if len(rows["rb"]):
        (i, j, k, l), coeffs = cols("rb", 4)
        lists.append(bonded.rb_torsions(i, j, k, l, coeffs=coeffs.T, **kw))
    if len(rows["ht"]):
        (i, j, k, l), (kt, t0) = cols("ht", 4)
        lists.append(bonded.harmonic_torsions(i, j, k, l, k=kt, theta0=t0,
                                              **kw))
    return tuple(lists)


#: the neighbor_finder choices of system_from_gromacs
NEIGHBOR_FINDERS = ("cell", "block")


def _lorentz_berthelot_values(top, atype, sig_mix):
    """True where ``sig_mix`` gives Lorentz-Berthelot's value on every type
    pair present: the same sigma, or an epsilon of zero on either type."""
    if isinstance(sig_mix, LorentzMixing):
        return True
    types = sorted(set(atype))
    for a in types:
        for b in types[types.index(a):]:
            sa, ea = top.atomtypes[a][3], top.atomtypes[a][4]
            sb, eb = top.atomtypes[b][3], top.atomtypes[b][4]
            if ea * eb == 0.0:
                continue
            if not math.isclose(math.sqrt(sa * sb), 0.5 * (sa + sb),
                                rel_tol=1e-12, abs_tol=0.0):
                return False
    return True


def system_from_gromacs(gro_path, top_path, nonbonded_method="cutoff",
                        dist_cutoff=1.0, dist_neighbors=1.2,
                        neighbor_n_steps=10, solvent_dielectric=78.3,
                        pme_error_tol=0.0005, approximate_pme=True,
                        dtype=torch.float32, device=None, use_settles=False,
                        dispersion_correction=True, velocities_from_gro=True,
                        neighbor_finder="cell", ewald_rtol=None,
                        fourier_spacing=None, pme_order=5):
    """A System from GROMACS files on ``device`` (the CUDA card unless the
    caller names another), as the JAX package builds it
    (mollytpu/models/gromacs.py:295-502). ``gro_path`` is a .gro file or
    what ``read_gro`` returns for one (waterbox.tile_gro). nonbonded_method: "cutoff" (LJ
    truncation + reaction field), "pme" (LJ truncation + Ewald real space
    + PME + the exclusion correction) or anything else for plain LJ +
    Coulomb over all pairs; the LJ sigma mixing is geometric under
    comb-rule 3, else Lorentz. ``dispersion_correction=False`` is
    GROMACS's DispCorr = no.

    neighbor_finder: "cell" (the default, as in the JAX package) lists the
    interactions on a CellListNeighborFinder of radius ``dist_neighbors``
    for the neighbor-table engine; "block" on the cluster-pair list
    (BlockPairFinder) for the pair kernel, which takes Lorentz-Berthelot
    mixing only: a topology whose rule gives another value on a type pair
    present raises NotImplementedError (comb-rule 3 gives the same value
    where the sigmas are equal or an epsilon is zero, as in SPC water).

    PME follows OpenMM's rule from ``pme_error_tol`` unless given GROMACS's
    settings: ``ewald_rtol`` sets alpha by erfc(alpha rc) = ewald_rtol for
    the real space, PME and the exclusion correction alike;
    ``fourier_spacing`` (nm) sizes the mesh, rounded up to FFT-smooth
    sizes; ``pme_order`` is the B-spline order (GROMACS's pme-order, 4 by
    its default; the port's default 5).

    Molecule types are worked out once and their copies laid out with
    numpy (``_replicate``), so that a box of many identical molecules
    builds in seconds."""
    if neighbor_finder not in NEIGHBOR_FINDERS:
        raise ValueError(f"neighbor_finder must be one of "
                         f"{NEIGHBOR_FINDERS}, got {neighbor_finder!r}")
    device = resolve_device(device)
    gro = (read_gro(gro_path) if isinstance(gro_path, (str, os.PathLike))
           else gro_path)
    names, res_names, res_nums, coords, vels, box = gro
    top = GromacsTopology(top_path)
    rep = _replicate(top)
    atype = rep["atype"]
    n = len(atype)
    if n != len(names):
        raise ValueError(f"topology atoms {n} != gro atoms {len(names)}")
    excl_pairs, spec_pairs = rep["excl"], rep["spec"]

    type_params = {t: top.atomtypes[t] for t in set(atype)}
    sigma = np.array([type_params[t][3] for t in atype])
    epsilon = np.array([type_params[t][4] for t in atype])
    tid = {t: i for i, t in enumerate(sorted(set(atype)))}
    atoms = make_atoms(n=n, mass=rep["mass"], charge=rep["charge"],
                       sigma=sigma, epsilon=epsilon,
                       atom_type=[tid[t] for t in atype], dtype=dtype,
                       device=device)

    sig_mix = GeometricMixing() if top.comb_rule == 3 else LorentzMixing()
    listed = nonbonded_method in ("cutoff", "pme")
    if listed and neighbor_finder == "block":
        if not _lorentz_berthelot_values(top, atype, sig_mix):
            raise NotImplementedError(
                f"comb-rule {top.comb_rule} gives another LJ sigma than "
                "Lorentz-Berthelot on a type pair of this topology, and the "
                "pair kernel, which the cluster-pair list feeds, takes "
                "Lorentz-Berthelot mixing only: build with "
                "neighbor_finder=\"cell\"")
        sig_mix = LorentzMixing()
    rc = float(dist_cutoff)
    alpha = (None if ewald_rtol is None
             else ewald_rtol_alpha(rc, float(ewald_rtol)))
    lj = LennardJones(cutoff=DistanceCutoff(rc), use_neighbors=True,
                      weight_special=top.fudge_lj, sigma_mixing=sig_mix)
    if nonbonded_method == "cutoff":
        pairwise = (lj, CoulombReactionField(
            dist_cutoff=rc, solvent_dielectric=solvent_dielectric,
            use_neighbors=True, weight_special=top.fudge_qq))
    elif nonbonded_method == "pme":
        pairwise = (lj, CoulombEwald(
            dist_cutoff=rc, error_tol=pme_error_tol, use_neighbors=True,
            weight_special=top.fudge_qq, approximate_erfc=approximate_pme,
            alpha=alpha))
    else:
        pairwise = (LennardJones(weight_special=top.fudge_lj,
                                 sigma_mixing=sig_mix),
                    Coulomb(weight_special=top.fudge_qq))

    if box.ndim == 1:
        boundary = bnd.rectangular(box, dtype=dtype, device=device)
    else:
        boundary = bnd.triclinic(box, dtype=dtype, device=device)
    general = []
    if nonbonded_method == "pme":
        mesh = (None if fourier_spacing is None else pme_mesh_dims_spacing(
            boundary.side_lengths.detach().cpu().numpy(),
            float(fourier_spacing)))
        general.append(PME.setup(boundary, dist_cutoff=rc,
                                 error_tol=pme_error_tol, order=pme_order,
                                 dtype=dtype, mesh_dims=mesh, alpha=alpha))
        all_excl = np.concatenate([excl_pairs, spec_pairs])
        if len(all_excl):
            general.append(EwaldExclusionCorrection.setup(
                all_excl, general[0].alpha, device=device))
    if dispersion_correction and listed:
        general.append(make_dispersion_correction(sigma, epsilon, rc))

    finder = None
    if listed and neighbor_finder == "block":
        finder = BlockPairFinder.setup(boundary, float(dist_neighbors), n,
                                       atoms, n_steps=neighbor_n_steps)
    elif listed:
        finder = CellListNeighborFinder.setup(boundary, float(dist_neighbors),
                                              n, n_steps=neighbor_n_steps)
    exclusions = Exclusions.build(
        n, excl_pairs, spec_pairs,
        max_excl=_next8(_max_partners(excl_pairs, n)),
        max_special=_next8(_max_partners(spec_pairs, n)), device=device)
    mol_ids = torch.as_tensor(rep["mol_ids"].astype(np.int32), device=device)
    constraints = ()
    settles = rep["settles"]
    if use_settles and len(settles):
        constraints = (SHAKERattle.triangles(
            settles[:, :3].astype(np.int64),
            settles[:, [3, 3, 4]], dtype=dtype, device=device),)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    names = np.asarray(names)
    return System(atoms=atoms, coords=t(coords), boundary=boundary,
                  velocities=t(vels) if velocities_from_gro else None,
                  pairwise_inters=pairwise,
                  specific_lists=_gromacs_lists(rep["rows"], dtype, device),
                  general_inters=tuple(general), exclusions=exclusions,
                  neighbor_finder=finder, molecule_ids=mol_ids,
                  n_molecules=rep["n_mol"], constraints=constraints,
                  atom_data=AtomData(
                      atom_name=names,
                      residue_name=np.asarray(res_names),
                      residue_number=np.asarray(res_nums),
                      chain_id=np.full(n, "A"),
                      element=np.asarray([nm[0] if nm else "?"
                                          for nm in names.tolist()]),
                      hetero_atom=np.zeros(n, dtype=bool)))


def gen_vel_start(sys, temperature, generator):
    """The start of a GROMACS run with gen-vel = yes and continuation = no:
    the coordinates put on the constraints (SHAKE from themselves), wrapped
    into the box; Maxwell-Boltzmann velocities at ``temperature`` from
    ``generator`` (on the system's device) with the centre-of-mass motion
    removed and the constraints applied (RATTLE), then scaled to
    ``temperature`` exactly over the system's degrees of freedom."""
    m, box = sys.masses, sys.boundary
    x = sys.coords
    for c in sys.constraints:
        x, _ = c.apply_position_constraints(x, x, None, m, box, 1.0)
    v = remove_cm_motion(m, random_velocities(m, temperature, generator))
    for c in sys.constraints:
        v = c.apply_velocity_constraints(x, v, m, box)
    t_now = 2.0 * kinetic_energy(m, v) / (sys.n_dof * KB)
    return sys.update(coords=box.wrap(x),
                      velocities=v * torch.sqrt(temperature / t_now))
