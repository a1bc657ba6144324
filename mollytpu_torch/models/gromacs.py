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
tensors on the device and a CellListNeighborFinder, so a GROMACS system
runs the neighbor-table engine (ops/nonbonded.py), not the pair kernel.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np
import torch

from .. import boundary as bnd
from ..atoms import AtomData, make_atoms
from ..config import resolve_device
from ..ops import bonded
from ..ops.constraints import SHAKERattle
from ..ops.cutoffs import DistanceCutoff
from ..ops.ewald import PME, EwaldExclusionCorrection, ewald_error_alpha
from ..ops.mixing import GeometricMixing, LorentzMixing
from ..ops.neighbors import CellListNeighborFinder
from ..ops.pairwise import (Coulomb, CoulombEwald, CoulombReactionField,
                            LennardJones)
from ..system import Exclusions, System, molecule_ids_from_bonds
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


def _replicate(top):
    """Every molecule of [molecules] in order: per-atom type, charge and
    mass, the bonded rows, the bonds, the [pairs] and the settle
    triplets (mollytpu/models/gromacs.py:312-392)."""
    atype, charge, mass = [], [], []
    bonds_all, pairs_all, settles = [], [], []
    rows = {k: [] for k in ("bond", "angle", "ub", "pt", "rb", "ht")}
    offset = 0
    for mol_name, count in top.molecule_order:
        mol = top.molecules.get(mol_name)
        if mol is None:
            mol = top.synthesize_molecule(mol_name)
        for _ in range(count):
            off = offset
            for (t, q, m, _, _) in mol.atoms:
                atype.append(t)
                charge.append(q)
                mass.append(m)
            for (i, j, func, params) in mol.bonds:
                if params is None or len(params) < 2:
                    params = top.bond_params(mol.atoms[i][0],
                                             mol.atoms[j][0])
                if params is None:
                    raise ValueError(f"no bond params for {mol.atoms[i][0]}-"
                                     f"{mol.atoms[j][0]}")
                bonds_all.append((off + i, off + j))
                rows["bond"].append((off + i, off + j, params[1], params[0]))
            for (i, j) in mol.pairs:
                pairs_all.append((off + i, off + j))
            for (i, j, k, func, params) in mol.angles:
                if params is None or len(params) < 2:
                    params = top.angle_params(mol.atoms[i][0],
                                              mol.atoms[j][0],
                                              mol.atoms[k][0])
                if params is None:
                    raise ValueError("missing angle params")
                th0 = math.radians(params[0])
                if func == 5 and len(params) >= 4:
                    rows["ub"].append((off + i, off + j, off + k, params[1],
                                       th0, params[3], params[2]))
                else:
                    rows["angle"].append((off + i, off + j, off + k,
                                          params[1], th0))
            for (i, j, k, l, func, params) in mol.dihedrals:
                atoms4 = (off + i, off + j, off + k, off + l)
                if params is None or len(params) == 0:
                    params = top.dihedral_params(
                        mol.atoms[i][0], mol.atoms[j][0], mol.atoms[k][0],
                        mol.atoms[l][0], func)
                    if params is None:
                        raise ValueError(f"missing dihedral params func "
                                         f"{func}")
                else:
                    params = [params] if func in (1, 9, 4) else params
                if func in (1, 9, 4):
                    for p in (params if isinstance(params, list)
                              else [params]):
                        p = list(p)
                        kk = p[1]
                        if kk != 0.0:
                            rows["pt"].append(atoms4 + (
                                p[2] if len(p) > 2 else 1.0,
                                math.radians(p[0]), kk))
                elif func == 3:
                    rows["rb"].append(atoms4 + (tuple(params)
                                                + (0.0,) * 6)[:6])
                elif func == 2:
                    rows["ht"].append(atoms4 + (params[1] / 2.0,
                                                math.radians(params[0])))
            for (ow, doh, dhh) in mol.settles:
                settles.append((off + ow, off + ow + 1, off + ow + 2, doh,
                                dhh))
                bonds_all.append((off + ow, off + ow + 1))
                bonds_all.append((off + ow, off + ow + 2))
            offset += len(mol.atoms)
    return atype, charge, mass, bonds_all, pairs_all, settles, rows


def _gromacs_lists(rows, dtype, device):
    """The bonded lists in the JAX package's order: bonds, angles,
    Urey-Bradley, periodic, RB and harmonic torsions."""
    kw = dict(dtype=dtype, device=device)

    def cols(name, arity):
        """The rows' atom index columns and their parameter columns."""
        arr = np.array(rows[name], dtype=np.float64)
        return ([arr[:, m].astype(np.int64) for m in range(arity)],
                arr[:, arity:].T)
    lists = []
    if rows["bond"]:
        (i, j), (k, r0) = cols("bond", 2)
        lists.append(bonded.harmonic_bonds(i, j, k=k, r0=r0, **kw))
    if rows["angle"]:
        (i, j, k), (ka, t0) = cols("angle", 3)
        lists.append(bonded.harmonic_angles(i, j, k, k=ka, theta0=t0, **kw))
    if rows["ub"]:
        # GROMACS gives theta, k_theta, r13, k_UB; the JAX package's reader
        # stores k_UB as r0 and r13 as kbond, and the port mirrors it
        # (ROADMAP Queue 3)
        (i, j, k), (ka, t0, r0, kb) = cols("ub", 3)
        lists.append(bonded.urey_bradleys(i, j, k, kangle=ka, theta0=t0,
                                          kbond=kb, r0=r0, **kw))
    if rows["pt"]:
        (i, j, k, l), (per, phase, kt) = cols("pt", 4)
        lists.append(bonded.periodic_torsions(
            i, j, k, l, periodicity=per, phase=phase, k=kt, **kw))
    if rows["rb"]:
        (i, j, k, l), coeffs = cols("rb", 4)
        lists.append(bonded.rb_torsions(i, j, k, l, coeffs=coeffs.T, **kw))
    if rows["ht"]:
        (i, j, k, l), (kt, t0) = cols("ht", 4)
        lists.append(bonded.harmonic_torsions(i, j, k, l, k=kt, theta0=t0,
                                              **kw))
    return tuple(lists)


def system_from_gromacs(gro_path, top_path, nonbonded_method="cutoff",
                        dist_cutoff=1.0, dist_neighbors=1.2,
                        neighbor_n_steps=10, solvent_dielectric=78.3,
                        pme_error_tol=0.0005, approximate_pme=True,
                        dtype=torch.float32, device=None, use_settles=False,
                        dispersion_correction=True, velocities_from_gro=True):
    """A System from GROMACS files on ``device`` (the CUDA card unless the
    caller names another), as the JAX package builds it
    (mollytpu/models/gromacs.py:295-502). nonbonded_method: "cutoff" (LJ
    truncation + reaction field), "pme" (LJ truncation + Ewald real space
    + PME + the exclusion correction) or anything else for plain LJ +
    Coulomb over all pairs; the LJ sigma mixing is geometric under
    comb-rule 3, else Lorentz. The listed interactions run on a
    CellListNeighborFinder of radius ``dist_neighbors``."""
    device = resolve_device(device)
    names, res_names, res_nums, coords, vels, box = read_gro(gro_path)
    top = GromacsTopology(top_path)
    atype, charge, mass, bonds_all, pairs_all, settles, rows = \
        _replicate(top)
    n = len(atype)
    if n != len(names):
        raise ValueError(f"topology atoms {n} != gro atoms {len(names)}")

    bond_set = sorted(set(bonds_all))
    excl_pairs, spec_auto = bfs_exclusions(_adjacency(n, bond_set), n)
    # [pairs] are the 1-4 set; other 1-4 pairs stay excluded
    spec_pairs = sorted({(min(a, b), max(a, b)) for (a, b) in pairs_all})
    spec_set = set(spec_pairs)
    excl_pairs = sorted(set(excl_pairs)
                        | {p for p in spec_auto if p not in spec_set})

    sigma = np.array([top.atomtypes[t][3] for t in atype])
    epsilon = np.array([top.atomtypes[t][4] for t in atype])
    tid = {t: i for i, t in enumerate(sorted(set(atype)))}
    atoms = make_atoms(n=n, mass=mass, charge=charge, sigma=sigma,
                       epsilon=epsilon, atom_type=[tid[t] for t in atype],
                       dtype=dtype, device=device)

    sig_mix = GeometricMixing() if top.comb_rule == 3 else LorentzMixing()
    rc = float(dist_cutoff)
    lj = LennardJones(cutoff=DistanceCutoff(rc), use_neighbors=True,
                      weight_special=top.fudge_lj, sigma_mixing=sig_mix)
    if nonbonded_method == "cutoff":
        pairwise = (lj, CoulombReactionField(
            dist_cutoff=rc, solvent_dielectric=solvent_dielectric,
            use_neighbors=True, weight_special=top.fudge_qq))
    elif nonbonded_method == "pme":
        pairwise = (lj, CoulombEwald(
            dist_cutoff=rc, error_tol=pme_error_tol, use_neighbors=True,
            weight_special=top.fudge_qq, approximate_erfc=approximate_pme))
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
        general.append(PME.setup(boundary, dist_cutoff=rc,
                                 error_tol=pme_error_tol, dtype=dtype))
        all_excl = excl_pairs + spec_pairs
        if all_excl:
            general.append(EwaldExclusionCorrection.setup(
                all_excl, ewald_error_alpha(rc, pme_error_tol),
                device=device))
    if dispersion_correction and nonbonded_method in ("cutoff", "pme"):
        general.append(make_dispersion_correction(sigma, epsilon, rc))

    finder = (CellListNeighborFinder.setup(boundary, float(dist_neighbors), n,
                                           n_steps=neighbor_n_steps)
              if nonbonded_method in ("cutoff", "pme") else None)
    exclusions = Exclusions.build(
        n, excl_pairs, spec_pairs,
        max_excl=_next8(_max_partners(excl_pairs, n)),
        max_special=_next8(_max_partners(spec_pairs, n)), device=device)
    mol_ids, n_mol = molecule_ids_from_bonds(n, bond_set, device=device)
    constraints = ()
    if use_settles and settles:
        cpairs, cdists = [], []
        for (o, h1, h2, doh, dhh) in settles:
            cpairs += [(o, h1), (o, h2), (h1, h2)]
            cdists += [doh, doh, dhh]
        constraints = (SHAKERattle.build(cpairs, cdists, dtype=dtype,
                                         device=device),)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return System(atoms=atoms, coords=t(coords), boundary=boundary,
                  velocities=t(vels) if velocities_from_gro else None,
                  pairwise_inters=pairwise,
                  specific_lists=_gromacs_lists(rows, dtype, device),
                  general_inters=tuple(general), exclusions=exclusions,
                  neighbor_finder=finder, molecule_ids=mol_ids,
                  n_molecules=n_mol, constraints=constraints,
                  atom_data=AtomData(
                      atom_name=np.asarray(names),
                      residue_name=np.asarray(res_names),
                      residue_number=np.asarray(res_nums),
                      chain_id=np.asarray(["A"] * n),
                      element=np.asarray([nm[0] if nm else "?"
                                          for nm in names]),
                      hetero_atom=np.asarray([False] * n)))
