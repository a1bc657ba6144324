"""System construction from a PDB file and an OpenMM-format force field
(counterpart of mollytpu/models/setup.py:44-245, 291-764, 789-843).

Ported: nonbonded_method "cutoff" (LJ truncation + reaction field) and
"pme" (LJ truncation + Ewald real space + PME), each in an orthorhombic
or triclinic box, and "none"
(plain LJ + Coulomb over all pairs), open boundaries for a PDB without
CRYST1, NBFix pair overrides, the bonded terms (harmonic bonds and
angles, periodic and RB proper and improper torsions, Urey-Bradley,
CMAP), constraints "none", "hbonds", "allbonds" or "hangles" on SHAKE or
LINCS, rigid water, virtual sites from the residue templates, implicit
solvent (OBC1, OBC2, GBn2), hydrogen mass repartitioning, the LJ
dispersion correction, the neighbor finders, and position restraints on
a built system.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import boundary as bnd
from ..atoms import AtomData, make_atoms
from ..config import resolve_device
from ..ops import bonded
from ..ops.blockpairs import BlockPairFinder
from ..ops.cmap import cmap_coefficients, make_cmap_list
from ..ops.constraints import build_constrainers, setup_constraints
from ..ops.cutoffs import DistanceCutoff, ShiftedForceCutoff
from ..ops.ewald import PME, EwaldExclusionCorrection, ewald_error_alpha
from ..ops.gbsa import make_implicit_solvent
from ..ops.general import LJDispersionCorrection
from ..ops.mixing import (ExceptionTable, GeometricMixing, LorentzMixing,
                          MixingException)
from ..ops.neighbors import CellListNeighborFinder, DistanceNeighborFinder
from ..ops.pairwise import (CRF_SOLVENT_DIELECTRIC, Coulomb, CoulombEwald,
                            CoulombReactionField, LennardJones)
from ..ops.virtual_sites import VirtualSites
from ..system import Exclusions, System, molecule_ids_from_bonds
from .forcefield import detect_bonds, find_template_by_graph
from .pdb import read_pdb


def is_water(res_name):
    return res_name in ("HOH", "WAT", "TIP3", "TIP4", "SOL", "T3P", "T4P")


def _build_bonds(struct, templates, atom_map):
    """All bonds as (i, j) global index pairs."""
    bonds = set()
    for ri, tmpl in enumerate(templates):
        mapping = atom_map[ri]
        for (a, b) in tmpl.bonds:
            i, j = mapping[a], mapping[b]
            bonds.add((min(i, j), max(i, j)))
    # peptide / nucleic links between consecutive residues of a chain
    for ri in range(len(struct.residues) - 1):
        r1, r2 = struct.residues[ri], struct.residues[ri + 1]
        if r1.chain != r2.chain or is_water(r1.name) or is_water(r2.name):
            continue
        for (n1, n2, dmax) in (("C", "N", 0.25), ("O3'", "P", 0.25)):
            if n1 in r1.atom_names and n2 in r2.atom_names:
                i = r1.atom_indices[r1.atom_names.index(n1)]
                j = r2.atom_indices[r2.atom_names.index(n2)]
                if np.linalg.norm(struct.coords[i] - struct.coords[j]) < dmax:
                    bonds.add((min(i, j), max(i, j)))
    # disulfides
    sg = [i for i, (nm, el) in enumerate(zip(struct.atom_names,
                                             struct.elements))
          if nm == "SG" and el.upper() == "S"]
    for a in range(len(sg)):
        for b in range(a + 1, len(sg)):
            i, j = sg[a], sg[b]
            if np.linalg.norm(struct.coords[i] - struct.coords[j]) < 0.25:
                bonds.add((i, j))
    for (i, j) in struct.conect:
        bonds.add((min(i, j), max(i, j)))
    return sorted(bonds)


def _adjacency(n, bonds):
    adj = [[] for _ in range(n)]
    for (i, j) in bonds:
        adj[i].append(j)
        adj[j].append(i)
    for lst in adj:
        lst.sort()
    return adj


def build_angles(adj, bonds):
    """(i, j, k) with j central, i < k."""
    angles = set()
    for (b1, b2) in bonds:
        for a in adj[b1]:
            if a != b2:
                angles.add((a, b1, b2) if a < b2 else (b2, b1, a))
        for a in adj[b2]:
            if a != b1:
                angles.add((b1, b2, a) if a > b1 else (a, b2, b1))
    return sorted(angles)


def build_torsions(adj, angles):
    """(i, j, k, l) proper torsions with the i < l convention."""
    tors = set()
    for (a1, a2, a3) in angles:
        for a in adj[a1]:
            if a not in (a1, a2, a3):
                tors.add((a, a1, a2, a3) if a < a3 else (a3, a2, a1, a))
        for a in adj[a3]:
            if a not in (a1, a2, a3):
                tors.add((a1, a2, a3, a) if a > a1 else (a, a3, a2, a1))
    return sorted(tors)


def build_impropers(adj):
    """(center, j, k, l) for every atom with >= 3 neighbours."""
    imps = []
    for c, nb in enumerate(adj):
        m = len(nb)
        for x in range(m):
            for y in range(x + 1, m):
                for z in range(y + 1, m):
                    imps.append((c, nb[x], nb[y], nb[z]))
    return imps


def build_cmaps(adj, torsions):
    """Five-atom CMAP chains: each torsion extended by a neighbour of one
    of its ends."""
    cmaps = set()
    for tor in torsions:
        for a in adj[tor[0]]:
            if a not in tor:
                cmaps.add((a,) + tor)
        for a in adj[tor[3]]:
            if a not in tor:
                cmaps.add(tor + (a,))
    return sorted(cmaps)


def _improper_ordering(ff, rule, perm, c, j, k, l, struct, type_of):
    """OpenMM's atom order of an improper term: (p1, p2, center, p4), the
    central atom third (mollytpu/models/setup.py:172-245). The matched
    permutation puts the peripherals in the rule's pattern positions; the
    ordering's tie-break swaps follow, Amber's comparing (residue index,
    position in the residue)."""
    ordering = getattr(rule, "ordering", "default")
    res_of = struct.res_index_of_atom
    elements = struct.elements
    src = (c, j, k, l)
    j, k, l = (src[perm[m] - 1] for m in (1, 2, 3))

    def pos_in_res(a):
        return struct.residues[res_of[a]].atom_indices.index(a)

    def later(a, b):
        """Atom a comes after atom b in (residue, position) order."""
        return (res_of[a], pos_in_res(a)) > (res_of[b], pos_in_res(b))

    if ordering == "amber":
        key = (type_of if not rule.has_wild else elements)
        if key[j] == key[l] and later(j, l):
            j, l = l, j
        if key[k] == key[l] and later(k, l):
            k, l = l, k
        if (key[j] == key[k] or rule.has_wild) and later(j, k):
            j, k = k, j
        return (j, k, c, l)
    if ordering == "charmm":
        if rule.has_wild:
            if elements[j] == elements[l] and later(j, l):
                j, l = l, j
            if elements[k] == elements[l] and later(k, l):
                k, l = l, k
        return (j, k, c, l)
    # "default": element / carbon / mass tie-break of the first two
    # peripherals when the match used a wildcard
    if rule.has_wild:
        e1, e2 = elements[j], elements[k]
        m1 = ff.atom_types[type_of[j]].mass
        m2 = ff.atom_types[type_of[k]].mass
        if (j > k) if e1 == e2 else (e1 != "C" and (e2 == "C" or m1 < m2)):
            j, k = k, j
    return (j, k, c, l)


def _bonded_lists(ff, struct, adj, bonds, type_of, dtype, device):
    """The bonded lists of the topology, in the JAX package's order
    (mollytpu/models/setup.py:483-578): harmonic bonds, harmonic angles,
    proper torsions (one row per Fourier term), impropers (OpenMM's atom
    order), Urey-Bradley (kangle 0: the angle is already in the angle
    list), RB propers, RB impropers, CMAP; each only where it has rows.
    Returns (lists, bond rows (i, j, r0), angle rows (i, j, k, theta0))
    for the constraint filter."""
    top_angles = build_angles(adj, bonds)
    top_torsions = build_torsions(adj, top_angles)
    bond_rows, angle_rows, ub_rows = [], [], []
    for (i, j) in bonds:
        rule = ff.resolve_bond(type_of[i], type_of[j])
        if rule is not None:
            bond_rows.append((i, j, rule.k, rule.length))
    for (i, j, k) in top_angles:
        rule = ff.resolve_angle(type_of[i], type_of[j], type_of[k])
        if rule is not None:
            angle_rows.append((i, j, k, rule.k, rule.theta0))
            if rule.ub_k != 0.0:
                ub_rows.append((i, j, k, rule.theta0, rule.ub_k, rule.ub_d))
    pt_rows, rb_rows, imp_rows, imp_rb_rows = [], [], [], []
    for (i, j, k, l) in top_torsions:
        rule = ff.resolve_proper(type_of[i], type_of[j], type_of[k],
                                 type_of[l])
        if rule is None:
            continue
        if hasattr(rule, "terms"):
            pt_rows += [(i, j, k, l, per, phase, kk)
                        for (per, phase, kk) in rule.terms if kk != 0.0]
        else:
            rb_rows.append((i, j, k, l, rule.coeffs))
    for (c, j, k, l) in build_impropers(adj):
        rule, perm = ff.resolve_improper(type_of[c], type_of[j], type_of[k],
                                         type_of[l])
        if rule is None:
            continue
        atoms = _improper_ordering(ff, rule, perm, c, j, k, l, struct,
                                   type_of)
        if hasattr(rule, "terms"):
            imp_rows += [atoms + (per, phase, kk)
                         for (per, phase, kk) in rule.terms if kk != 0.0]
        else:
            imp_rb_rows.append(atoms + (rule.coeffs,))

    def cols(rows, n):
        return [np.array([r[m] for r in rows]) for m in range(n)]

    kw = dict(dtype=dtype, device=device)
    lists = []
    if bond_rows:
        i, j, k, r0 = cols(bond_rows, 4)
        lists.append(bonded.harmonic_bonds(i, j, k=k, r0=r0, **kw))
    if angle_rows:
        i, j, k, kk, t0 = cols(angle_rows, 5)
        lists.append(bonded.harmonic_angles(i, j, k, k=kk, theta0=t0, **kw))
    for rows in (pt_rows, imp_rows):
        if rows:
            i, j, k, l, per, phase, kk = cols(rows, 7)
            lists.append(bonded.periodic_torsions(
                i, j, k, l, periodicity=per, phase=phase, k=kk, **kw))
    if ub_rows:
        i, j, k, t0, kb, d = cols(ub_rows, 6)
        lists.append(bonded.urey_bradleys(
            i, j, k, kangle=np.zeros(len(ub_rows)), theta0=t0, kbond=kb,
            r0=d, **kw))
    for rows in (rb_rows, imp_rb_rows):
        if rows:
            i, j, k, l, coeffs = cols(rows, 5)
            lists.append(bonded.rb_torsions(i, j, k, l, coeffs=coeffs,
                                            **kw))
    if ff.cmap_rules:
        cmap = _cmap_list(ff, adj, top_torsions, type_of, dtype, device)
        if cmap is not None:
            lists.append(cmap)
    return (tuple(lists),
            tuple([r[m] for r in bond_rows] for m in (0, 1, 3)),
            tuple([r[m] for r in angle_rows] for m in (0, 1, 2, 4)))


def _cmap_list(ff, adj, torsions, type_of, dtype, device):
    """The CMAP list of the topology's five-atom chains that a CMAP rule
    of the force field matches, or None (mollytpu/models/setup.py:
    579-600). Every map must be a square grid of one size."""
    rows = []
    for chain in build_cmaps(adj, torsions):
        rule = ff.resolve_cmap(*(type_of[a] for a in chain))
        if rule is not None:
            rows.append(chain + (rule.map_index,))
    if not rows:
        return None
    n_grid = max(math.isqrt(len(m)) for m in ff.cmap_maps)
    if any(len(m) != n_grid * n_grid for m in ff.cmap_maps):
        raise ValueError("CMAP maps must all be square grids of one size, "
                         f"got {sorted({len(m) for m in ff.cmap_maps})} "
                         "values")
    table = np.stack([cmap_coefficients(np.asarray(m, dtype=np.float64)
                                        .reshape(n_grid, n_grid))
                      for m in ff.cmap_maps])
    arr = np.array(rows, dtype=np.int64)
    return make_cmap_list(*arr.T, table, n_grid, dtype=dtype, device=device)


def _site_exclusions(vsite_specs, excl_pairs, spec_pairs):
    """Exclusions and 1-4 pairs with the virtual sites': a site inherits
    its first parent's exclusions and 1-4 partners and is excluded from
    all its parents (mollytpu/models/setup.py:451-480); a pair both
    excluded and 1-4 stays excluded only."""
    excl_set, spec_set = set(excl_pairs), set(spec_pairs)
    partner_excl, partner_spec = {}, {}
    for (a, b) in excl_pairs:
        partner_excl.setdefault(a, set()).add(b)
        partner_excl.setdefault(b, set()).add(a)
    for (a, b) in spec_pairs:
        partner_spec.setdefault(a, set()).add(b)
        partner_spec.setdefault(b, set()).add(a)
    for (sidx, _, parents, _) in vsite_specs:
        p0 = parents[0]
        for q in partner_excl.get(p0, set()) | {p0} | set(parents):
            if q != sidx:
                excl_set.add((min(sidx, q), max(sidx, q)))
        for q in partner_spec.get(p0, set()):
            if q != sidx:
                spec_set.add((min(sidx, q), max(sidx, q)))
    return (sorted(excl_set),
            sorted(s for s in spec_set if s not in excl_set))


def _repartition(mass, bonds, elements, hydrogen_mass):
    """Hydrogen mass repartitioning in place: each hydrogen bonded to a
    heavy atom takes ``hydrogen_mass`` (u), the heavy atom gives up the
    difference (mollytpu/models/setup.py:600-611)."""
    hm = float(hydrogen_mass)
    if not 0.9 <= hm <= 5.0:
        raise ValueError("hydrogen_mass must be between ~1 and 5 u")
    for (i, j) in bonds:
        hi = elements[i].upper() == "H"
        hj = elements[j].upper() == "H"
        if hi and not hj:
            mass[j] -= hm - mass[i]
            mass[i] = hm
        elif hj and not hi:
            mass[i] -= hm - mass[j]
            mass[j] = hm


def bfs_exclusions(adj, n):
    """(excl_pairs, special_pairs): graph distance 1-2 -> excluded,
    3 -> special 1-4 (the shorter path wins)."""
    excl, spec = [], []
    for i in range(n):
        dist = {i: 0}
        frontier = [i]
        for d in (1, 2, 3):
            nxt = []
            for a in frontier:
                for b in adj[a]:
                    if b not in dist:
                        dist[b] = d
                        nxt.append(b)
            frontier = nxt
        for j, d in dist.items():
            if j > i:
                (excl if d <= 2 else spec).append((i, j))
    return excl, spec


def _max_partners(pairs, n):
    """The most pairs any one atom is in (1 without pairs)."""
    if not len(pairs):
        return 1
    flat = np.asarray(pairs, dtype=np.int64).reshape(-1)
    return int(np.bincount(flat, minlength=n).max())


def _next8(x):
    return max(8, int(math.ceil(x / 8.0)) * 8)


def make_dispersion_correction(sigma, epsilon, rc):
    """Mean eps sigma^6 / eps sigma^12 over unordered pairs including the
    diagonal, Lorentz-Berthelot mixing, via binomial moment sums."""
    sig = np.asarray(sigma, dtype=np.float64)
    se = np.sqrt(np.maximum(np.asarray(epsilon, dtype=np.float64), 0.0))
    n = sig.shape[0]

    def pair_mean(power):
        moms = [np.sum(se * sig ** k) for k in range(power + 1)]
        total = sum(math.comb(power, k) * moms[k] * moms[power - k]
                    for k in range(power + 1)) / 2.0 ** power
        diag = np.sum(se * se * sig ** power)
        return (total + diag) / 2.0 / (n * (n + 1) / 2.0)

    f6 = 8.0 * math.pi * n * n * (-pair_mean(6) / (3.0 * rc ** 3))
    f12 = 8.0 * math.pi * n * n * (pair_mean(12) / (9.0 * rc ** 9))
    return LJDispersionCorrection(factor_6=float(f6), factor_12=float(f12),
                                  dist_cutoff=float(rc))


def _nbfix_mixings(ff, uniq_types, type_id):
    """NBFix overrides as (sigma, epsilon) MixingExceptions keyed by the
    atom-type ids of the system (mollytpu/models/setup.py:637-656), or
    (None, None) when the force field has none that applies."""
    ki, kj, sv, ev = [], [], [], []
    for (c1, c2, s_nb, e_nb) in ff.nbfix:
        t1s = [t for t in uniq_types
               if t == c1 or ff.type_to_class.get(t) == c1]
        t2s = [t for t in uniq_types
               if t == c2 or ff.type_to_class.get(t) == c2]
        for t1 in t1s:
            for t2 in t2s:
                ki.append(type_id[t1])
                kj.append(type_id[t2])
                sv.append(float(s_nb))
                ev.append(float(e_nb))
    if not ki:
        return None, None
    return (MixingException(LorentzMixing(), ExceptionTable(
                tuple(ki), tuple(kj), tuple(sv))),
            MixingException(GeometricMixing(), ExceptionTable(
                tuple(ki), tuple(kj), tuple(ev))))


#: the neighbor_finder choices of system_from_pdb
NEIGHBOR_FINDERS = ("block", "cell", "distance", None)


def _neighbor_finder(kind, boundary, open_box, radius, n, atoms, coords,
                     n_steps):
    """The finder of a "cutoff" or "pme" system (models/setup.py:714-721
    of the JAX package for "cell" and "distance")."""
    if kind is None:
        return None
    if kind == "block":
        if open_box:
            raise NotImplementedError(
                "the cluster-pair list (neighbor_finder=\"block\") needs a "
                "periodic box: a PDB without CRYST1 takes "
                "neighbor_finder=\"distance\"")
        return BlockPairFinder.setup(boundary, radius, n, atoms,
                                     n_steps=n_steps)
    if kind == "cell" and not open_box:
        return CellListNeighborFinder.setup(boundary, radius, n,
                                            n_steps=n_steps, coords=coords)
    return DistanceNeighborFinder(dist_cutoff=radius, n_steps=n_steps)


def system_from_pdb(path, ff, nonbonded_method="cutoff", dist_cutoff=1.0,
                    dist_neighbors=1.2, neighbor_n_steps=10,
                    pme_error_tol=0.0005,
                    solvent_dielectric=CRF_SOLVENT_DIELECTRIC,
                    dtype=torch.float32, device=None, constraints="none",
                    rigid_water=False, constraint_algorithm="shake",
                    hydrogen_mass=None, implicit_solvent=None,
                    implicit_solvent_kwargs=None, neighbor_finder="block"):
    """Build a System from a PDB file and a ForceField, on ``device`` (the
    CUDA card unless the caller names another, config.resolve_device).

    nonbonded_method: "cutoff" (LJ truncation + reaction field with
    ``solvent_dielectric``) or "pme" (LJ truncation + Ewald real space +
    PME), both with the dispersion correction, or "none" (plain LJ +
    Coulomb over all pairs, the dense engine, no finder). A PDB without
    CRYST1 gets an open box. neighbor_finder (for "cutoff" and "pme"):
    "block" (the default) the BlockPairFinder feeding the pair kernel;
    "cell" and "distance" the JAX package's CellListNeighborFinder (set up
    on the coordinates; "distance" for an open box, as in JAX) and
    DistanceNeighborFinder, feeding the neighbor engine; None none. The
    JAX package's default is "cell". Lists have radius ``dist_neighbors``
    and are rebuilt every ``neighbor_n_steps`` steps. NBFix overrides in
    the force field need "cell" or "distance": the pair kernel takes
    Lorentz-Berthelot mixing only. ``hydrogen_mass`` (u) repartitions the
    masses of hydrogens and the heavy atoms they are bonded to.

    constraints: "none", "hbonds" (bonds to hydrogen), "allbonds" or
    "hangles" (hydrogen bonds and angles with two hydrogen ends or a
    central O), with ``rigid_water`` the water triangles; each on
    ``constraint_algorithm`` "shake" (SHAKE / RATTLE) or "lincs" (LINCS,
    but closed triangles stay on SHAKE). ``implicit_solvent`` "obc1",
    "obc2" or "gbn2" adds generalized Born with the ACE term
    (``implicit_solvent_kwargs``: dist_cutoff, kappa and the other fields
    of ops.gbsa.ImplicitSolventOBC). Virtual sites of the residue
    templates (TIP4P-Ew's M) get zero mass, their first parent's
    exclusions and 1-4 pairs, and their positions from their parents."""
    if nonbonded_method not in ("cutoff", "pme", "none"):
        raise ValueError(f"unknown nonbonded_method {nonbonded_method}")
    if neighbor_finder not in NEIGHBOR_FINDERS:
        raise ValueError(f"neighbor_finder must be one of "
                         f"{NEIGHBOR_FINDERS}, got {neighbor_finder!r}")
    device = resolve_device(device)

    struct = read_pdb(path)
    n = struct.n_atoms
    open_box = struct.box is None
    if nonbonded_method == "pme" and open_box:
        raise NotImplementedError("PME needs a periodic box: the PDB has "
                                  "no CRYST1 record")

    # residue graphs from geometric bond detection feed template matching
    geo_bonds = sorted(set(detect_bonds(struct.coords, struct.elements))
                       | set(struct.conect))
    res_of = struct.res_index_of_atom
    internal = [[] for _ in struct.residues]
    external_count = np.zeros(n, dtype=np.int64)
    for (a, b) in geo_bonds:
        if res_of[a] == res_of[b]:
            ri = res_of[a]
            base = {g: loc for loc, g in
                    enumerate(struct.residues[ri].atom_indices)}
            internal[ri].append((base[a], base[b]))
        else:
            external_count[a] += 1
            external_count[b] += 1

    templates, atom_map = [], []
    type_of = [None] * n
    charge_of = np.zeros(n)
    for ri, res in enumerate(struct.residues):
        ext_counts = {nm: int(external_count[g])
                      for nm, g in zip(res.atom_names, res.atom_indices)}
        try:
            tmpl = ff.find_template(res.name, res.atom_names, ext_counts)
            name_to_global = dict(zip(res.atom_names, res.atom_indices))
            mapping = {ti: name_to_global[ta.name]
                       for ti, ta in enumerate(tmpl.atoms)}
        except KeyError:
            elems = [struct.elements[g] for g in res.atom_indices]
            ext = [external_count[g] for g in res.atom_indices]
            tmpl, local_map = find_template_by_graph(
                ff, res.name, elems, internal[ri], ext)
            mapping = {ti: res.atom_indices[local_map[ti]]
                       for ti in range(len(tmpl.atoms))}
        templates.append(tmpl)
        atom_map.append(mapping)
        for ti, ta in enumerate(tmpl.atoms):
            g = mapping[ti]
            type_of[g] = ta.type
            _, _, q_nb = ff.nonbonded_params(ta.type)
            charge_of[g] = (ta.charge if ta.charge is not None
                            else (q_nb or 0.0))

    sigma, epsilon, mass = np.zeros(n), np.zeros(n), np.zeros(n)
    for g in range(n):
        t = type_of[g]
        if t is None:
            raise ValueError(f"atom {g} ({struct.atom_names[g]}) has no type")
        sigma[g], epsilon[g], _ = ff.nonbonded_params(t)
        mass[g] = ff.atom_types[t].mass
    vsite_specs = [(mapping[vs.index], vs.site_type,
                    tuple(mapping[a] for a in vs.atoms), vs.weights)
                   for tmpl, mapping in zip(templates, atom_map)
                   for vs in tmpl.virtual_sites]
    for (sidx, _, _, _) in vsite_specs:
        mass[sidx] = 0.0

    bonds = _build_bonds(struct, templates, atom_map)
    adj = _adjacency(n, bonds)
    excl_pairs, spec_pairs = bfs_exclusions(adj, n)
    if vsite_specs:
        excl_pairs, spec_pairs = _site_exclusions(vsite_specs, excl_pairs,
                                                  spec_pairs)

    lists, (b_i, b_j, b_r0), (a_i, a_j, a_k, a_t0) = _bonded_lists(
        ff, struct, adj, bonds, type_of, dtype, device)
    if hydrogen_mass is not None:
        _repartition(mass, bonds, struct.elements, hydrogen_mass)

    pairs, dists, lists, triangle_rows = setup_constraints(
        struct, lists, b_i, b_j, b_r0, a_i, a_j, a_k, a_t0, constraints,
        rigid_water)

    if open_box:
        boundary = bnd.rectangular([math.inf] * 3, dtype=dtype,
                                   device=device)
    elif struct.box.ndim == 1:
        boundary = bnd.rectangular(struct.box, dtype=dtype, device=device)
    else:
        boundary = bnd.triclinic(struct.box, dtype=dtype, device=device)
    coords = torch.as_tensor(struct.coords, dtype=dtype, device=device)
    uniq_types = sorted(set(type_of))
    type_id = {t: i for i, t in enumerate(uniq_types)}
    atoms = make_atoms(n=n, mass=mass, charge=charge_of, sigma=sigma,
                       epsilon=epsilon,
                       atom_type=[type_id[t] for t in type_of],
                       dtype=dtype, device=device)

    sig_mixing, eps_mixing = _nbfix_mixings(ff, uniq_types, type_id)
    if (sig_mixing is not None and nonbonded_method != "none"
            and neighbor_finder == "block"):
        raise NotImplementedError(
            "NBFix pair overrides are not a mode of the pair kernel, which "
            "the cluster-pair list feeds: build with neighbor_finder=\"cell\"")
    mixing = {} if sig_mixing is None else dict(sigma_mixing=sig_mixing,
                                                epsilon_mixing=eps_mixing)

    rc = float(dist_cutoff)
    lj = LennardJones(cutoff=DistanceCutoff(rc), use_neighbors=True,
                      weight_special=ff.lj14scale, **mixing)
    general = []
    if nonbonded_method == "none":
        # without the NBFix mixing, as the JAX package builds it
        pairwise = (LennardJones(weight_special=ff.lj14scale),
                    Coulomb(weight_special=ff.coulomb14scale))
    elif nonbonded_method == "cutoff":
        pairwise = (lj, CoulombReactionField(
            dist_cutoff=rc, solvent_dielectric=solvent_dielectric,
            use_neighbors=True, weight_special=ff.coulomb14scale))
    else:
        pairwise = (lj, CoulombEwald(
            dist_cutoff=rc, error_tol=pme_error_tol, use_neighbors=True,
            weight_special=ff.coulomb14scale))
        general.append(PME.setup(boundary, dist_cutoff=rc,
                                 error_tol=pme_error_tol, dtype=dtype))
        all_excl = excl_pairs + spec_pairs
        if all_excl:
            general.append(EwaldExclusionCorrection.setup(
                all_excl, ewald_error_alpha(rc, pme_error_tol),
                device=device))
    if nonbonded_method != "none":
        general.append(make_dispersion_correction(sigma, epsilon, rc))
    if implicit_solvent is not None:
        general.append(make_implicit_solvent(
            implicit_solvent, struct, bonds, charge_of, type_of=type_of,
            dtype=dtype, device=device, **(implicit_solvent_kwargs or {})))

    exclusions = Exclusions.build(
        n, excl_pairs, spec_pairs,
        max_excl=_next8(_max_partners(excl_pairs, n)),
        max_special=_next8(_max_partners(spec_pairs, n)), device=device)
    constrainers = build_constrainers(pairs, dists, triangle_rows,
                                      atoms.mass, constraint_algorithm,
                                      dtype=dtype, device=device)
    finder = None
    if nonbonded_method != "none":
        finder = _neighbor_finder(neighbor_finder, boundary, open_box,
                                  float(dist_neighbors), n, atoms, coords,
                                  neighbor_n_steps)
    vsites = None
    if vsite_specs:
        vsites = VirtualSites.build(vsite_specs, dtype=dtype, device=device)
        # the file's site positions are rounded: set them from the parents
        coords = vsites.place(coords, boundary)
    mol_ids, n_mol = molecule_ids_from_bonds(n, bonds, device=device)
    res = [struct.residues[r] for r in struct.res_index_of_atom]
    atom_data = AtomData(
        atom_name=np.asarray(struct.atom_names),
        residue_name=np.asarray([r.name for r in res]),
        residue_number=np.asarray([r.number for r in res]),
        chain_id=np.asarray([r.chain for r in res]),
        element=np.asarray(struct.elements),
        hetero_atom=np.asarray([r.hetero for r in res]))
    return System(atoms=atoms, coords=coords, boundary=boundary,
                  pairwise_inters=pairwise, specific_lists=lists,
                  general_inters=tuple(general),
                  constraints=constrainers, virtual_sites=vsites,
                  exclusions=exclusions, neighbor_finder=finder,
                  molecule_ids=mol_ids, n_molecules=n_mol,
                  atom_data=atom_data)


def add_position_restraints(sys, k, atom_selector=None):
    """The system with its selected atoms restrained harmonically to their
    current positions (mollytpu/models/setup.py:817-843): one
    position_restraint list appended. k (kJ/mol/nm^2) is a scalar or one
    value per atom; atom_selector a boolean mask, an index array, or a
    predicate on the atom index (None: every atom)."""
    n = sys.n_atoms
    if isinstance(atom_selector, torch.Tensor):
        atom_selector = atom_selector.detach().cpu().numpy()
    if atom_selector is None:
        idx = np.arange(n)
    elif callable(atom_selector):
        idx = np.asarray([i for i in range(n) if atom_selector(i)],
                         dtype=np.int64)
    else:
        sel = np.asarray(atom_selector)
        idx = np.nonzero(sel)[0] if sel.dtype == bool else sel
    if idx.size == 0:
        return sys
    if isinstance(k, torch.Tensor):
        k = k.detach().cpu().numpy()
    k_arr = np.broadcast_to(np.asarray(k, dtype=np.float64), (n,))[idx]
    idx = torch.as_tensor(idx, dtype=torch.int64, device=sys.device)
    slist = bonded.position_restraints(idx, k_arr, sys.coords[idx],
                                       dtype=sys.coords.dtype,
                                       device=sys.device)
    return sys.update(specific_lists=sys.specific_lists + (slist,))


_LATTICE_BASIS = {
    "sc": [(0.0, 0.0, 0.0)],
    "bcc": [(0.0, 0.0, 0.0), (0.5, 0.5, 0.5)],
    "fcc": [(0.0, 0.0, 0.0), (0.5, 0.5, 0.0), (0.5, 0.0, 0.5),
            (0.0, 0.5, 0.5)],
}


def crystal_system(lattice_constant, element_mass, n_cells, lattice="fcc",
                   sigma=0.34, epsilon=0.994, charge=0.0, dtype=torch.float32,
                   device=None, pairwise_inters=None, **system_kwargs):
    """A System of atoms on a perfect replicated crystal lattice ("sc",
    "bcc" or "fcc"; lattice_constant in nm, n_cells an int or (nx, ny,
    nz)) on ``device`` (the CUDA card unless the caller names another),
    as mollytpu/models/setup.py:846-890 builds it. Without
    ``pairwise_inters``, LJ with a 1.0 nm shifted-force cutoff on the
    dense engine (the JAX package's box-dependent branch never runs)."""
    device = resolve_device(device)
    basis = _LATTICE_BASIS[lattice]
    if isinstance(n_cells, int):
        n_cells = (n_cells, n_cells, n_cells)
    a = float(lattice_constant)
    pts = [((ix + bx) * a, (iy + by) * a, (iz + bz) * a)
           for ix in range(n_cells[0]) for iy in range(n_cells[1])
           for iz in range(n_cells[2]) for (bx, by, bz) in basis]
    coords = torch.as_tensor(np.asarray(pts), dtype=dtype, device=device)
    boundary = bnd.rectangular((n_cells[0] * a, n_cells[1] * a,
                                n_cells[2] * a), dtype=dtype, device=device)
    atoms = make_atoms(n=coords.shape[0], mass=element_mass, sigma=sigma,
                       epsilon=epsilon, charge=charge, dtype=dtype,
                       device=device)
    if pairwise_inters is None:
        pairwise_inters = (LennardJones(cutoff=ShiftedForceCutoff(1.0)),)
    return System(atoms=atoms, coords=coords, boundary=boundary,
                  pairwise_inters=pairwise_inters, **system_kwargs)
