"""System construction from a PDB file and an OpenMM-format force field
(counterpart of mollytpu/models/setup.py:44-170, 291-764, 789-814).

Ported: nonbonded_method "cutoff" (LJ truncation + reaction field, in an
orthorhombic or triclinic box) and "pme" (orthorhombic boxes),
constraints "none" or "hbonds", rigid water, the LJ dispersion correction.
Everything else raises NotImplementedError naming what is missing: the
no-cutoff method, open boundaries, PME in a triclinic box, NBFix, virtual
sites, implicit solvent, CMAP, and any bonded term that survives the
constraint filter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import boundary as bnd
from ..atoms import make_atoms
from ..config import resolve_device
from ..ops.blockpairs import BlockPairFinder
from ..ops.constraints import SHAKERattle, setup_constraints
from ..ops.cutoffs import DistanceCutoff
from ..ops.ewald import PME, EwaldExclusionCorrection, ewald_error_alpha
from ..ops.general import LJDispersionCorrection
from ..ops.pairwise import (CRF_SOLVENT_DIELECTRIC, CoulombEwald,
                            CoulombReactionField, LennardJones)
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
    cnt = np.zeros(n, dtype=np.int64)
    for (a, b) in pairs:
        cnt[a] += 1
        cnt[b] += 1
    return int(cnt.max()) if len(pairs) else 1


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


def system_from_pdb(path, ff, nonbonded_method="cutoff", dist_cutoff=1.0,
                    dist_neighbors=1.2, neighbor_n_steps=10,
                    pme_error_tol=0.0005,
                    solvent_dielectric=CRF_SOLVENT_DIELECTRIC,
                    dtype=torch.float32, device=None, constraints="none",
                    rigid_water=False, implicit_solvent=None):
    """Build a System from a PDB file and a ForceField, on ``device`` (the
    CUDA card unless the caller names another, config.resolve_device).

    nonbonded_method: "cutoff" (LJ truncation + reaction field with
    ``solvent_dielectric``) or "pme" (LJ truncation + Ewald real space +
    PME), both with the dispersion correction. The neighbor finder is a
    BlockPairFinder with list radius ``dist_neighbors`` rebuilt every
    ``neighbor_n_steps`` steps."""
    if nonbonded_method == "none":
        raise NotImplementedError(
            "nonbonded_method='none' needs a dense all-pairs path, which is "
            "not ported")
    if nonbonded_method not in ("cutoff", "pme"):
        raise ValueError(f"unknown nonbonded_method {nonbonded_method}")
    device = resolve_device(device)
    if implicit_solvent is not None:
        raise NotImplementedError("implicit solvent is not ported yet")
    if ff.nbfix:
        raise NotImplementedError("NBFix pair overrides are not ported yet")
    if ff.cmap_rules:
        raise NotImplementedError("CMAP terms are not ported yet")

    struct = read_pdb(path)
    n = struct.n_atoms
    if struct.box is None:
        raise NotImplementedError("no CRYST1 record: open boundaries are "
                                  "not ported")
    if nonbonded_method == "pme" and struct.box.ndim != 1:
        raise NotImplementedError(
            "PME needs an orthorhombic periodic box: the port's PME mesh "
            "(ops/ewald.py) reads side lengths, triclinic PME is not ported")

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
        if tmpl.virtual_sites:
            raise NotImplementedError("virtual sites are not ported yet")
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

    bonds = _build_bonds(struct, templates, atom_map)
    adj = _adjacency(n, bonds)
    excl_pairs, spec_pairs = bfs_exclusions(adj, n)

    top_angles = build_angles(adj, bonds)
    b_i, b_j, b_r0 = [], [], []
    for (i, j) in bonds:
        rule = ff.resolve_bond(type_of[i], type_of[j])
        if rule is not None:
            b_i.append(i)
            b_j.append(j)
            b_r0.append(rule.length)
    a_i, a_j, a_k, a_t0 = [], [], [], []
    for (i, j, k) in top_angles:
        rule = ff.resolve_angle(type_of[i], type_of[j], type_of[k])
        if rule is not None:
            a_i.append(i)
            a_j.append(j)
            a_k.append(k)
            a_t0.append(rule.theta0)
    for (i, j, k, l) in build_torsions(adj, top_angles):
        if ff.resolve_proper(type_of[i], type_of[j], type_of[k],
                             type_of[l]) is not None:
            raise NotImplementedError("torsions are not ported yet "
                                      "(ops/bonded.py)")
    for (c, j, k, l) in build_impropers(adj):
        if ff.resolve_improper(type_of[c], type_of[j], type_of[k],
                               type_of[l])[0] is not None:
            raise NotImplementedError("improper torsions are not ported yet "
                                      "(ops/bonded.py)")

    pairs, dists, drop_b, drop_a = setup_constraints(
        struct, b_i, b_j, b_r0, a_i, a_j, a_k, a_t0, constraints,
        rigid_water)
    if len(b_i) - len(drop_b) or len(a_i) - len(drop_a):
        raise NotImplementedError(
            f"{len(b_i) - len(drop_b)} bonds and {len(a_i) - len(drop_a)} "
            "angles survive the constraint filter; bonded terms are not "
            "ported yet (ops/bonded.py)")

    if struct.box.ndim == 1:
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

    rc = float(dist_cutoff)
    lj = LennardJones(cutoff=DistanceCutoff(rc), use_neighbors=True,
                      weight_special=ff.lj14scale)
    general = []
    if nonbonded_method == "cutoff":
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
    general.append(make_dispersion_correction(sigma, epsilon, rc))

    exclusions = Exclusions.build(
        n, excl_pairs, spec_pairs,
        max_excl=_next8(_max_partners(excl_pairs, n)),
        max_special=_next8(_max_partners(spec_pairs, n)), device=device)
    constrainers = ()
    if pairs:
        constrainers = (SHAKERattle.build(pairs, dists, dtype=dtype,
                                          device=device),)
    finder = BlockPairFinder.setup(boundary, float(dist_neighbors), n, atoms,
                                   n_steps=neighbor_n_steps)
    mol_ids, n_mol = molecule_ids_from_bonds(n, bonds, device=device)
    return System(atoms=atoms, coords=coords, boundary=boundary,
                  pairwise_inters=pairwise, general_inters=tuple(general),
                  constraints=constrainers,
                  exclusions=exclusions, neighbor_finder=finder,
                  molecule_ids=mol_ids, n_molecules=n_mol)
