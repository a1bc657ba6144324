"""Build the port's System from a JAX-package System whose arrays were
fetched to the host (``jax.device_get(sys)``): the "weights" of a run
(atom parameters, box, interactions, bonded lists with CMAP, exclusions,
PME moduli, implicit solvent, constraints on SHAKE or LINCS, virtual sites,
molecule ids) carried over as numpy arrays. ``free_energy_from_arrays``
carries a CV, a bias, a BiasPotential, a GridBias or an
ExtendedStateSpace the same way. Duck-typed on attribute and
class names, so the port never imports the JAX package; the parity tests
use it to hand both packages the same system.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .atoms import Atoms
from .boundary import Orthorhombic, Triclinic
from .config import resolve_device
from .free_energy import alchemy
from .free_energy import bias as fe_bias
from .free_energy import cv as fe_cv
from .free_energy.awh import GridBias
from .free_energy.extended_ensemble import ExtendedStateSpace
from .free_energy.thermo import ThermoState
from .ops import cutoffs, mixing, pairwise
from .ops.blockpairs import BlockPairFinder
from .ops.bonded import TERM_FUNCS, SpecificList
from .ops.celltiles import CellTileFinder
from .ops.cmap import register_cmap
from .ops.gbsa import ImplicitSolventGBN2, ImplicitSolventOBC
from .ops.lincs import LINCS
from .ops.neighbors import (CellListNeighborFinder, DistanceNeighborFinder,
                            NoNeighborFinder)
from .ops.constraints import SHAKERattle
from .ops.ewald import PME, Ewald, EwaldExclusionCorrection
from .ops.general import LJDispersionCorrection, MullerBrown
from .ops.virtual_sites import VirtualSites
from .system import EXCL_WINDOW, Exclusions, System


def _tensor(x, dtype=None, device=None):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def pairs_from_bitmap(bits, far):
    """(i < j) pairs encoded by (N+1, 2) windowed bitmaps plus far pairs."""
    b = np.asarray(bits).view(np.uint32)[:-1]
    out = []
    for w in range(2):
        for k in range(32):
            rows = np.nonzero((b[:, w] >> np.uint32(k)) & np.uint32(1))[0]
            partners = rows + (w * 32 + k - EXCL_WINDOW)
            keep = partners > rows
            out.append(np.stack([rows[keep], partners[keep]], axis=1))
    out.append(np.asarray(far, dtype=np.int64).reshape(-1, 2))
    pairs = np.concatenate(out).astype(np.int64)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


#: the cutoffs, mixing rules, schedulers and pairwise interactions the
#: port carries, by class name
_CUTOFFS = ("NoCutoff", "DistanceCutoff", "ShiftedPotentialCutoff",
            "ShiftedForceCutoff", "CubicSplineCutoff", "PolynomialCutoff")
_MIXINGS = ("LorentzMixing", "GeometricMixing", "WaldmanHaglerMixing",
            "FenderHalseyMixing", "InverseMixing", "MinimumMixing")
_SCHEDULERS = ("DefaultLambdaScheduler", "NAMDLambdaScheduler",
               "QuartersLambdaScheduler", "EleScaledLambdaScheduler")
_PAIRWISE = ("LennardJones", "LennardJonesSoftCoreBeutler",
             "LennardJonesSoftCoreGapsys", "AshbaughHatch", "SoftSphere",
             "Mie", "Buckingham", "DoubleExponential",
             "DoubleExponentialSoftCore", "Gravity", "Coulomb",
             "CoulombScaled", "CoulombReactionField",
             "CoulombReactionFieldScaled", "CoulombEwald",
             "CoulombEwaldScaled", "CoulombSoftCoreBeutler",
             "CoulombSoftCoreGapsys", "CoulombSoftCoreBeutlerEwald",
             "CoulombSoftCoreGapsysEwald",
             "CoulombSoftCoreBeutlerReactionField",
             "CoulombSoftCoreGapsysReactionField", "Yukawa",
             "DPDInteraction")


def _cutoff(c):
    name = type(c).__name__
    if name not in _CUTOFFS:
        raise NotImplementedError(f"cutoff {name} is not ported")
    cls = getattr(cutoffs, name)
    return cls(**{f.name: float(getattr(c, f.name))
                  for f in dataclasses.fields(cls)})


def _mixing(rule):
    """The port's rule; a MixingException with its exception table."""
    name = type(rule).__name__
    if name == "MixingException":
        table = rule.exceptions
        return mixing.MixingException(_mixing(rule.mixing), None if table
                                      is None else mixing.ExceptionTable(
            tuple(int(k) for k in table.keys_i),
            tuple(int(k) for k in table.keys_j),
            tuple(float(v) for v in table.values)))
    if name not in _MIXINGS:
        raise NotImplementedError(f"mixing rule {name} is not ported")
    return getattr(mixing, name)()


def _scheduler(s):
    if s is None:
        return None
    name = type(s).__name__
    if name not in _SCHEDULERS:
        raise NotImplementedError(f"lambda scheduler {name} is not ported")
    return getattr(alchemy, name)()


def _field(name, value):
    """One field of a pairwise interaction, mapped to the port's types."""
    if name == "cutoff":
        return _cutoff(value)
    if name.endswith("_mixing"):
        return _mixing(value)
    if name == "scheduler":
        return _scheduler(value)
    if name in ("use_neighbors", "approximate_erfc"):
        return bool(value)
    if name == "seed":
        return int(value)
    return None if value is None else float(value)


def _pairwise(inter):
    """The port's interaction of the same class name, field for field."""
    name = type(inter).__name__
    if name not in _PAIRWISE:
        raise NotImplementedError(f"pairwise interaction {name} is not ported")
    cls = getattr(pairwise, name)
    return cls(**{f.name: _field(f.name, getattr(inter, f.name))
                  for f in dataclasses.fields(cls)})


def _finder(f, boundary, n, atoms, dist_neighbors, n_steps):
    """The JAX System's neighbor finder, field for field, or a
    BlockPairFinder of list radius ``dist_neighbors`` when one is given."""
    if dist_neighbors is not None:
        return BlockPairFinder.setup(boundary, dist_neighbors, n, atoms,
                                     n_steps=n_steps or 1)
    if f is None:
        return None
    name = type(f).__name__
    if name == "NoNeighborFinder":
        return NoNeighborFinder(n_steps=int(f.n_steps))
    if name == "DistanceNeighborFinder":
        return DistanceNeighborFinder(
            dist_cutoff=float(f.dist_cutoff), n_steps=int(f.n_steps),
            max_neighbors=int(f.max_neighbors))
    if name == "CellListNeighborFinder":
        return CellListNeighborFinder(
            dist_cutoff=float(f.dist_cutoff),
            grid_dims=tuple(int(d) for d in f.grid_dims),
            n_steps=int(f.n_steps), max_neighbors=int(f.max_neighbors),
            cell_capacity=int(f.cell_capacity))
    if name == "CellTileFinder":
        return CellTileFinder(
            dist_cutoff=float(f.dist_cutoff),
            stencil=_tensor(f.stencil, torch.int64,
                            boundary.box_matrix().device),
            grid_dims=tuple(int(d) for d in f.grid_dims),
            cell_capacity=int(f.cell_capacity), n_steps=int(f.n_steps),
            ref_sides=None if f.ref_sides is None else tuple(
                float(s) for s in f.ref_sides),
            resetup_drift=float(f.resetup_drift))
    raise NotImplementedError(f"neighbor finder {name} is not carried: "
                              "pass dist_neighbors for a BlockPairFinder")


def _general(gi, dtype, device):
    name = type(gi).__name__
    if name == "PME":
        return PME(dist_cutoff=float(gi.dist_cutoff),
                   error_tol=float(gi.error_tol), order=int(gi.order),
                   mesh_dims=tuple(int(k) for k in gi.mesh_dims),
                   coulomb_const=float(gi.coulomb_const),
                   epsilon_r=float(gi.epsilon_r), alpha=float(gi.alpha),
                   moduli_x=_tensor(gi.moduli_x, dtype, device),
                   moduli_y=_tensor(gi.moduli_y, dtype, device),
                   moduli_z=_tensor(gi.moduli_z, dtype, device),
                   scheduler=_scheduler(gi.scheduler),
                   excl_i=_tensor(gi.excl_i, torch.int64, device),
                   excl_j=_tensor(gi.excl_j, torch.int64, device))
    if name == "Ewald":
        return Ewald(dist_cutoff=float(gi.dist_cutoff),
                     error_tol=float(gi.error_tol), kmax=int(gi.kmax),
                     coulomb_const=float(gi.coulomb_const),
                     alpha=float(gi.alpha),
                     excl_i=_tensor(gi.excl_i, torch.int64, device),
                     excl_j=_tensor(gi.excl_j, torch.int64, device),
                     scheduler=_scheduler(gi.scheduler))
    if name == "MullerBrown":
        return MullerBrown(**{k: _tensor(getattr(gi, k), dtype, device)
                              for k in ("A", "a", "b", "c", "x0", "y0")})
    if name in ("BiasPotential", "GridBias"):
        return free_energy_from_arrays(gi, dtype, device)
    if name == "EwaldExclusionCorrection":
        return EwaldExclusionCorrection.setup(
            pairs_from_bitmap(gi.bits, gi.far), float(gi.alpha),
            ke=float(gi.coulomb_const), device=device)
    if name == "LJDispersionCorrection":
        return LJDispersionCorrection(float(gi.factor_6), float(gi.factor_12),
                                      float(gi.dist_cutoff))
    if name in ("ImplicitSolventOBC", "ImplicitSolventGBN2"):
        cls = (ImplicitSolventOBC if name == "ImplicitSolventOBC"
               else ImplicitSolventGBN2)
        fields = {f.name: getattr(gi, f.name)
                  for f in dataclasses.fields(cls)}
        return cls(**{k: bool(v) if k == "use_ace" else
                      _tensor(v, dtype, device) if isinstance(v, np.ndarray)
                      else float(v) for k, v in fields.items()})
    raise NotImplementedError(f"general interaction {name} is not ported")


#: the CVs and biases the port carries, by class name
_CVS = ("CalcSingleDist", "CalcDist", "CalcMinDist", "CalcMaxDist",
        "CalcCMDist", "CalcRg", "CalcRMSD", "CalcTorsion")
_BIASES = ("LinearBias", "SquareBias", "FlatBottomSquareBias",
           "PeriodicFlatBottomBias")


def _cv_field(name, value, dtype, device):
    if name in ("i", "j", "k", "l"):
        return int(value)
    if name == "beta":
        return float(value)
    if name.startswith("group"):
        return _tensor(value, torch.int64, device)
    return _tensor(value, dtype, device)


def _number(value, dtype, device):
    """A bias parameter: a Python float for a scalar, else a tensor."""
    if np.ndim(value) == 0:
        return float(value)
    return _tensor(value, dtype, device)


def free_energy_from_arrays(obj, dtype=None, device=None):
    """The port's counterpart of a host-side JAX free-energy object: a CV
    (free_energy/cv.py), a bias (free_energy/bias.py), a BiasPotential, a
    GridBias or an ExtendedStateSpace (its biases carried, its atom mask
    as a bool tensor), arrays through numpy onto ``device`` (the CUDA card
    unless the caller names another) in ``dtype`` (float64 by default)."""
    device = resolve_device(device)
    dtype = dtype or torch.float64
    name = type(obj).__name__
    if name in _CVS:
        cls = getattr(fe_cv, name)
        return cls(**{f.name: _cv_field(f.name, getattr(obj, f.name), dtype,
                                        device)
                      for f in dataclasses.fields(cls)})
    if name in _BIASES:
        cls = getattr(fe_bias, name)
        return cls(**{f.name: _number(getattr(obj, f.name), dtype, device)
                      for f in dataclasses.fields(cls)})
    if name == "BiasPotential":
        return fe_bias.BiasPotential(
            bias=free_energy_from_arrays(obj.bias, dtype, device),
            cv=free_energy_from_arrays(obj.cv, dtype, device))
    if name == "GridBias":
        return GridBias(cv=free_energy_from_arrays(obj.cv, dtype, device),
                        centers=_tensor(obj.centers, dtype, device),
                        values=_tensor(obj.values, dtype, device))
    if name == "ExtendedStateSpace":
        states = tuple(ThermoState(
            lam=float(s.lam), temperature=float(s.temperature),
            pressure=None if s.pressure is None else float(s.pressure),
            name=s.name) for s in obj.states)
        biases = None if obj.biases is None else tuple(
            None if b is None else free_energy_from_arrays(b, dtype, device)
            for b in obj.biases)
        mask = None if obj.atom_mask is None else _tensor(
            obj.atom_mask, torch.bool, device)
        return ExtendedStateSpace(states, biases=biases, atom_mask=mask)
    raise NotImplementedError(f"free-energy object {name} is not carried")


def _specific(slist, dtype, device, cmap_tables):
    """The port's list of the same kind: indices and every parameter
    column, weight included. A CMAP kind takes its coefficient table from
    ``cmap_tables`` (the JAX package keeps it in its term function, out of
    the list's reach)."""
    if slist.kind.startswith("cmap_torsion_"):
        if slist.kind not in cmap_tables:
            raise ValueError(f"{slist.kind}: pass its coefficient table in "
                             "cmap_tables")
        register_cmap(cmap_tables[slist.kind],
                      int(slist.kind.rsplit("_", 1)[1]))
        return SpecificList(
            slist.kind, _tensor(slist.atom_idx, torch.int64, device),
            {"map_index": _tensor(slist.params["map_index"], torch.int64,
                                  device),
             "weight": _tensor(slist.params["weight"], dtype, device)})
    if slist.kind not in TERM_FUNCS:
        raise NotImplementedError(f"bonded kind {slist.kind} is not ported")
    return SpecificList(
        slist.kind, _tensor(slist.atom_idx, torch.int64, device),
        {k: _tensor(v, dtype, device) for k, v in slist.params.items()})


def _constraint(c, dtype, device):
    """A JAX SHAKERattle (cluster solves where its graph allows them, as
    JAX's setup builds it) or LINCS, its tables as they are (LINCS's in
    float32, the JAX package's dtype)."""
    if type(c).__name__ == "LINCS":
        return LINCS(*(_tensor(getattr(c, f), torch.int64 if f in (
            "idx_i", "idx_j", "nbr") else None, device) for f in (
            "idx_i", "idx_j", "dists", "sdiag", "inv_m_i", "inv_m_j", "nbr",
            "coef")), order=int(c.order), n_iters=int(c.n_iters))
    pairs = np.stack([np.asarray(c.idx_i), np.asarray(c.idx_j)], axis=1)
    return SHAKERattle.build(pairs, np.asarray(c.dists), dtype=dtype,
                             device=device, n_iters=int(c.n_iters),
                             vel_iters=int(c.vel_iters),
                             omega=float(c.omega))


def system_from_arrays(tree, dtype=None, device=None, dist_neighbors=None,
                       n_steps=None, cmap_tables=None):
    """The port's System for a host-side JAX System ``tree``, on ``device``
    (the CUDA card unless the caller names another). dtype defaults to the
    coordinates' dtype. The JAX System's NoNeighborFinder,
    DistanceNeighborFinder or CellListNeighborFinder is carried with its
    fields; a BlockPairFinder of list radius ``dist_neighbors`` replaces
    it when dist_neighbors is given. ``cmap_tables`` maps each CMAP kind
    of the system ("cmap_torsion_<n>") to its (n_maps, n, n, 4, 4)
    coefficients."""
    device = resolve_device(device)
    coords = np.asarray(tree.coords)
    dtype = dtype or (torch.float64 if coords.dtype == np.float64
                      else torch.float32)
    a = tree.atoms

    def column(name, kind=dtype):
        value = getattr(a, name, None)
        return None if value is None else _tensor(value, kind, device)

    atoms = Atoms(mass=column("mass"), charge=column("charge"),
                  sigma=column("sigma"), epsilon=column("epsilon"),
                  atom_type=column("atom_type", torch.int32),
                  lam=column("lam"),
                  alch_role=column("alch_role", torch.int32),
                  buck_A=column("buck_A"), buck_B=column("buck_B"),
                  buck_C=column("buck_C"))
    if type(tree.boundary).__name__ == "Triclinic":
        boundary = Triclinic(_tensor(tree.boundary.basis, dtype, device),
                             approx_images=bool(tree.boundary.approx_images))
    else:
        boundary = Orthorhombic(_tensor(tree.boundary.side_lengths, dtype,
                                        device))
    e = tree.exclusions
    exclusions = Exclusions(*(_tensor(getattr(e, f), device=device) for f in (
        "excl_i", "excl_j", "spec_i", "spec_j", "excl_table", "spec_table",
        "excl_bits", "spec_bits", "far_excl", "far_spec")))
    constraints = [_constraint(c, dtype, device) for c in tree.constraints]
    vs = getattr(tree, "virtual_sites", None)
    if vs is not None:
        vs = VirtualSites.from_arrays(vs.site_idx, vs.site_type, vs.parents,
                                      vs.weights, dtype=dtype, device=device)
    finder = _finder(tree.neighbor_finder, boundary, coords.shape[0], atoms,
                     dist_neighbors, n_steps)
    return System(atoms=atoms, coords=_tensor(coords, dtype, device),
                  boundary=boundary,
                  velocities=_tensor(tree.velocities, dtype, device),
                  pairwise_inters=tuple(_pairwise(i)
                                        for i in tree.pairwise_inters),
                  specific_lists=tuple(_specific(s, dtype, device,
                                                 cmap_tables or {})
                                       for s in tree.specific_lists),
                  general_inters=tuple(_general(g, dtype, device)
                                       for g in tree.general_inters),
                  constraints=tuple(constraints), virtual_sites=vs,
                  exclusions=exclusions,
                  neighbor_finder=finder, n_dof=int(tree.n_dof),
                  molecule_ids=_tensor(tree.molecule_ids, torch.int32,
                                       device),
                  n_molecules=int(tree.n_molecules))
