"""Generalized-Born implicit solvent with the ACE surface term: OBC1, OBC2
and GBn2 (counterpart of mollytpu/ops/gbsa.py).

mbondi2 / mbondi3 intrinsic radii with the special cases of hydrogens on
nitrogen, arginine's HH/HE and carboxylate oxygens; the OBC Born integral
with the tanh rescaling; GBn2's neck correction from OpenMM's d0/m0 tables
(ops/_gbn2_neck.py, interpolated per atom pair at setup); the pairwise
polarisation energy with optional Debye screening ``kappa`` and distance
cutoff ``dist_cutoff``, and the ACE surface-area term.

As in the JAX package, the Born radii and the polarisation sum are dense
(N, N) passes in plain tensor code (a GB system has no explicit solvent,
so N is small), and the forces are -dE/dx by torch.autograd through the
whole chain (GeneralInteraction). Each (N, N) float32 temporary at N =
3,000 takes 36 MB.
"""

from __future__ import annotations

import base64
import dataclasses
import zlib

import numpy as np
import torch

from ..config import resolve_device
from ..units import COULOMB_CONST
from .general import GeneralInteraction

GB_SOLVENT_DIELECTRIC = 78.5
GB_SOLUTE_DIELECTRIC = 1.0
OBC_OFFSET = 0.009          # nm
GBN2_OFFSET = 0.0195141     # nm
GB_PROBE_RADIUS = 0.14      # nm
GB_SA_FACTOR = 28.3919551   # kJ/mol/nm^2
GBN2_NECK_SCALE = 0.826836
GBN2_NECK_CUT = 0.68        # nm

MBONDI2_RADII = {
    "N": 0.155, "O": 0.15, "F": 0.15, "Si": 0.21, "P": 0.185, "S": 0.18,
    "Cl": 0.17, "C": 0.17, "H": 0.12, "H_N": 0.13, "H_ARG": 0.117,
    "O_CAR": 0.14, "-": 0.15,
}
OBC_SCREEN = {"H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85, "F": 0.88,
              "P": 0.86, "S": 0.96, "-": 0.80}
GBN2_SCREEN = {"H": 1.425952, "C": 1.058554, "N": 0.733599, "O": 1.061039,
               "F": 0.5, "P": 0.5, "S": -0.703469, "-": 0.5}
GBN2_SCREEN_NUCLEIC = {"H": 1.696538, "C": 1.268902, "N": 1.4259728,
                       "O": 0.1840098, "F": 0.5, "P": 0.5, "S": 0.5,
                       "-": 0.5}
GBN2_ABG = {
    "H": (0.788440, 0.798699, 0.437334), "D": (0.788440, 0.798699, 0.437334),
    "C": (0.733756, 0.506378, 0.205844), "N": (0.503364, 0.316828, 0.192915),
    "O": (0.867814, 0.876635, 0.387882), "S": (0.867814, 0.876635, 0.387882),
    "-": (1.0, 0.8, 4.851),
}
GBN2_ABG_NUCLEIC = {
    "H": (0.537050, 0.362861, 0.116704), "D": (0.537050, 0.362861, 0.116704),
    "C": (0.331670, 0.196842, 0.093422), "N": (0.686311, 0.463189, 0.138722),
    "O": (0.606344, 0.463006, 0.142262), "-": (1.0, 0.8, 4.851),
}
NUCLEIC_RESIDUES = ("A", "C", "G", "U", "DA", "DC", "DG", "DT")

#: the implicit_solvent= models
MODELS = ("obc1", "obc2", "gbn2")


def neck_tables():
    """OpenMM's (21, 21) d0 (nm) and m0 (1/nm) tables."""
    from . import _gbn2_neck
    raw = zlib.decompress(base64.b64decode(_gbn2_neck.BLOB))
    arr = np.frombuffer(raw, dtype=np.float64).reshape(2, 441)
    return arr[0].reshape(21, 21) / 10.0, arr[1].reshape(21, 21) * 10.0


def assign_radii(elements, res_names, atom_names, atom_types, bonds,
                 mbondi3=False, radii_table=None):
    """mbondi2 / mbondi3 intrinsic radii (nm), one per atom."""
    tab = radii_table or MBONDI2_RADII
    n = len(elements)
    bonded_to_n = np.zeros(n, dtype=bool)
    for (i, j) in bonds:
        if elements[i] == "N":
            bonded_to_n[j] = True
        if elements[j] == "N":
            bonded_to_n[i] = True
    out = np.zeros(n)
    for i in range(n):
        el = elements[i]
        if mbondi3 and res_names[i] == "ARG" and (
                atom_names[i].startswith("HH")
                or atom_names[i].startswith("HE")):
            out[i] = tab["H_ARG"]
        elif mbondi3 and atom_types is not None and atom_types[i] == "O2":
            out[i] = tab["O_CAR"]
        elif el in ("H", "D"):
            out[i] = tab["H_N"] if bonded_to_n[i] else tab["H"]
        else:
            out[i] = tab.get(el, tab["-"])
    return out


def neck_lookup(radii):
    """(N, N) d0 and m0 of each atom pair, bilinear in the two radii on
    the tables' grid; entry [i, j] is the one atom i's Born sum takes over
    neighbour j (host numpy, mollytpu/ops/gbsa.py:101-128)."""
    d0_t, m0_t = neck_tables()
    n = len(radii)
    pos = (np.asarray(radii) - 0.1) * 200.0
    i1 = np.zeros(n, dtype=int)
    i2 = np.zeros(n, dtype=int)
    w1 = np.zeros(n)
    for a, p in enumerate(pos):
        if p <= 0.0:
            w1[a] = 1.0
        elif p >= 20.0:
            i1[a] = 20
            w1[a] = 1.0
        else:
            i1[a] = int(np.floor(p))
            i2[a] = i1[a] + 1
            w1[a] = i2[a] - p
    w2 = np.where((pos > 0) & (pos < 20.0), 1.0 - w1, 0.0)

    def interp(t):
        return (np.outer(w1, w1) * t[i1][:, i1] + np.outer(w1, w2)
                * t[i1][:, i2] + np.outer(w2, w1) * t[i2][:, i1]
                + np.outer(w2, w2) * t[i2][:, i2])
    return interp(d0_t).T, interp(m0_t).T


def _pair_r2(coords, boundary):
    """(N, N) squared minimum-image distances."""
    diffs = tuple(c[None, :] - c[:, None] for c in coords.unbind(dim=1))
    return sum(x * x for x in boundary.mic_parts(diffs))


def _born_I_obc(r, ori, srj, dead):
    """The OBC pair contributions to atom i's Born integral I_i; r (N, N)
    holds a dummy 1 on the diagonal, ``dead`` masks pairs out."""
    sr = srj[None, :]
    oi = ori[:, None]
    u_ = r + sr
    d_ = torch.abs(r - sr)
    l_ = torch.maximum(oi.expand_as(d_), d_)
    term = 0.5 * (1.0 / l_ - 1.0 / u_
                  + (r - sr ** 2 / r) * (1.0 / u_ ** 2 - 1.0 / l_ ** 2) / 4.0
                  + torch.log(l_ / u_) / (2.0 * r))
    zero = torch.zeros_like(term)
    term = torch.where(oi < u_, term, zero)
    term = term + torch.where(oi < sr - r, 2.0 * (1.0 / oi - 1.0 / l_),
                              zero)
    return torch.where(dead, zero, term)


@dataclasses.dataclass(frozen=True)
class ImplicitSolventOBC(GeneralInteraction):
    """OBC1 / OBC2 generalized Born with the ACE term: offset radii
    or_i = radius - offset and screened radii sr_i = screen_i or_i."""

    offset_radii: torch.Tensor   # (N,)
    scaled_radii: torch.Tensor   # (N,)
    alpha: float = 1.0
    beta: float = 0.8
    gamma: float = 4.85
    offset: float = OBC_OFFSET
    kappa: float = 0.0
    solvent_dielectric: float = GB_SOLVENT_DIELECTRIC
    solute_dielectric: float = GB_SOLUTE_DIELECTRIC
    dist_cutoff: float = 0.0
    probe_radius: float = GB_PROBE_RADIUS
    sa_factor: float = GB_SA_FACTOR
    use_ace: bool = True

    def _dead_pairs(self, r2):
        eye = torch.eye(r2.shape[0], dtype=torch.bool, device=r2.device)
        if self.dist_cutoff:
            return eye, eye | (r2 > self.dist_cutoff ** 2)
        return eye, eye

    def _born_sum(self, coords, boundary):
        """(r2, r, dead, I) of the configuration."""
        r2 = _pair_r2(coords, boundary)
        eye, dead = self._dead_pairs(r2)
        r = torch.sqrt(torch.where(eye, torch.ones_like(r2), r2))
        I = _born_I_obc(r, self.offset_radii.to(coords.dtype),
                        self.scaled_radii.to(coords.dtype), dead)
        return r2, r, dead, I

    def _radii_from_I(self, Is, alpha, beta, gamma):
        orr = self.offset_radii.to(Is.dtype)
        psi = Is * orr
        tanh_sum = torch.tanh(alpha * psi - beta * psi ** 2
                              + gamma * psi ** 3)
        return 1.0 / (1.0 / orr - tanh_sum / (orr + self.offset))

    def born_radii(self, coords, boundary):
        _, _, _, I = self._born_sum(coords, boundary)
        return self._radii_from_I(I.sum(dim=1), self.alpha, self.beta,
                                  self.gamma)

    def energy(self, coords, boundary, atoms):
        return self.energy_with_radii(coords, boundary, atoms,
                                      self.born_radii(coords, boundary))

    def energy_with_radii(self, coords, boundary, atoms, bs):
        """The GB energy at Born radii ``bs`` (mollytpu/ops/gbsa.py:
        186-223)."""
        q = atoms.charge.to(coords.dtype)
        ke = COULOMB_CONST
        f_solute = (-ke / self.solute_dielectric
                    if self.solute_dielectric else 0.0)
        f_solvent = (ke / self.solvent_dielectric
                     if self.solvent_dielectric else 0.0)
        r2 = _pair_r2(coords, boundary)
        eye = torch.eye(r2.shape[0], dtype=torch.bool, device=r2.device)
        bb = bs[:, None] * bs[None, :]
        f = torch.sqrt(r2 + bb * torch.exp(-r2 / (4.0 * bb)))
        f_cut = 1.0 / f
        if self.dist_cutoff:
            f_cut = f_cut - 1.0 / self.dist_cutoff
        if self.kappa:
            pre = f_solute + torch.exp(-self.kappa * f) * f_solvent
        else:
            pre = f_solute + f_solvent
        e_pair = pre * (q[:, None] * q[None, :]) * f_cut
        zero = torch.zeros_like(r2)
        if self.dist_cutoff:
            e_pair = torch.where(r2 > self.dist_cutoff ** 2, zero, e_pair)
        e = torch.where(eye, zero, e_pair).sum() * 0.5
        if self.kappa:
            pre_d = f_solute + torch.exp(-self.kappa * bs) * f_solvent
        else:
            pre_d = f_solute + f_solvent
        e = e + (pre_d * q * q / (2.0 * bs)).sum()
        if self.use_ace:
            radius = self.offset_radii.to(coords.dtype) + self.offset
            sa = (self.sa_factor * (radius + self.probe_radius) ** 2
                  * (radius / bs) ** 6)
            e = e + torch.where(bs > 0, sa, torch.zeros_like(sa)).sum()
        return e


@dataclasses.dataclass(frozen=True)
class ImplicitSolventGBN2(ImplicitSolventOBC):
    """GBn2: per-atom alpha, beta, gamma and the neck correction of each
    pair from the (N, N) d0, m0 tables."""

    alphas: torch.Tensor = None   # (N,)
    betas: torch.Tensor = None
    gammas: torch.Tensor = None
    d0: torch.Tensor = None       # (N, N)
    m0: torch.Tensor = None       # (N, N)
    neck_scale: float = GBN2_NECK_SCALE
    neck_cut: float = GBN2_NECK_CUT

    def born_radii(self, coords, boundary):
        _, r, dead, I = self._born_sum(coords, boundary)
        # the neck integral's fit is in Angstrom
        radius = self.offset_radii.to(coords.dtype) + self.offset
        rsum = radius[:, None] + radius[None, :] + self.neck_cut
        rd = 10.0 * (r - self.d0.to(coords.dtype))
        neck = (self.neck_scale * self.m0.to(coords.dtype)
                / (1.0 + rd ** 2 + 0.3 * rd ** 6))
        I = I + torch.where(dead | (r >= rsum), torch.zeros_like(neck), neck)
        dt = coords.dtype
        return self._radii_from_I(I.sum(dim=1), self.alphas.to(dt),
                                  self.betas.to(dt), self.gammas.to(dt))


def make_implicit_solvent(model, struct, bonds, charges, type_of=None,
                          dist_cutoff=0.0, kappa=0.0, dtype=torch.float32,
                          device=None, **kw):
    """The implicit-solvent interaction of a PDB structure and its bonds:
    model "obc1", "obc2" or "gbn2", no distance cutoff by default
    (mollytpu/ops/gbsa.py:303-351). ``kw`` sets other fields (the
    dielectrics, probe_radius, sa_factor, use_ace)."""
    device = resolve_device(device)
    elements = [e.capitalize() if len(e) > 1 else e.upper()
                for e in struct.elements]
    res_names = [struct.residues[r].name for r in struct.res_index_of_atom]
    atom_names = struct.atom_names
    model = model.lower()

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    if model in ("obc1", "obc2"):
        radii = assign_radii(elements, res_names, atom_names, type_of, bonds)
        orr = radii - OBC_OFFSET
        screen = np.array([OBC_SCREEN.get(e, OBC_SCREEN["-"])
                           for e in elements])
        a, b, g = (1.0, 0.8, 4.85) if model == "obc2" else (0.8, 0.0,
                                                             2.909125)
        return ImplicitSolventOBC(
            offset_radii=t(orr), scaled_radii=t(screen * orr), alpha=a,
            beta=b, gamma=g, offset=OBC_OFFSET, kappa=float(kappa),
            dist_cutoff=float(dist_cutoff), **kw)
    if model == "gbn2":
        radii = assign_radii(elements, res_names, atom_names, type_of, bonds,
                             mbondi3=True)
        orr = radii - GBN2_OFFSET
        nucleic = [res_names[i] in NUCLEIC_RESIDUES
                   for i in range(len(elements))]
        screen = np.array([(GBN2_SCREEN_NUCLEIC if nuc else GBN2_SCREEN)
                           .get(e, 0.5) for e, nuc in zip(elements, nucleic)])
        abg = np.array([(GBN2_ABG_NUCLEIC if nuc else GBN2_ABG)
                        .get(e, GBN2_ABG["-"])
                        for e, nuc in zip(elements, nucleic)])
        d0, m0 = neck_lookup(radii)
        return ImplicitSolventGBN2(
            offset_radii=t(orr), scaled_radii=t(screen * orr),
            alphas=t(abg[:, 0]), betas=t(abg[:, 1]), gammas=t(abg[:, 2]),
            d0=t(d0), m0=t(m0), offset=GBN2_OFFSET, kappa=float(kappa),
            dist_cutoff=float(dist_cutoff), **kw)
    raise ValueError(f"unknown implicit solvent model {model}; one of "
                     f"{MODELS}")
