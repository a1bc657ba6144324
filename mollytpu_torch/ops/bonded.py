"""Bonded ("specific") interactions: bonds, angles, torsions, restraints
(counterpart of mollytpu/ops/bonded.py).

Every bonded term type is a row of a ``SpecificList``: (K, arity) atom
indices plus named (K,) parameter tensors, always with a ``weight`` column.
``TERM_FUNCS`` maps a list's ``kind`` to a function of the gathered term
coordinates (K, arity, 3), the box and the parameters that returns the
terms' energies (K,) and, when asked, their gradients (K, arity, 3).

The built-in kinds write their gradients by hand from the JAX package's own
formulas: one geometry gradient for distances, one for angles (atan2 of
|v1 x v2| and v1 . v2) and one for dihedrals, each with the JAX package's
+1e-24 inside the square root, and per kind only dE/dr, dE/dtheta or
dE/dphi. The minimum-image choice (a rounding) has zero gradient, as under
JAX's autodiff. A kind added with ``register_term`` gives its energies
only; its gradients come from torch.autograd.

``all_specific_forces`` gathers the rows of all lists with one index and
scatters their forces back with one ``index_add_``; the virial uses the
reference-atom scheme: per term, the minimum-image vector from the term's
first atom to each of its atoms times that atom's force.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..config import resolve_device, tracks_grad

_EPS = 1e-24


@dataclasses.dataclass(frozen=True)
class SpecificList:
    """Same-kind bonded terms: ``atom_idx`` (K, arity) int64, ``params`` a
    dict of (K,) tensors that always holds ``weight``."""

    kind: str
    atom_idx: torch.Tensor = None
    params: Dict[str, torch.Tensor] = None

    @property
    def n_terms(self) -> int:
        return int(self.atom_idx.shape[0])

    @property
    def arity(self) -> int:
        return int(self.atom_idx.shape[1])

    def to(self, device=None, dtype=None):
        """The list on another device, its parameters in another dtype."""
        return SpecificList(self.kind, self.atom_idx.to(device=device),
                            {k: v.to(device=device, dtype=dtype)
                             for k, v in self.params.items()})


# --- geometry: each returns the variable and its gradient --------------------


def _distance(a, b, boundary, grad):
    """|MIC(b - a)| over (..., 3) and, with grad, d r / d b (= -d r / d a)."""
    d = boundary.displacement(a, b)
    r = torch.sqrt((d * d).sum(-1) + _EPS)
    return r, (d / r[..., None] if grad else None)


def _angle(x, boundary, grad):
    """The angle at x[:, 1] of x (K, 3, 3), atan2(|v1 x v2|, v1 . v2) with
    v1 = x0 - x1 and v2 = x2 - x1, and with grad its gradient (K, 3, 3)."""
    v = boundary.displacement(x[:, 1:2], x[:, 0::2])     # (K, 2, 3)
    v1, v2 = v[:, 0], v[:, 1]
    w = torch.linalg.cross(v1, v2)
    s = torch.sqrt((w * w).sum(-1) + _EPS)
    c = (v1 * v2).sum(-1)
    theta = torch.atan2(s, c)
    if not grad:
        return theta, None
    # d theta = (c ds - s dc) / (s^2 + c^2); ds/dv1 = (v2 x w) / s,
    # ds/dv2 = (w x v1) / s, dc/dv1 = v2, dc/dv2 = v1
    den = (s * s + c * c)[:, None]
    cs = (c / s)[:, None]
    g1 = (cs * torch.linalg.cross(v2, w) - s[:, None] * v2) / den
    g3 = (cs * torch.linalg.cross(w, v1) - s[:, None] * v1) / den
    return theta, torch.stack([g1, -(g1 + g3), g3], dim=1)


def _dihedral(x, boundary, grad):
    """The signed dihedral of x (K, 4, 3) between planes (0, 1, 2) and
    (1, 2, 3), atan2(|b2| b1 . (b2 x b3), (b1 x b2) . (b2 x b3)) as in the
    JAX package, and with grad its gradient (K, 4, 3)."""
    b = boundary.displacement(x[:, :3], x[:, 1:])        # (K, 3, 3)
    b1, b2, b3 = b[:, 0], b[:, 1], b[:, 2]
    c1 = torch.linalg.cross(b1, b2)
    c2 = torch.linalg.cross(b2, b3)
    n = torch.sqrt((b2 * b2).sum(-1) + _EPS)
    y = (torch.linalg.cross(c1, c2) * b2).sum(-1) / n
    phi = torch.atan2(y, (c1 * c2).sum(-1))
    if not grad:
        return phi, None
    # the exact gradient of that angle (Blondel & Karplus, J. Comput.
    # Chem. 17, 1132 (1996)): the end atoms move along their plane's
    # normal, the middle ones take the balance
    gi = -(n / (c1 * c1).sum(-1))[:, None] * c1
    gl = (n / (c2 * c2).sum(-1))[:, None] * c2
    p = ((b1 * b2).sum(-1) / (n * n))[:, None]
    q = ((b3 * b2).sum(-1) / (n * n))[:, None]
    gj = -gi - p * gi + q * gl
    gk = -gl + p * gi - q * gl
    return phi, torch.stack([gi, gj, gk, gl], dim=1)


def _pair_term(x, boundary, grad, fn):
    """A term of the distance r between x[:, 0] and x[:, 1]:
    fn(r) -> (E, dE/dr)."""
    r, u = _distance(x[:, 0], x[:, 1], boundary, grad)
    e, de = fn(r)
    if not grad:
        return e, None
    g = de[:, None] * u
    return e, torch.stack([-g, g], dim=1)


def _scaled(e, de, g, grad):
    return e, (de[:, None, None] * g if grad else None)


# --- the built-in kinds: fn(x (K, A, 3), boundary, p, grad) ------------------


def _harmonic_bond(x, boundary, p, grad):
    return _pair_term(x, boundary, grad, lambda r: (
        0.5 * p["k"] * (r - p["r0"]) ** 2, p["k"] * (r - p["r0"])))


def _morse_bond(x, boundary, p, grad):
    def fn(r):
        ex = torch.exp(-p["a"] * (r - p["r0"]))
        one = 1.0 - ex
        return p["D"] * one * one, 2.0 * p["D"] * one * p["a"] * ex
    return _pair_term(x, boundary, grad, fn)


def _fene_bond(x, boundary, p, grad):
    # -(k/2) r0^2 ln(1 - (r/r0)^2) + WCA(sigma, epsilon); the ratio is
    # clipped to [0, 0.999999] and, as jnp.clip's gradient, is constant
    # beyond the clip
    def fn(r):
        raw = (r / p["r0"]) ** 2
        ratio2 = torch.clamp(raw, 0.0, 0.999999)
        fene = -0.5 * p["k"] * p["r0"] ** 2 * torch.log(1.0 - ratio2)
        d_fene = torch.where(raw <= 0.999999, p["k"] * r / (1.0 - ratio2),
                             torch.zeros_like(r))
        sig, eps = p["sigma"], p["epsilon"]
        six = (sig / r) ** 6
        on = (r < 2.0 ** (1.0 / 6.0) * sig) & (eps > 0)
        zero = torch.zeros_like(r)
        wca = torch.where(on, 4.0 * eps * (six * six - six) + eps, zero)
        d_wca = torch.where(on, -24.0 * eps * (2.0 * six * six - six) / r,
                            zero)
        return fene + wca, d_fene + d_wca
    return _pair_term(x, boundary, grad, fn)


def _harmonic_angle(x, boundary, p, grad):
    theta, g = _angle(x, boundary, grad)
    dt = theta - p["theta0"]
    return _scaled(0.5 * p["k"] * dt * dt, p["k"] * dt, g, grad)


def _cosine_angle(x, boundary, p, grad):
    theta, g = _angle(x, boundary, grad)
    dt = theta - p["theta0"]
    return _scaled(p["k"] * (1.0 + torch.cos(dt)), -p["k"] * torch.sin(dt),
                   g, grad)


def _urey_bradley(x, boundary, p, grad):
    e, g = _harmonic_angle(x, boundary, {"k": p["kangle"],
                                         "theta0": p["theta0"]}, grad)
    e13, g13 = _harmonic_bond(x[:, 0::2], boundary,
                              {"k": p["kbond"], "r0": p["r0"]}, grad)
    if grad:
        g = g + torch.stack([g13[:, 0], torch.zeros_like(g13[:, 0]),
                             g13[:, 1]], dim=1)
    return e + e13, g


def _periodic_torsion(x, boundary, p, grad):
    phi, g = _dihedral(x, boundary, grad)
    arg = p["periodicity"] * phi - p["phase"]
    return _scaled(p["k"] * (1.0 + torch.cos(arg)),
                   -p["k"] * p["periodicity"] * torch.sin(arg), g, grad)


def _rb_torsion(x, boundary, p, grad):
    # GROMACS Ryckaert-Bellemans: V = sum_n c_n cos(psi)^n, psi = phi - pi
    phi, g = _dihedral(x, boundary, grad)
    cos_psi = torch.cos(phi - math.pi)
    e, de, cp = p["c0"], torch.zeros_like(phi), torch.ones_like(phi)
    for n in range(1, 6):
        de = de + n * p[f"c{n}"] * cp
        cp = cp * cos_psi
        e = e + p[f"c{n}"] * cp
    return _scaled(e, -de * torch.sin(phi - math.pi), g, grad)


def _harmonic_torsion(x, boundary, p, grad):
    # V = k (phi - theta0)^2, no 1/2, the difference wrapped into
    # (-pi, pi] (the wrap's rounding has zero gradient)
    phi, g = _dihedral(x, boundary, grad)
    d = phi - p["theta0"]
    d = d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))
    return _scaled(p["k"] * d * d, 2.0 * p["k"] * d, g, grad)


def _position_restraint(x, boundary, p, grad):
    x0 = torch.stack([p["x0"], p["y0"], p["z0"]], dim=-1)
    dr = boundary.displacement(x[:, 0], x0)
    e = 0.5 * p["k"] * (dr * dr).sum(-1)
    return e, ((-p["k"][:, None] * dr)[:, None] if grad else None)


def _ewald_exclusion(x, boundary, p, grad):
    # -ke qi qj erf(alpha r) / r: cancels the reciprocal-space interaction
    # of a pair excluded from the Ewald sum
    def fn(r):
        a = p["alpha"]
        erf = torch.erf(a * r)
        gauss = (2.0 / math.sqrt(math.pi)) * a * torch.exp(-(a * r) ** 2)
        return -p["kqq"] * erf / r, -p["kqq"] * (gauss / r - erf / (r * r))
    return _pair_term(x, boundary, grad, fn)


TERM_FUNCS = {
    "harmonic_bond": _harmonic_bond,
    "morse_bond": _morse_bond,
    "fene_bond": _fene_bond,
    "harmonic_angle": _harmonic_angle,
    "cosine_angle": _cosine_angle,
    "urey_bradley": _urey_bradley,
    "periodic_torsion": _periodic_torsion,
    "rb_torsion": _rb_torsion,
    "harmonic_torsion": _harmonic_torsion,
    "position_restraint": _position_restraint,
    "ewald_exclusion": _ewald_exclusion,
}


def register_term(kind, fn):
    """Add a bonded term kind. ``fn(x, boundary, p)`` takes the gathered
    term coordinates (K, arity, 3), the box and the (K,) parameters
    (without ``weight``) and returns the (K,) energies; their gradients come
    from torch.autograd, and keep their graph when x or a parameter tracks
    grad."""

    def term(x, boundary, p, grad):
        if not grad:
            return fn(x, boundary, p), None
        graph = tracks_grad(x, *p.values())
        with torch.enable_grad():
            xg = x if graph and x.requires_grad else x.detach(
            ).requires_grad_(True)
            e = fn(xg, boundary, p)
            g, = torch.autograd.grad(e.sum(), xg, create_graph=graph)
        return (e if graph else e.detach()), g

    TERM_FUNCS[kind] = term


# --- list builders ----------------------------------------------------------


def _soa(kind, idx_cols, dtype, device, **params):
    device = resolve_device(device)
    idx = torch.stack([torch.as_tensor(c, dtype=torch.int64, device=device)
                       .reshape(-1) for c in idx_cols], dim=1)
    p = {k: torch.as_tensor(v, dtype=dtype, device=device).reshape(-1)
         for k, v in params.items() if v is not None}
    if "weight" not in p:
        p["weight"] = torch.ones(idx.shape[0], dtype=dtype, device=device)
    return SpecificList(kind=kind, atom_idx=idx, params=p)


def harmonic_bonds(i, j, k, r0, weight=None, dtype=torch.float32,
                   device=None):
    return _soa("harmonic_bond", (i, j), dtype, device, k=k, r0=r0,
                weight=weight)


def morse_bonds(i, j, D, a, r0, dtype=torch.float32, device=None):
    return _soa("morse_bond", (i, j), dtype, device, D=D, a=a, r0=r0)


def fene_bonds(i, j, k, r0, sigma, epsilon, dtype=torch.float32,
               device=None):
    return _soa("fene_bond", (i, j), dtype, device, k=k, r0=r0, sigma=sigma,
                epsilon=epsilon)


def harmonic_angles(i, j, k_idx, k, theta0, dtype=torch.float32,
                    device=None):
    return _soa("harmonic_angle", (i, j, k_idx), dtype, device, k=k,
                theta0=theta0)


def cosine_angles(i, j, k_idx, k, theta0, dtype=torch.float32, device=None):
    return _soa("cosine_angle", (i, j, k_idx), dtype, device, k=k,
                theta0=theta0)


def urey_bradleys(i, j, k_idx, kangle, theta0, kbond, r0,
                  dtype=torch.float32, device=None):
    return _soa("urey_bradley", (i, j, k_idx), dtype, device, kangle=kangle,
                theta0=theta0, kbond=kbond, r0=r0)


def periodic_torsions(i, j, k_idx, l, periodicity, phase, k,
                      dtype=torch.float32, device=None):
    """One row per Fourier term: a torsion of several periodicities is
    several rows with the same atom indices."""
    return _soa("periodic_torsion", (i, j, k_idx, l), dtype, device,
                periodicity=periodicity, phase=phase, k=k)


def rb_torsions(i, j, k_idx, l, coeffs, dtype=torch.float32, device=None):
    """coeffs: (K, 6) Ryckaert-Bellemans coefficients."""
    coeffs = torch.as_tensor(coeffs).reshape(-1, 6)
    return _soa("rb_torsion", (i, j, k_idx, l), dtype, device,
                **{f"c{n}": coeffs[:, n] for n in range(6)})


def harmonic_torsions(i, j, k_idx, l, k, theta0, dtype=torch.float32,
                      device=None):
    return _soa("harmonic_torsion", (i, j, k_idx, l), dtype, device, k=k,
                theta0=theta0)


def position_restraints(i, k, x0, dtype=torch.float32, device=None):
    """Restrain atoms i to the positions x0 (K, 3) with constants k."""
    x0 = torch.as_tensor(x0).reshape(-1, 3)
    return _soa("position_restraint", (i,), dtype, device, k=k,
                x0=x0[:, 0], y0=x0[:, 1], z0=x0[:, 2])


def ewald_exclusions(i, j, kqq, alpha, dtype=torch.float32, device=None):
    """Reciprocal-space corrections of pairs excluded from an Ewald sum:
    U = -kqq erf(alpha r) / r with kqq = ke qi qj / epsilon_r."""
    return _soa("ewald_exclusion", (i, j), dtype, device, kqq=kqq,
                alpha=alpha)


# --- evaluation -------------------------------------------------------------


def _evaluate(slist, x, boundary, grad):
    """(weighted energies (K,), weighted gradients (K, A, 3) or None)."""
    p = dict(slist.params)
    w = p.pop("weight")
    e, g = TERM_FUNCS[slist.kind](x, boundary, p, grad)
    return w * e, (w[:, None, None] * g if grad else None)


def specific_energy(slist: SpecificList, coords, boundary):
    """Total energy of the list's terms."""
    if slist.n_terms == 0:
        return torch.zeros((), dtype=coords.dtype, device=coords.device)
    x = coords[slist.atom_idx]
    return _evaluate(slist, x, boundary, False)[0].sum()


def all_specific_forces(slists, coords, boundary, needs_virial=False):
    """(forces (N, 3), virial (3, 3)) of all the lists: one gather of the
    concatenated term rows, one index_add_ of their forces."""
    vir = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device)
    live = [s for s in slists if s.n_terms]
    if not live:
        return torch.zeros_like(coords), vir
    parts = [s.atom_idx.reshape(-1) for s in live]
    idx = parts[0] if len(parts) == 1 else torch.cat(parts)
    rows = coords.index_select(0, idx)
    g_parts, start = [], 0
    for s in live:
        size = s.n_terms * s.arity
        x = rows[start:start + size].view(s.n_terms, s.arity, 3)
        start += size
        g_parts.append(_evaluate(s, x, boundary, True)[1].reshape(-1, 3))
    g = g_parts[0] if len(g_parts) == 1 else torch.cat(g_parts)
    # the forces are -g
    forces = torch.zeros_like(coords).index_add_(0, idx, g, alpha=-1)
    if needs_virial:
        # the MIC vector from each term's first atom to each of its atoms
        refs = [s.atom_idx[:, :1].expand(-1, s.arity).reshape(-1)
                for s in live]
        ref = refs[0] if len(refs) == 1 else torch.cat(refs)
        rel = boundary.displacement(coords.index_select(0, ref), rows)
        vir = -(rel.T @ g)
    return forces, vir


def specific_forces(slist: SpecificList, coords, boundary,
                    needs_virial=False):
    """(forces (N, 3), virial (3, 3)) of one list."""
    return all_specific_forces((slist,), coords, boundary, needs_virial)
