"""Holonomic distance constraints: SHAKE / RATTLE
(counterpart of mollytpu/ops/constraints.py:33-611, 622-769).

Constraints are grouped into disjoint clusters of one shape (single bond,
path of two, star of three, triangle), and each shape bucket is solved for
all its clusters at once: Newton iterations with a closed-form <= 3 x 3
linear solve for positions (SHAKE), one closed-form solve for velocities
(RATTLE). A constraint graph with a component of any other shape (a chain
of all bonds, a ring) is solved as a whole by the JAX package's global
Jacobi sweeps: ``n_iters`` sweeps for positions and ``vel_iters`` for
velocities, each moving every constraint's two atoms by its multiplier
(damped by ``omega``) and summing the moves per atom with ``index_add_``
(the JAX package gathers them from per-atom incidence tables, a TPU
layout; the sums are the same).

``setup_constraints`` makes the constraint pairs of a topology
("hbonds", "allbonds", "hangles", rigid water) and ``build_constrainers``
the solvers: all on SHAKE / RATTLE, or with ``algorithm="lincs"`` the
closed triangles on SHAKE and the rest on LINCS (ops/lincs.py).
``SHAKERattle.triangles`` builds rigid waters' solver without the graph
walk.

On a CUDA card a TRIANGLE bucket (rigid water), in any box, is solved by
``csrc/rigid_triangles.cu``, one thread per triangle running the same
Newton iterations and closed-form solves in one launch a call
(``native.LAUNCHES`` counts them); coordinates on the card in another
type than float32 or float64 raise. Every other bucket, and every bucket
on the CPU, takes the PyTorch solve, which is the kernel's twin.

``SWEEPS`` counts SHAKE / RATTLE's calls and the sweeps they ran (Newton
iterations of a cluster solve, one closed-form solve of a velocity
cluster, the global Jacobi sweeps), on the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from collections import Counter, defaultdict

import numpy as np
import torch

from . import native

#: supported in-cluster topologies, ((slot_i, slot_j), ...) per constraint
SINGLE = ((0, 1),)
PATH2 = ((0, 1), (0, 2))
STAR3 = ((0, 1), (0, 2), (0, 3))
TRIANGLE = ((0, 1), (0, 2), (1, 2))

#: SHAKE / RATTLE calls and the sweeps they ran, counted on the host
SWEEPS = {"position_calls": 0, "position_sweeps": 0, "velocity_calls": 0,
          "velocity_sweeps": 0}


def _count(kind, sweeps):
    SWEEPS[kind + "_calls"] += 1
    SWEEPS[kind + "_sweeps"] += sweeps


_SIG = {"triangle_shake_launch": [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p],
        "triangle_rattle_launch": [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def _on_kernel(bucket, x):
    """Whether ``bucket`` is solved by the rigid-triangle kernel: a
    TRIANGLE bucket of coordinates on a CUDA card."""
    return bucket.pattern == TRIANGLE and x.is_cuda


def _triangle_launch(fn, *args, x, boundary):
    """Launch ``fn`` of csrc/rigid_triangles.cu on the current stream of
    x's device in ``boundary``'s box (the args hold its ``mic_tensors``)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError("the rigid-triangle kernel takes float32 or float64 "
                        f"coordinates, not {x.dtype}")
    native.launch("rigid_triangles", fn, _SIG, *args,
                  int(getattr(boundary, "basis", None) is not None),
                  int(x.dtype == torch.float64), device=x.device)


@dataclasses.dataclass(frozen=True)
class ClusterBucket:
    """All clusters of one shape: atoms (C, MA) int64, dists (C, MC)."""

    atoms: torch.Tensor
    dists: torch.Tensor
    pattern: tuple = ()


def _build_clusters(pairs, dists):
    """Partition the constraint graph into shape buckets of numpy rows, or
    return None if a component has an unsupported shape."""
    adj = defaultdict(list)
    for c, (i, j) in enumerate(pairs):
        adj[int(i)].append(c)
        adj[int(j)].append(c)
    seen_c = np.zeros(len(pairs), dtype=bool)
    buckets = defaultdict(list)   # pattern -> list of (atom_list, dist_list)
    for c0 in range(len(pairs)):
        if seen_c[c0]:
            continue
        comp, stack, atoms_in = [], [c0], set()
        seen_c[c0] = True
        while stack:
            c = stack.pop()
            comp.append(c)
            for a in (int(pairs[c, 0]), int(pairs[c, 1])):
                if a not in atoms_in:
                    atoms_in.add(a)
                    for c2 in adj[a]:
                        if not seen_c[c2]:
                            seen_c[c2] = True
                            stack.append(c2)
        cp = [(int(pairs[c, 0]), int(pairs[c, 1])) for c in comp]
        cd = [float(dists[c]) for c in comp]
        na, nc = len(atoms_in), len(comp)
        if nc == 1:
            buckets[SINGLE].append((list(cp[0]), cd))
        elif nc == 2 and na == 3:
            (a1, b1), (a2, b2) = cp
            center = a1 if a1 in (a2, b2) else b1
            o1 = b1 if a1 == center else a1
            o2 = b2 if a2 == center else a2
            buckets[PATH2].append(([center, o1, o2], cd))
        elif nc == 3 and na == 3:
            al = sorted(atoms_in)
            dmap = {frozenset(p): d for p, d in zip(cp, cd)}
            buckets[TRIANGLE].append((al, [dmap[frozenset((al[0], al[1]))],
                                           dmap[frozenset((al[0], al[2]))],
                                           dmap[frozenset((al[1], al[2]))]]))
        elif nc == 3 and na == 4:
            center, k = Counter(a for p in cp for a in p).most_common(1)[0]
            if k != 3:
                return None
            others = [p[1] if p[0] == center else p[0] for p in cp]
            buckets[STAR3].append(([center] + others, cd))
        else:
            return None
    out = []
    for pattern, rows in buckets.items():
        atoms = np.asarray([r[0] for r in rows], dtype=np.int64)
        dd = np.asarray([r[1] for r in rows], dtype=np.float64)
        # canonical slot order (single i < j; path/star others ascending,
        # distances follow), clusters sorted by first atom
        if pattern == SINGLE:
            atoms = np.sort(atoms, axis=1)
        elif pattern in (PATH2, STAR3):
            order = np.argsort(atoms[:, 1:], axis=1)
            atoms[:, 1:] = np.take_along_axis(atoms[:, 1:], order, axis=1)
            dd = np.take_along_axis(dd, order, axis=1)
        rows_order = np.argsort(atoms[:, 0], kind="stable")
        out.append((pattern, atoms[rows_order], dd[rows_order]))
    return out


def _solve_small(C, r):
    """Closed-form solve of the per-cluster system C k = r (size <= 3),
    vectorised over clusters; C is a list of lists of (C,) tensors."""
    mc = len(r)

    def guard(x, tiny):
        return torch.where(x.abs() > tiny, x, torch.full_like(x, tiny))

    if mc == 1:
        return [r[0] / guard(C[0][0], 1e-12)]
    if mc == 2:
        det = guard(C[0][0] * C[1][1] - C[0][1] * C[1][0], 1e-20)
        return [(r[0] * C[1][1] - r[1] * C[0][1]) / det,
                (C[0][0] * r[1] - C[1][0] * r[0]) / det]
    a, bb, c = C[0]
    d, e, f = C[1]
    g, h, i = C[2]
    co00, co01, co02 = e * i - f * h, c * h - bb * i, bb * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, bb * g - a * h, a * e - bb * d
    det = guard(a * co00 + bb * co10 + c * co20, 1e-20)
    return [(r[0] * co00 + r[1] * co01 + r[2] * co02) / det,
            (r[0] * co10 + r[1] * co11 + r[2] * co12) / det,
            (r[0] * co20 + r[1] * co21 + r[2] * co22) / det]


def _sign(pattern, a, t):
    """+1 if slot a is the i end of constraint t, -1 for the j end, else 0."""
    ti, tj = pattern[t]
    return 1.0 if a == ti else (-1.0 if a == tj else 0.0)


@dataclasses.dataclass(frozen=True)
class SHAKERattle:
    """All distance constraints of a system, bucketed by cluster shape."""

    idx_i: torch.Tensor   # (K,) int64
    idx_j: torch.Tensor   # (K,) int64
    dists: torch.Tensor   # (K,) target distances (nm)
    clusters: tuple = ()  # (ClusterBucket, ...); () for the global sweeps
    # Newton iterations of the cluster SHAKE solve: quadratic convergence
    # takes MD-step-sized violations to ~1e-14 in 3; 5 leaves margin
    newton_iters: int = 5
    # the global Jacobi sweeps (mollytpu/ops/constraints.py:171-176)
    n_iters: int = 60
    vel_iters: int = 60
    omega: float = 1.0

    @property
    def n_constraints(self) -> int:
        return int(self.idx_i.shape[0])

    @classmethod
    def build(cls, pairs, dists, dtype=torch.float32, device=None,
              n_iters=60, vel_iters=60, omega=1.0):
        """The constraints of ``pairs`` at ``dists``: cluster solves where
        every component of the graph has a cluster shape, else the global
        sweeps for all of them."""
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        dists = np.array(dists, dtype=np.float64)
        buckets = _build_clusters(pairs, dists) if len(pairs) else None
        return cls(torch.as_tensor(pairs[:, 0], device=device),
                   torch.as_tensor(pairs[:, 1], device=device),
                   torch.as_tensor(dists, dtype=dtype, device=device),
                   clusters=tuple(ClusterBucket(
                       atoms=torch.as_tensor(at, device=device),
                       dists=torch.as_tensor(dd, dtype=dtype, device=device),
                       pattern=pat) for pat, at, dd in buckets or ()),
                   n_iters=n_iters, vel_iters=vel_iters, omega=omega)

    @classmethod
    def triangles(cls, atoms, dists, dtype=torch.float32, device=None):
        """The solver ``build`` makes for disjoint rigid triangles, without
        its walk of the constraint graph: ``atoms`` (T, 3) each triangle's
        atoms in ascending order, ``dists`` (T, 3) the distances of its
        pairs (0, 1), (0, 2) and (1, 2), the order ``build`` gives them for
        the pairs listed triangle by triangle in that order."""
        atoms = np.asarray(atoms, dtype=np.int64).reshape(-1, 3)
        dists = np.asarray(dists, dtype=np.float64).reshape(-1, 3)
        if not (np.all(np.diff(atoms, axis=1) > 0)
                and np.unique(atoms).size == atoms.size):
            raise ValueError("triangles need disjoint triangles of atoms "
                             "in ascending order")
        pairs = atoms[:, [0, 1, 0, 2, 1, 2]].reshape(-1, 3, 2)
        return cls(torch.as_tensor(pairs[..., 0].reshape(-1), device=device),
                   torch.as_tensor(pairs[..., 1].reshape(-1), device=device),
                   torch.as_tensor(dists.reshape(-1), dtype=dtype,
                                   device=device),
                   clusters=(ClusterBucket(
                       atoms=torch.as_tensor(atoms, device=device),
                       dists=torch.as_tensor(dists, dtype=dtype,
                                             device=device),
                       pattern=TRIANGLE),) if len(atoms) else ())

    @staticmethod
    def _inv_masses(masses):
        positive = masses > 0
        return torch.where(positive, 1.0 / torch.where(
            positive, masses, torch.ones_like(masses)),
            torch.zeros_like(masses))

    def apply_position_constraints(self, coords_prev, coords_new, vels,
                                   masses, boundary, dt):
        """Project coords_new onto the constraint manifold along the
        pre-step bond directions; velocities get the implied correction
        dx / dt. Returns (coords, vels)."""
        if self.n_constraints == 0:
            return coords_new, vels
        _count("position", self.newton_iters if self.clusters
               else self.n_iters)
        inv_m = self._inv_masses(masses)
        if not self.clusters:
            out = self._sweep_positions(coords_prev, coords_new, inv_m,
                                        boundary)
            if vels is not None:
                vels = vels + (out - coords_new) / dt
            return out, vels
        out = coords_new.clone()
        for b in self.clusters:
            if _on_kernel(b, coords_new):
                box_a, box_b = boundary.mic_tensors(coords_new.dtype)
                _triangle_launch(
                    "triangle_shake_launch", coords_prev.contiguous(),
                    coords_new.contiguous(), out, b.atoms,
                    b.dists.to(coords_new.dtype).contiguous(),
                    masses.to(coords_new.dtype).contiguous(), box_a, box_b,
                    int(b.atoms.shape[0]), int(self.newton_iters),
                    x=coords_new, boundary=boundary)
                continue
            pat, mc = b.pattern, len(b.pattern)
            x0 = coords_prev[b.atoms]                      # (C, MA, 3)
            x_in = coords_new[b.atoms]
            im = inv_m[b.atoms]                            # (C, MA)
            d0 = b.dists.to(coords_new.dtype)              # (C, MC)
            rref = [boundary.displacement(x0[:, sj], x0[:, si])
                    for (si, sj) in pat]                   # x_i - x_j
            # c_st: how the multiplier of t moves the bond vector of s
            cst = [[_sign(pat, si, t) * im[:, si] - _sign(pat, sj, t)
                    * im[:, sj] for t in range(mc)] for (si, sj) in pat]
            drs = [boundary.displacement(x_in[:, sj], x_in[:, si])
                   for (si, sj) in pat]
            lam = [torch.zeros_like(d0[:, s]) for s in range(mc)]
            for _ in range(self.newton_iters):
                res = [(drs[s] * drs[s]).sum(dim=1) - d0[:, s] * d0[:, s]
                       for s in range(mc)]
                A = [[2.0 * cst[s][t] * (drs[s] * rref[t]).sum(dim=1)
                      for t in range(mc)] for s in range(mc)]
                delta = _solve_small(A, res)
                for s in range(mc):
                    lam[s] = lam[s] + delta[s]
                    drs[s] = drs[s] - sum((delta[t] * cst[s][t])[:, None]
                                          * rref[t] for t in range(mc))
            moves = []
            for a in range(b.atoms.shape[1]):
                acc = torch.zeros_like(x_in[:, a])
                for t in range(mc):
                    w = _sign(pat, a, t)
                    if w:
                        acc = acc - (w * lam[t] * im[:, a])[:, None] * rref[t]
                moves.append(acc)
            # clusters are disjoint: every atom is written once
            out.index_add_(0, b.atoms.reshape(-1),
                           torch.stack(moves, dim=1).reshape(-1, 3))
        if vels is not None:
            vels = vels + (out - coords_new) / dt
        return out, vels

    def apply_velocity_constraints(self, coords, vels, masses, boundary):
        """Remove the velocity components along constrained bonds (a linear
        projection, solved exactly per cluster)."""
        if self.n_constraints == 0:
            return vels
        _count("velocity", 1 if self.clusters else self.vel_iters)
        inv_m = self._inv_masses(masses)
        if not self.clusters:
            return self._sweep_velocities(coords, vels, inv_m, boundary)
        out = vels.clone()
        for b in self.clusters:
            if _on_kernel(b, coords):
                box_a, box_b = boundary.mic_tensors(coords.dtype)
                _triangle_launch(
                    "triangle_rattle_launch", coords.contiguous(),
                    vels.contiguous(), out, b.atoms,
                    masses.to(coords.dtype).contiguous(), box_a, box_b,
                    int(b.atoms.shape[0]), x=coords, boundary=boundary)
                continue
            pat, mc = b.pattern, len(b.pattern)
            xc = coords[b.atoms]
            v_in = vels[b.atoms]
            im = inv_m[b.atoms]
            drs = [boundary.displacement(xc[:, sj], xc[:, si])
                   for (si, sj) in pat]                     # x_i - x_j
            r = [((v_in[:, si] - v_in[:, sj]) * drs[s]).sum(dim=1)
                 for s, (si, sj) in enumerate(pat)]
            C = [[(drs[s] * drs[t]).sum(dim=1)
                  * (_sign(pat, si, t) * im[:, si]
                     - _sign(pat, sj, t) * im[:, sj])
                  for t in range(mc)] for s, (si, sj) in enumerate(pat)]
            ks = _solve_small(C, r)
            moves = []
            for a in range(b.atoms.shape[1]):
                acc = torch.zeros_like(v_in[:, a])
                for s, (si, sj) in enumerate(pat):
                    sign = -1.0 if a == si else (1.0 if a == sj else 0.0)
                    if sign:
                        acc = acc + (sign * ks[s] * im[:, a])[:, None] * drs[s]
                moves.append(acc)
            out.index_add_(0, b.atoms.reshape(-1),
                           torch.stack(moves, dim=1).reshape(-1, 3))
        return out

    def _scatter(self, out, per_constraint, im_i, im_j):
        """out with each constraint's vector moved onto its atoms: -im_i v
        onto i, +im_j v onto j."""
        both = torch.cat([-im_i[:, None] * per_constraint,
                          im_j[:, None] * per_constraint])
        return out.index_add_(0, torch.cat([self.idx_i, self.idx_j]), both)

    def _sweep_positions(self, coords_prev, coords_new, inv_m, boundary):
        """The global Jacobi SHAKE (mollytpu/ops/constraints.py:528-556):
        each sweep moves every constraint by its damped multiplier along
        its pre-step direction."""
        ii, jj = self.idx_i, self.idx_j
        d0 = self.dists.to(coords_new.dtype)
        im_i, im_j = inv_m[ii], inv_m[jj]
        r_ref = boundary.displacement(coords_prev[jj], coords_prev[ii])
        coords = coords_new.clone()
        for _ in range(self.n_iters):
            dr = boundary.displacement(coords[jj], coords[ii])
            diff = (dr * dr).sum(dim=1) - d0 * d0
            denom = 2.0 * (im_i + im_j) * (dr * r_ref).sum(dim=1)
            denom = torch.where(denom.abs() > 1e-12, denom,
                                torch.full_like(denom, 1e-12))
            g = self.omega * diff / denom
            self._scatter(coords, g[:, None] * r_ref, im_i, im_j)
        return coords

    def _sweep_velocities(self, coords, vels, inv_m, boundary):
        """The global Jacobi RATTLE (mollytpu/ops/constraints.py:568-588)."""
        ii, jj = self.idx_i, self.idx_j
        im_i, im_j = inv_m[ii], inv_m[jj]
        dr = boundary.displacement(coords[jj], coords[ii])
        den = (im_i + im_j) * torch.clamp((dr * dr).sum(dim=1), min=1e-12)
        vels = vels.clone()
        for _ in range(self.vel_iters):
            k = self.omega * ((vels[ii] - vels[jj]) * dr).sum(dim=1) / den
            self._scatter(vels, k[:, None] * dr, im_i, im_j)
        return vels

    def constraint_virial(self, coords_prev, coords_new_unconstrained,
                          coords_constrained, masses, boundary, dt):
        """W_ab = sum_i x_i,a m_i dx_i,b / dt^2 with dx the SHAKE
        correction: the virial of the constraint forces
        (mollytpu/ops/constraints.py:590-596). No integrator reads it."""
        return constraint_virial(coords_new_unconstrained,
                                 coords_constrained, masses, dt)

    def max_violation(self, coords, boundary):
        dr = boundary.displacement(coords[self.idx_j], coords[self.idx_i])
        r = torch.linalg.vector_norm(dr, dim=1)
        return torch.max(torch.abs(r - self.dists.to(coords.dtype)))


def constraint_virial(coords_new_unconstrained, coords_constrained, masses,
                      dt):
    """sum_i x_i (x) m_i (x_i - x_i^unconstrained) / dt^2, (3, 3)."""
    f_eq = masses[:, None] * (coords_constrained
                              - coords_new_unconstrained) / (dt * dt)
    return coords_constrained.T @ f_eq


#: the constraints= choices of setup_constraints and system_from_pdb
CONSTRAINTS = ("none", "hbonds", "allbonds", "hangles")
#: the constraint_algorithm= choices
ALGORITHMS = ("shake", "lincs")


def setup_constraints(struct, specific_lists, b_i, b_j, b_r0, a_i, a_j, a_k,
                      a_t0, constraints="none", rigid_water=False):
    """Constraint pairs and distances from the topology, and the bonded
    lists without the bond and angle rows the constraints replace:
    (pairs, dists, lists, triangle_rows), as the JAX package makes them
    (mollytpu/ops/constraints.py:622-745). Rigid water is an O-H, O-H, H-H
    triangle; "hbonds" adds every other bond to a hydrogen, "allbonds"
    every other bond, "hangles" the hydrogen bonds, the water triangles
    and each angle with two hydrogen ends or one hydrogen and a central O
    (its end-to-end distance, closing a triangle). ``triangle_rows`` are
    the rows of the pairs in closed triangles, which LINCS leaves to SHAKE.
    A list that loses all its rows stays, empty, in its place."""
    from ..models.setup import is_water

    if constraints not in CONSTRAINTS:
        raise ValueError(f"constraints={constraints!r} is not one of "
                         f"{CONSTRAINTS}")
    elements = [e.upper() for e in struct.elements]
    pairs, dists, triangle_rows = [], [], set()
    drop_bond_rows, drop_angle_rows, water_atoms = set(), set(), set()
    bond_len = {(min(i, j), max(i, j)): (row, r0)
                for row, (i, j, r0) in enumerate(zip(b_i, b_j, b_r0))}
    if rigid_water or constraints == "hangles":
        angle_map = {(i, j, k): row
                     for row, (i, j, k) in enumerate(zip(a_i, a_j, a_k))}
        for res in struct.residues:
            if not is_water(res.name):
                continue
            o = [a for a in res.atom_indices if elements[a] == "O"]
            h = [a for a in res.atom_indices if elements[a] == "H"]
            if len(o) != 1 or len(h) != 2:
                continue
            o, (h1, h2) = o[0], h
            key1, key2 = (min(o, h1), max(o, h1)), (min(o, h2), max(o, h2))
            if key1 not in bond_len or key2 not in bond_len:
                continue
            row1, r1 = bond_len[key1]
            row2, r2 = bond_len[key2]
            theta_row = next((angle_map[c] for c in ((h1, o, h2), (h2, o, h1))
                              if c in angle_map), None)
            if theta_row is None:
                continue
            theta0 = float(a_t0[theta_row])
            d_hh = math.sqrt(r1 ** 2 + r2 ** 2
                             - 2 * r1 * r2 * math.cos(theta0))
            triangle_rows.update(range(len(pairs), len(pairs) + 3))
            pairs += [(o, h1), (o, h2), (h1, h2)]
            dists += [r1, r2, d_hh]
            drop_bond_rows.update({row1, row2})
            drop_angle_rows.add(theta_row)
            water_atoms.update({o, h1, h2})
    if constraints != "none":
        for row, (i, j, r0) in enumerate(zip(b_i, b_j, b_r0)):
            if row in drop_bond_rows or i in water_atoms or j in water_atoms:
                continue
            if (constraints == "allbonds" or elements[i] == "H"
                    or elements[j] == "H"):
                pairs.append((i, j))
                dists.append(float(r0))
                drop_bond_rows.add(row)
    if constraints == "hangles":
        # the first row of each pair, as the JAX package's linear search
        # finds it
        row_of = {}
        for r, p in enumerate(pairs):
            row_of.setdefault(frozenset(p), r)
        for row, (i, j, k) in enumerate(zip(a_i, a_j, a_k)):
            if row in drop_angle_rows or i in water_atoms:
                continue
            n_h = (elements[i] == "H") + (elements[k] == "H")
            if not (n_h == 2 or (n_h == 1 and elements[j] == "O")):
                continue
            d_ij = bond_len.get((min(i, j), max(i, j)))
            d_jk = bond_len.get((min(j, k), max(j, k)))
            if d_ij is None or d_jk is None:
                continue
            d_ij, d_jk = float(d_ij[1]), float(d_jk[1])
            theta0 = float(a_t0[row])
            d_ik = math.sqrt(d_ij ** 2 + d_jk ** 2
                             - 2 * d_ij * d_jk * math.cos(theta0))
            # (i, j) and (j, k) are constrained H bonds: (i, k) closes a
            # triangle
            triangle_rows.add(len(pairs))
            for key in (frozenset((i, j)), frozenset((j, k))):
                if key in row_of:
                    triangle_rows.add(row_of[key])
            row_of.setdefault(frozenset((i, k)), len(pairs))
            pairs.append((i, k))
            dists.append(d_ik)
            drop_angle_rows.add(row)
    drops = {"harmonic_bond": drop_bond_rows,
             "harmonic_angle": drop_angle_rows}
    lists = tuple(_filter_rows(sl, drops[sl.kind]) if drops.get(sl.kind)
                  else sl for sl in specific_lists)
    return pairs, dists, lists, triangle_rows


def build_constrainers(pairs, dists, triangle_rows, masses,
                       algorithm="shake", dtype=torch.float32, device=None):
    """The solvers of the constraints (mollytpu/ops/constraints.py:746-762):
    one SHAKERattle, or with algorithm="lincs" the triangles on
    SHAKERattle and the rest on LINCS (built from ``masses``, the
    system's)."""
    from .lincs import LINCS

    if algorithm not in ALGORITHMS:
        raise ValueError(f"constraint_algorithm={algorithm!r} is not one "
                         f"of {ALGORITHMS}")
    if not pairs:
        return ()
    if algorithm == "shake":
        return (SHAKERattle.build(pairs, dists, dtype=dtype, device=device),)
    tri = sorted(triangle_rows)
    rest = [r for r in range(len(pairs)) if r not in triangle_rows]
    out = []
    if tri:
        out.append(SHAKERattle.build([pairs[r] for r in tri],
                                     [dists[r] for r in tri], dtype=dtype,
                                     device=device))
    if rest:
        out.append(LINCS.build([pairs[r] for r in rest],
                               [dists[r] for r in rest], masses, dtype=dtype,
                               device=device))
    return tuple(out)


def _filter_rows(slist, drop):
    """The list without the rows in ``drop``."""
    keep = torch.as_tensor([r not in drop for r in range(slist.n_terms)],
                           device=slist.atom_idx.device)
    return dataclasses.replace(
        slist, atom_idx=slist.atom_idx[keep],
        params={k: v[keep] for k, v in slist.params.items()})


def angle_constraint(i, j, k, dist_ij, dist_jk, angle):
    """An angle constraint as three distance constraints
    (mollytpu/ops/constraints.py:612-620): the pairs ((i, j), (j, k),
    (i, k)) and their distances, i-k from the law of cosines."""
    d_ik = math.sqrt(dist_ij ** 2 + dist_jk ** 2
                     - 2.0 * dist_ij * dist_jk * math.cos(angle))
    return [(i, j), (j, k), (i, k)], [dist_ij, dist_jk, d_ik]
