"""The System container, exclusion tables and molecule ids
(counterpart of mollytpu/system.py:31-220).

A System holds tensors on one device. Steps return updated Systems through
``update`` (``dataclasses.replace``); the tensors they share are not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .atoms import AtomData, Atoms
from .config import resolve_device
from .spatial import n_dof as calc_n_dof


def _pad_tables(n_atoms, pairs_i, pairs_j, width):
    """Build (N, width) per-atom partner tables from sparse symmetric pairs;
    unfilled slots hold the sentinel n_atoms. Each atom's partners fill its
    row in the order of the pairs, (a, b) giving b to a and then a to b."""
    table = np.full((n_atoms, width), n_atoms, dtype=np.int32)
    a = np.asarray(pairs_i, dtype=np.int64).reshape(-1)
    b = np.asarray(pairs_j, dtype=np.int64).reshape(-1)
    if a.size == 0:
        return table
    rows = np.stack([a, b], axis=1).reshape(-1)    # a0, b0, a1, b1, ...
    partners = np.stack([b, a], axis=1).reshape(-1)
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=n_atoms)
    slot = np.empty_like(order)
    slot[order] = np.arange(rows.size) - np.repeat(
        np.cumsum(counts) - counts, counts)
    over = slot >= width
    if over.any():
        raise ValueError(
            f"atom {int(rows[np.argmax(over)])} has more than {width} "
            "excluded/special partners; increase table width")
    table[rows, slot] = partners
    return table


#: windowed-bitmap half-width: partner offsets d = j - i with |d| <= 31 are
#: representable as bits; pairs outside the window go to the far lists.
EXCL_WINDOW = 32


def _bitmap_tables(n_atoms, pairs_i, pairs_j):
    """((N+1, 2) int32 windowed bitmaps, (F, 2) far pairs).

    Bit k of word (k // 32) at row i marks partner i + (k - EXCL_WINDOW),
    for k - EXCL_WINDOW in [-32, 31]. Pairs with |j - i| > 31 go to the far
    list, which the pair kernel's caller corrects after the kernel."""
    bits = np.zeros((n_atoms + 1, 2), dtype=np.uint32)
    a = np.asarray(pairs_i, dtype=np.int64).reshape(-1)
    b = np.asarray(pairs_j, dtype=np.int64).reshape(-1)
    # symmetric rule |b - a| <= 31: both directions representable, so a
    # pair is either fully in-window or fully in the far list
    near = np.abs(b - a) <= EXCL_WINDOW - 1
    for x, y in ((a[near], b[near]), (b[near], a[near])):
        d = y - x + EXCL_WINDOW
        np.bitwise_or.at(bits, (x, d // 32),
                         np.left_shift(np.uint32(1), (d % 32).astype(
                             np.uint32)))
    far = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)[~near]
    return bits.view(np.int32), far.astype(np.int32).reshape(-1, 2)


def _t(x, device=None):
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


@dataclasses.dataclass(frozen=True)
class Exclusions:
    """Excluded (1-2/1-3) and special (1-4) pairs: sparse (i < j) lists,
    padded per-atom tables, the windowed bitmaps the pair kernel tests, and
    the far pairs outside the bitmap window."""

    excl_i: torch.Tensor  # (E,) int32, i < j
    excl_j: torch.Tensor
    spec_i: torch.Tensor  # (S,) int32, i < j
    spec_j: torch.Tensor
    excl_table: torch.Tensor  # (N, We) int32, sentinel = N
    spec_table: torch.Tensor  # (N, Ws) int32, sentinel = N
    excl_bits: torch.Tensor   # (N+1, 2) int32 windowed bitmap, row N = 0
    spec_bits: torch.Tensor   # (N+1, 2) int32
    far_excl: torch.Tensor    # (F, 2) int32 pairs outside the window
    far_spec: torch.Tensor    # (F', 2) int32

    @classmethod
    def build(cls, n_atoms, excl_pairs=(), special_pairs=(), max_excl=16,
              max_special=16, device=None):
        """The tables on ``device`` (the CUDA card unless the caller names
        another)."""
        device = resolve_device(device)

        def norm(pairs):
            if len(pairs) == 0:
                return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
            arr = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
            lo = np.minimum(arr[:, 0], arr[:, 1])
            hi = np.maximum(arr[:, 0], arr[:, 1])
            uniq = np.unique(np.stack([lo, hi], axis=1), axis=0)
            return uniq[:, 0], uniq[:, 1]

        ei, ej = norm(excl_pairs)
        si, sj = norm(special_pairs)
        et = _pad_tables(n_atoms, ei, ej, max_excl)
        st = _pad_tables(n_atoms, si, sj, max_special)
        eb, fe = _bitmap_tables(n_atoms, ei, ej)
        sb, fs = _bitmap_tables(n_atoms, si, sj)
        return cls(*(_t(a, device) for a in (ei, ej, si, sj, et, st, eb, sb,
                                             fe, fs)))

    @classmethod
    def empty(cls, n_atoms, device=None):
        return cls.build(n_atoms, max_excl=1, max_special=1, device=device)


@dataclasses.dataclass(frozen=True)
class System:
    """Simulation state plus model description."""

    atoms: Atoms
    coords: torch.Tensor          # (N, 3) nm
    boundary: object              # boundary.Orthorhombic or Triclinic
    velocities: torch.Tensor = None  # (N, 3) nm/ps
    pairwise_inters: Tuple = ()
    specific_lists: Tuple = ()
    general_inters: Tuple = ()
    constraints: Tuple = ()
    virtual_sites: object = None  # ops.virtual_sites.VirtualSites or None
    exclusions: Exclusions = None
    neighbor_finder: object = None
    n_dof: int = 0
    molecule_ids: torch.Tensor = None   # (N,) int32; all 0 by default
    n_molecules: int = 1
    #: host-side names for the trajectory writers (set by system_from_pdb
    #: and system_from_gromacs);
    #: a field, so that ``update`` carries it
    atom_data: AtomData = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.velocities is None:
            object.__setattr__(self, "velocities",
                               torch.zeros_like(self.coords))
        if self.exclusions is None:
            object.__setattr__(self, "exclusions",
                               Exclusions.empty(self.n_atoms,
                                                self.coords.device))
        if self.molecule_ids is None:
            object.__setattr__(self, "molecule_ids", torch.zeros(
                self.n_atoms, dtype=torch.int32, device=self.coords.device))
        if self.n_dof == 0:
            n_constr = sum(c.n_constraints for c in self.constraints)
            n_frozen = (self.virtual_sites.n_sites
                        if self.virtual_sites is not None else 0)
            object.__setattr__(self, "n_dof", calc_n_dof(
                self.n_atoms, n_constr, self.n_dims, True, n_frozen))

    @property
    def n_atoms(self) -> int:
        return int(self.coords.shape[0])

    @property
    def n_dims(self) -> int:
        return int(self.coords.shape[1])

    @property
    def masses(self):
        return self.atoms.mass

    @property
    def device(self):
        return self.coords.device

    def update(self, **kw):
        return dataclasses.replace(self, **kw)


def molecule_ids_from_bonds(n_atoms, bond_pairs, device=None):
    """Connected components of the bond graph: ((N,) int32 molecule id per
    atom on ``device``, number of molecules). Union-find on the host at
    setup time (mollytpu/system.py:202-220)."""
    parent = np.arange(n_atoms)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in bond_pairs:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[ra] = rb
    roots = np.array([find(i) for i in range(n_atoms)], dtype=np.int64)
    _, ids = np.unique(roots, return_inverse=True)
    return (torch.as_tensor(ids.astype(np.int32),
                            device=resolve_device(device)),
            int(ids.max()) + 1 if n_atoms else 0)
