"""LAMMPS's bench/in.lj as the port builds it: ``models.ljbench``'s
lattice, velocities from the seed at T* (in.lj's ``velocity create``) and
the cell list rebuilt on the configured cadence, on the neighbor-table
engine. Its plain reference is ``reference/lj_fcc.py``, which builds the
same lattice itself."""

from __future__ import annotations

import math


def build(cfg, seed, device):
    import torch
    from mollytpu_torch.models import ljbench
    lj = cfg["lj"]
    system = ljbench.lj_bench_system(
        lj["n_cells"], torch.float32, device, seed,
        n_steps=cfg["neighbors"]["rebuild_every"], t_reduced=lj["t_reduced"])
    return system, {}


def reference(cfg, inputs, prec, device):
    from reference.lj_fcc import LJFcc
    return LJFcc(cfg, prec, device)


def time_unit_ps(cfg):
    """tau = sigma sqrt(m / epsilon) in ps."""
    lj = cfg["lj"]
    return lj["sigma_nm"] * math.sqrt(lj["mass_u"] / lj["epsilon_kj_mol"])


def program_start(system, nb, aux):
    """The lattice's forces vanish by symmetry, so the start check reads
    the pair energy of the lattice instead."""
    import mollytpu_torch as pt
    return {"e": pt.potential_energy(system, nb)}


def start_checks(ref, start):
    """The program's lattice energy against the reference's (LAMMPS prints
    -6.7733681 epsilon per atom at step 0)."""
    e_ref = ref.energy(ref.start)
    return {"e_start": abs(float(start["e"]) - float(e_ref))
            / abs(float(e_ref))}


def control_start(ref):
    return {"e": ref.energy(ref.start)}
