"""The dispatch rule of neighbor_forces on the CPU: which calls the
Lennard-Jones table kernel (csrc/lj_table.cu) takes on a CUDA card, as
lj_table_admits reads them from the inputs with the device aside, and
that a CPU call never launches it and runs the autograd engine
(neighbor_forces_plain) unchanged. The kernel itself is held to the
engine on the card by tests/test_torch_lj_table_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.ops import nonbonded as tnb
from torch_parity import CPU, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 48
RC = 0.8
LIST = 0.95
SIDE = 2.2
LJ = pt.LennardJones(cutoff=pt.DistanceCutoff(RC), use_neighbors=True)


def inputs(dtype=torch.float64, box="cube", seed=3):
    """(atoms, coords, boundary, neighbors) of a small LJ fluid on the CPU
    with per-atom sigma and epsilon and 1-4 pairs."""
    rng = np.random.default_rng(seed)
    sides = {"cube": (SIDE,) * 3, "open": (SIDE, SIDE, float("inf"))}
    if box == "triclinic":
        boundary = pt.triclinic_from_lengths_angles(
            (SIDE,) * 3, np.radians((80.0, 95.0, 100.0)), dtype=dtype,
            device=CPU)
    else:
        boundary = pt.rectangular(sides[box], dtype=dtype, device=CPU)
    frac = torch.as_tensor(rng.uniform(0.0, 1.0, (N, 3)), dtype=dtype)
    coords = frac * SIDE if box == "open" else boundary.from_fractional(frac)
    atoms = pt.make_atoms(
        n=N, mass=40.0, sigma=rng.uniform(0.30, 0.36, N),
        epsilon=rng.uniform(0.5, 1.5, N), dtype=dtype, device=CPU)
    excl = pt.Exclusions.build(N, [(i, i + 1) for i in range(0, N - 1, 4)],
                               [(i, i + 3) for i in range(0, N - 3, 6)],
                               device=CPU)
    nbs = pt.DistanceNeighborFinder(LIST, max_neighbors=N).find(
        coords, boundary, excl)
    return atoms, coords, boundary, nbs


def _with_grad_epsilon(atoms):
    return dataclasses.replace(atoms,
                               epsilon=atoms.epsilon.clone().requires_grad_())


def _with_grad_box(boundary):
    """The box with its tensors tracking a gradient, as a barostat's
    differentiable move makes it."""
    if isinstance(boundary, pt.Triclinic):
        return pt.Triclinic(boundary.basis.clone().requires_grad_(),
                            inv=boundary.inv.clone().requires_grad_())
    return pt.Orthorhombic(boundary.side_lengths.clone().requires_grad_())


#: name -> (admitted?, how the case changes the inputs: a function of
#: (inters, atoms, coords, boundary, neighbors) returning them changed)
CASES = {
    "lj-cube": (True, lambda *a: a),
    "lj-cube-f32": (True, None),
    "lj-open-axis": (True, None),
    "lj-weight-special": (True, lambda i, *a: (
        (dataclasses.replace(LJ, weight_special=0.5),), *a)),
    "lj-coulomb": (False, lambda i, *a: (
        (LJ, pt.CoulombReactionField(dist_cutoff=RC, use_neighbors=True)),
        *a)),
    "triclinic": (True, None),
    "dpd": (False, lambda i, *a: ((pt.DPDInteraction(r_c=RC),), *a)),
    "grad-epsilon": (False, lambda i, at, *a: (
        i, _with_grad_epsilon(at), *a)),
    "grad-coords": (False, lambda i, at, c, *a: (
        i, at, c.clone().requires_grad_(), *a)),
    "grad-box": (False, lambda i, at, c, b, nb: (
        i, at, c, _with_grad_box(b), nb)),
    "grad-box-triclinic": (False, lambda i, at, c, b, nb: (
        i, at, c, _with_grad_box(b), nb)),
    "box-on-another-device": (False, lambda i, at, c, b, nb: (
        i, at, c, pt.Orthorhombic(b.side_lengths.to("meta")), nb)),
    "float16": (False, lambda i, at, c, *a: (
        i, at.to(dtype=torch.float16), c.half(), *a)),
    "atoms-of-another-type": (False, lambda i, at, *a: (
        i, at.to(dtype=torch.float32), *a)),
    "no-cutoff": (False, lambda i, *a: (
        (dataclasses.replace(LJ, cutoff=pt.NoCutoff()),), *a)),
    "shifted-force": (False, lambda i, *a: (
        (dataclasses.replace(LJ, cutoff=pt.ShiftedForceCutoff(RC)),), *a)),
    "waldman-hagler": (False, lambda i, *a: (
        (dataclasses.replace(LJ, sigma_mixing=pt.WaldmanHaglerMixing(),
                             epsilon_mixing=pt.WaldmanHaglerMixing()),),
        *a)),
    "fender-halsey-epsilon": (False, lambda i, *a: (
        (dataclasses.replace(LJ, epsilon_mixing=pt.FenderHalseyMixing()),),
        *a)),
    "nbfix": (False, lambda i, *a: (
        (dataclasses.replace(LJ, sigma_mixing=pt.MixingException(
            pt.LorentzMixing(), pt.ExceptionTable((0,), (0,), (0.3,)))),),
        *a)),
    "soft-core": (False, lambda i, *a: (
        (pt.LennardJonesSoftCoreBeutler(cutoff=pt.DistanceCutoff(RC),
                                        use_neighbors=True),), *a)),
    "two-lj": (False, lambda i, *a: ((LJ, LJ), *a)),
    "no-table": (False, lambda i, at, c, b, nb: (i, at, c, b, None)),
}


def case_inputs(name):
    dtype = torch.float32 if name == "lj-cube-f32" else torch.float64
    box = {"lj-open-axis": "open", "triclinic": "triclinic",
           "grad-box-triclinic": "triclinic"}.get(name, "cube")
    atoms, coords, boundary, nbs = inputs(dtype, box)
    change = CASES[name][1] or (lambda *a: a)
    return change((LJ,), atoms, coords, boundary, nbs)


@pytest.mark.parametrize("name", CASES)
def test_dispatch_rule_reads_the_inputs(name):
    admitted = CASES[name][0]
    inters, atoms, coords, boundary, nbs = case_inputs(name)
    assert tnb.lj_table_admits(inters, atoms, coords, boundary,
                               nbs) is admitted


@pytest.mark.parametrize("needs_virial", (False, True))
@pytest.mark.parametrize("name", ("lj-cube", "lj-weight-special",
                                  "lj-open-axis", "triclinic"))
def test_cpu_call_runs_the_engine_and_launches_nothing(name, needs_virial):
    inters, atoms, coords, boundary, nbs = case_inputs(name)
    before = tnb.TABLE_LAUNCHES
    f, v = tnb.neighbor_forces(inters, atoms, coords, boundary, nbs,
                               needs_virial=needs_virial)
    f0, v0 = tnb.neighbor_forces_plain(inters, atoms, coords, boundary, nbs,
                                       needs_virial=needs_virial)
    assert tnb.TABLE_LAUNCHES == before
    assert torch.equal(f, f0) and torch.equal(v, v0)
    assert bool(f.abs().sum() > 0)
    assert bool(v.abs().sum() > 0) == needs_virial
