"""CMAP torsions of mollytpu_torch against the JAX package (float64): the
bicubic coefficients of the grids of tests/test_cmap.py; energy and
forces of CMAP lists over random five-atom chains on two maps (the JAX
package differentiates its term by autodiff, the port writes the
gradient out), with every dihedral pair's cell and the cells at -pi and
+pi; a central finite-difference check of the port's forces; and a CMAP
force field through system_from_pdb in both packages.

Tolerances: the coefficients are the same numpy code (exact); energies
1e-12 relative; forces 1e-10 kJ/mol/nm (autodiff against the written-out
chain rule, rounding only); finite differences at h = 1e-6 nm, 1e-6
kJ/mol/nm (truncation ~h^2, rounding ~1e-16 / h of ~10 kJ/mol)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.bonded import specific_energy as jax_energy
from mollytpu.ops.bonded import specific_forces as jax_forces
from mollytpu.ops.cmap import cmap_coefficients as jax_coefficients
from mollytpu.ops.cmap import make_cmap_list as jax_cmap_list

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from test_cmap import chain_coords
from test_torch_bonded_setup import assert_same_lists, build, write_molecule
from torch_parity import CPU, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_GRID = 24


def _grids():
    """The smooth surface of tests/test_cmap.py and a random grid."""
    ph = np.linspace(-np.pi, np.pi, N_GRID, endpoint=False)
    PH, PS = np.meshgrid(ph, ph, indexing="ij")
    smooth = 3.0 * np.cos(PH) * np.sin(PS) + 1.5 * np.cos(2 * PS)
    return smooth, np.random.default_rng(2).normal(size=(N_GRID, N_GRID))


def _chains(k=60):
    """chain_coords plus k random five-atom chains in a 6 nm box."""
    rng = np.random.default_rng(3)
    chains = [chain_coords()]
    for _ in range(k):
        x = [rng.uniform(0.5, 5.5, 3)]
        for _ in range(4):
            v = rng.normal(size=3)
            x.append(x[-1] + 0.15 * v / np.linalg.norm(v))
        chains.append(np.asarray(x))
    coords = np.concatenate(chains)
    idx = np.arange(len(coords)).reshape(-1, 5)
    return coords, idx, rng.integers(0, 2, len(idx))


@pytest.mark.parametrize("grid", [12, N_GRID])
def test_coefficients_match_jax(grid):
    g = np.random.default_rng(grid).normal(size=(grid, grid))
    np.testing.assert_array_equal(pt.cmap_coefficients(g),
                                  jax_coefficients(g))


@pytest.fixture(scope="module")
def lists():
    table = np.stack([pt.cmap_coefficients(g) for g in _grids()])
    coords, idx, maps = _chains()
    jl = jax_cmap_list(*idx.T, maps, jnp.asarray(table), N_GRID)
    pl = pt.make_cmap_list(*idx.T, maps, table, N_GRID, dtype=torch.float64,
                           device=CPU)
    return coords, jl, pl


def test_energy_and_forces_match_jax(lists):
    coords, jl, pl = lists
    jb = mt.cubic(6.0, dtype=jnp.float64)
    pb = pt.cubic(6.0, dtype=torch.float64, device=CPU)
    x = torch.as_tensor(coords)
    e_j = float(jax_energy(jl, jnp.asarray(coords), jb))
    f_j, v_j = jax.jit(lambda c: jax_forces(jl, c, jb, needs_virial=True))(
        jnp.asarray(coords))
    e_p = float(pt.specific_energy(pl, x, pb))
    f_p, v_p = pt.specific_forces(pl, x, pb, needs_virial=True)
    assert e_p == pytest.approx(e_j, rel=1e-12)
    np.testing.assert_allclose(f_p.numpy(), np64(f_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(v_p.numpy(), np64(v_j), rtol=0, atol=1e-10)
    # a chain whose dihedrals sit at the grid's edges, phi = pi
    # (the clipped last cell, t = 1) and psi = -pi
    edge = np.array([[0.0, 0.1, 0.0], [0.0, 0.0, 0.0], [0.15, 0.0, 0.0],
                     [0.15, -0.1, 0.0], [0.3, -0.1, 0.0]]) + 1.0
    for c in (edge, edge + np.array([0.0, 0.0, 1e-9])):
        f_j, _ = jax_forces(jl, jnp.asarray(np.concatenate(
            [c, coords[5:]])), jb)
        f_p, _ = pt.specific_forces(pl, torch.as_tensor(np.concatenate(
            [c, coords[5:]])), pb)
        np.testing.assert_allclose(f_p.numpy()[:5], np64(f_j)[:5], rtol=0,
                                   atol=1e-10)


def test_forces_match_finite_differences(lists):
    coords, _, pl = lists
    pb = pt.cubic(6.0, dtype=torch.float64, device=CPU)
    x = torch.as_tensor(coords)
    f, _ = pt.specific_forces(pl, x, pb)
    h = 1e-6
    for a in range(0, 50, 7):
        for d in range(3):
            xp, xm = x.clone(), x.clone()
            xp[a, d] += h
            xm[a, d] -= h
            fd = -(float(pt.specific_energy(pl, xp, pb))
                   - float(pt.specific_energy(pl, xm, pb))) / (2 * h)
            assert float(f[a, d]) == pytest.approx(fd, abs=1e-6)


CMAP_XML = """ <CMAPTorsionForce>
  <Map>{values}</Map>
  <Torsion map="0" class1="HC" class2="CT" class3="N" class4="C" class5="O"/>
  <Torsion map="0" class1="CT" class2="N" class3="C" class4="CB" class5="HC"/>
 </CMAPTorsionForce>
</ForceField>"""


def test_cmap_force_field_builds_as_jax(tmp_path):
    """A CMAP force field through system_from_pdb: the same lists (the
    CMAP list last) and energy in both packages."""
    pdb, xml = write_molecule(tmp_path, "amber")
    values = " ".join(f"{v:.6f}" for v in _grids()[1].reshape(-1))
    text = open(xml).read().replace("</ForceField>",
                                    CMAP_XML.format(values=values))
    open(xml, "w").write(text)
    js, ps = build(pdb, xml, nonbonded_method="none")
    assert ps.specific_lists[-1].kind == f"cmap_torsion_{N_GRID}"
    # 3 HA-CA-N-C-O chains and 3 CA-N-C-CB-HB chains per molecule, 3
    # molecules
    assert ps.specific_lists[-1].n_terms == 18
    assert_same_lists(js, ps)
    f_j = np64(jax.jit(mt.forces)(js.update(pairwise_inters=(),
                                            general_inters=())))
    f_p = pt.forces(ps.update(pairwise_inters=(), general_inters=()))
    np.testing.assert_allclose(f_p.numpy(), f_j, rtol=0, atol=1e-9)


def test_bridge_carries_cmap(tmp_path):
    """The bridge rebuilds a JAX system's CMAP list from the coefficient
    table it is given (JAX keeps the table in its term function)."""
    pdb, xml = write_molecule(tmp_path, "amber")
    values = " ".join(f"{v:.6f}" for v in _grids()[0].reshape(-1))
    text = open(xml).read().replace("</ForceField>",
                                    CMAP_XML.format(values=values))
    open(xml, "w").write(text)
    js, ps = build(pdb, xml, nonbonded_method="none")
    kind = f"cmap_torsion_{N_GRID}"
    table = pt.cmap_coefficients(_grids()[0])[None]
    with pytest.raises(ValueError, match="cmap_tables"):
        system_from_arrays(jax.device_get(js), device=CPU)
    bridged = system_from_arrays(jax.device_get(js), device=CPU,
                                 cmap_tables={kind: table})
    assert bridged.specific_lists[-1].kind == kind
    f_b = pt.forces(bridged.update(pairwise_inters=(), general_inters=()))
    f_p = pt.forces(ps.update(pairwise_inters=(), general_inters=()))
    np.testing.assert_allclose(f_b.numpy(), f_p.numpy(), rtol=0, atol=1e-12)
