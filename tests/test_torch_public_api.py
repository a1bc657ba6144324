"""The public names of mollytpu_torch against the JAX package's, float64
on the CPU: every name mollytpu/__init__.py exports exists in the port
but the TPU-only ``_prec``; AtomData field by field on the
water box (system_from_pdb) and on the GROMACS topology, carried by
System.update; crystal_system, add_position_restraints and
unwrap_molecules as tests/test_setup_utils.py:11-51 checks JAX's; and
the small helpers (distance, sq_distance, random_velocity,
angle_constraint, strictness, report_issue) against JAX's."""

import ast
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.models.gromacs import system_from_gromacs as jax_from_gromacs
from mollytpu.models.setup import system_from_pdb as jax_from_pdb

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from torch_parity import CPU, box_path, np64, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: names of mollytpu/__init__.py that only the TPU build has: the XLA
#: matmul precision switch (PyTorch's float32 matmuls on CUDA are full
#: float32 unless TF32 is turned on)
TPU_ONLY = {"_prec"}
FIELDS = ("atom_name", "residue_name", "residue_number", "chain_id",
          "element", "hetero_atom")


def jax_exports():
    """The names mollytpu/__init__.py binds by ``from ... import`` and by
    assignment (its ``import x as _x`` module aliases aside)."""
    path = os.path.join(os.path.dirname(mt.__file__), "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def test_every_jax_export_exists_in_the_port():
    names = jax_exports()
    assert TPU_ONLY <= names and len(names) > 200
    missing = sorted(n for n in names - TPU_ONLY if not hasattr(pt, n))
    assert missing == []
    assert pt.__version__ == mt.__version__


def assert_atom_data(ours, theirs):
    assert isinstance(ours, pt.AtomData)
    for name in FIELDS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype.kind == b.dtype.kind, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_atom_data_of_the_water_box_matches_jax():
    js = jax_from_pdb(box_path("tiny64"), mt.ForceField(pt.TIP3P_XML),
                      dtype=jnp.float64, build_cache=False)
    ps = port_system("tiny64")
    assert_atom_data(ps.atom_data, js.atom_data)
    assert list(ps.atom_data.atom_name[:3]) == ["O", "H1", "H2"]
    # a field of the System: update and the integrators carry it
    moved = ps.update(coords=ps.coords + 0.01)
    assert moved.atom_data is ps.atom_data
    out, _, _ = pt.simulate(ps.update(neighbor_finder=None,
                                      pairwise_inters=()),
                            pt.VelocityVerlet(dt=0.001), 2)
    assert out.atom_data is ps.atom_data


def test_atom_data_of_the_gromacs_topology_matches_jax(tmp_path):
    gro, top = pt.water_box_gromacs(box_path("tiny64"),
                                    str(tmp_path / "water.gro"),
                                    str(tmp_path / "water.top"))
    js = jax_from_gromacs(gro, top, dtype=jnp.float64)
    ps = pt.system_from_gromacs(gro, top, dtype=torch.float64, device=CPU)
    assert_atom_data(ps.atom_data, js.atom_data)


def test_crystal_system_matches_jax():
    for lattice, cells in (("fcc", 3), ("bcc", (2, 3, 2)), ("sc", 4)):
        js = mt.crystal_system(0.5, 40.0, cells, lattice=lattice,
                               dtype=jnp.float64)
        ps = pt.crystal_system(0.5, 40.0, cells, lattice=lattice,
                               dtype=torch.float64, device=CPU)
        assert ps.n_atoms == js.n_atoms
        np.testing.assert_array_equal(np64(ps.coords), np64(js.coords))
        np.testing.assert_array_equal(np64(ps.boundary.side_lengths),
                                      np64(js.boundary.side_lengths))
        assert float(pt.potential_energy(ps)) == pytest.approx(
            float(jax.jit(mt.potential_energy)(js)), rel=1e-12)
    # fcc's nearest neighbour lies a / sqrt(2) away
    ps = pt.crystal_system(0.5, 40.0, 3, dtype=torch.float64, device=CPU)
    assert ps.n_atoms == 4 * 27
    r = pt.distance(ps.boundary, ps.coords[0][None], ps.coords[1:])
    assert abs(float(r.min()) - 0.5 / np.sqrt(2)) < 1e-12


def test_add_position_restraints_matches_jax():
    boundary = mt.cubic(3.0, dtype=jnp.float64)
    coords = mt.place_atoms(jax.random.PRNGKey(0), boundary, 20,
                            min_dist=0.3, dtype=jnp.float64)
    atoms = mt.make_atoms(n=20, mass=10.0, sigma=0.3, epsilon=0.2,
                          dtype=jnp.float64)
    js = mt.System(atoms=atoms, coords=coords, boundary=boundary,
                   pairwise_inters=(mt.LennardJones(
                       cutoff=mt.DistanceCutoff(1.0)),))
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    rest_j = mt.add_position_restraints(js, 1000.0,
                                        atom_selector=np.arange(5),
                                        dtype=jnp.float64)
    rest = pt.add_position_restraints(ps, 1000.0, atom_selector=np.arange(5))
    assert len(rest.specific_lists) == len(ps.specific_lists) + 1
    shift = np.zeros((20, 3))
    shift[0, 0] = 0.1
    moved_j = rest_j.update(coords=coords + shift)
    moved = rest.update(coords=ps.coords + torch.as_tensor(shift))
    de = float(pt.potential_energy(moved) - pt.potential_energy(
        ps.update(coords=moved.coords)))
    assert abs(de - 0.5 * 1000.0 * 0.01) < 1e-9
    assert float(pt.potential_energy(moved)) == pytest.approx(
        float(jax.jit(mt.potential_energy)(moved_j)), rel=1e-12)


@pytest.mark.parametrize("mod", [mt, pt], ids=["jax", "torch"])
def test_unwrap_molecules(mod):
    x = np.asarray([[1.95, 1.0, 1.0], [0.05, 1.0, 1.0], [0.5, 0.5, 0.5]])
    if mod is pt:
        boundary, coords = pt.cubic(2.0, torch.float64, CPU), \
            torch.as_tensor(x)
    else:
        boundary, coords = mt.cubic(2.0, jnp.float64), jnp.asarray(x)
    un = mod.unwrap_molecules(coords, boundary, None, [0], [1])
    assert abs(np.linalg.norm(un[0] - un[1]) - 0.1) < 1e-9
    ref = mt.unwrap_molecules(jnp.asarray(x), mt.cubic(2.0, jnp.float64),
                              None, [0], [1])
    np.testing.assert_array_equal(un, ref)


def test_small_helpers_match_jax():
    rng = np.random.default_rng(1)
    xi, xj = rng.uniform(0, 3, (7, 3)), rng.uniform(0, 3, (7, 3))
    jb, pb = mt.cubic(2.5, jnp.float64), pt.cubic(2.5, torch.float64, CPU)
    for name in ("distance", "sq_distance"):
        np.testing.assert_allclose(
            np64(getattr(pt, name)(pb, torch.as_tensor(xi),
                                   torch.as_tensor(xj))),
            np64(getattr(mt, name)(jb, jnp.asarray(xi), jnp.asarray(xj))),
            rtol=1e-14)
    np.testing.assert_allclose(
        np64(pt.boundary.displacement_fn(pb)(torch.as_tensor(xi),
                                             torch.as_tensor(xj))),
        np64(mt.boundary.displacement_fn(jb)(jnp.asarray(xi),
                                             jnp.asarray(xj))), rtol=1e-14)
    assert pt.angle_constraint(0, 1, 2, 0.1, 0.1, math.radians(104.52)) == \
        mt.angle_constraint(0, 1, 2, 0.1, 0.1, math.radians(104.52))
    v = torch.stack([pt.random_velocity(
        16.0, 300.0, torch.Generator().manual_seed(s), dtype=torch.float64)
        for s in range(400)])
    assert v.shape == (400, 3)
    sigma = math.sqrt(pt.units.KB * 300.0 / 16.0)
    assert float(v.std()) == pytest.approx(sigma, rel=0.06)
    for level in ("warn", "nowarn", "error"):
        assert pt.strictness(level) == mt.strictness(level)
    with pytest.raises(ValueError):
        pt.report_issue("bad", "error")
    with pytest.warns(UserWarning):
        pt.report_issue("odd", "warn")
