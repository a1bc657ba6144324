"""The GROMACS reader of mollytpu_torch against the JAX package's
(float64): a 64-water TIP3P box written by the test as a .gro and a .top
with [ settles ] (waterbox.water_box_gromacs), built by both packages'
system_from_gromacs under "cutoff" and "pme": the parsed coordinates and
box, the atom parameters, exclusions, 1-4 pairs, the settle constraints,
n_dof, the general interactions, the neighbor tables, energy and forces;
the port's GROMACS system against its system_from_pdb of the same water
model on the same coordinates; and a topology of every bonded funct the
reader takes, against JAX's lists and forces.

Tolerances: the same neighbor-table engine in both packages, JAX's
polynomial erfc in both (approximate_pme=True): forces, virial and
energy 1e-10 relative. Against system_from_pdb (the pair kernel's twin):
the reaction field 1e-10; PME 2e-6, the polynomial erfc's error
(tests/test_torch_slice.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.models.gromacs import read_gro as jax_read_gro
from mollytpu.models.gromacs import system_from_gromacs as jax_from_gromacs
from mollytpu.ops.neighbors import find_neighbors as jax_find_neighbors

import mollytpu_torch as pt
from torch_parity import (CPU, LIST_RADIUS, box_path, max_rel, np64,
                          port_neighbors)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(use_settles=True, dist_neighbors=LIST_RADIUS)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gmx")
    return pt.water_box_gromacs(box_path("tiny64"), str(d / "water.gro"),
                                str(d / "water.top"))


@pytest.fixture(scope="module", params=["cutoff", "pme"])
def built(request, files):
    gro, top = files
    method = request.param
    js = jax_from_gromacs(gro, top, nonbonded_method=method,
                          dtype=jnp.float64, **KW)
    ps = pt.system_from_gromacs(gro, top, nonbonded_method=method,
                                dtype=torch.float64, device=CPU, **KW)
    return method, js, ps


def test_read_gro_matches_jax(files):
    ours, theirs = pt.read_gro(files[0]), jax_read_gro(files[0])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x_pdb = pt.models.pdb.read_pdb(box_path("tiny64")).coords
    np.testing.assert_allclose(ours[3], x_pdb, rtol=0, atol=5e-4)


def test_system_arrays_match_jax(built):
    _, js, ps = built
    np.testing.assert_array_equal(np64(ps.coords), np64(js.coords))
    np.testing.assert_array_equal(np64(ps.boundary.side_lengths),
                                  np64(js.boundary.side_lengths))
    for field in ("mass", "charge", "sigma", "epsilon", "atom_type"):
        np.testing.assert_array_equal(np64(getattr(ps.atoms, field)),
                                      np64(getattr(js.atoms, field)),
                                      err_msg=field)
    for field in ("excl_i", "excl_j", "spec_i", "spec_j", "excl_bits",
                  "spec_bits", "far_excl", "far_spec", "excl_table",
                  "spec_table"):
        np.testing.assert_array_equal(
            getattr(ps.exclusions, field).numpy(),
            np.asarray(getattr(js.exclusions, field)), err_msg=field)
    (pc,), (jc,) = ps.constraints, js.constraints
    np.testing.assert_array_equal(pc.idx_i.numpy(), np.asarray(jc.idx_i))
    np.testing.assert_array_equal(pc.idx_j.numpy(), np.asarray(jc.idx_j))
    np.testing.assert_array_equal(np64(pc.dists), np64(jc.dists))
    assert ps.n_dof == js.n_dof == 6 * 64 - 3
    assert [type(g).__name__ for g in ps.general_inters] == [
        type(g).__name__ for g in js.general_inters]
    assert ps.specific_lists == () and len(js.specific_lists) == 0
    assert [type(i).__name__ for i in ps.pairwise_inters] == [
        type(i).__name__ for i in js.pairwise_inters]
    f = ps.neighbor_finder
    assert type(f).__name__ == "CellListNeighborFinder"
    for name in ("dist_cutoff", "grid_dims", "n_steps", "max_neighbors",
                 "cell_capacity"):
        assert getattr(f, name) == getattr(js.neighbor_finder, name), name


def test_energy_and_forces_match_jax(built):
    _, js, ps = built
    nbs = jax_find_neighbors(js.neighbor_finder, js.coords, js.boundary,
                             js.exclusions, 0)
    nb = port_neighbors(ps)
    f_j, v_j = jax.jit(lambda s, n: mt.forces_virial(
        s, n, needs_virial=True))(js, nbs)
    e_j = float(jax.jit(mt.potential_energy)(js, nbs))
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    assert max_rel(f_j, f_p) < 1e-10
    assert max_rel(v_j, v_p) < 1e-10
    assert float(pt.potential_energy(ps, nb)) == pytest.approx(e_j,
                                                               rel=1e-10)


def test_matches_system_from_pdb_on_the_same_coordinates(built):
    method, _, ps = built
    own = pt.system_from_pdb(
        box_path("tiny64"), pt.ForceField(pt.TIP3P_XML),
        nonbonded_method=method, dtype=torch.float64, device=CPU,
        constraints="hbonds", rigid_water=True, dist_neighbors=LIST_RADIUS)
    own = own.update(coords=ps.coords)
    f_pdb, _ = pt.forces_virial(own, port_neighbors(own))
    f_gmx, _ = pt.forces_virial(ps, port_neighbors(ps))
    assert max_rel(f_pdb, f_gmx) < (1e-10 if method == "cutoff" else 2e-6)
    assert ps.n_dof == own.n_dof


MOL_TOP = """[ defaults ]
1  2  yes  0.5  0.8333

[ atomtypes ]
CT  6  12.011  0.0  A  0.339967  0.457730
CA  6  12.011  0.0  A  0.339967  0.359824
OS  8  15.999  0.0  A  0.300001  0.711280

[ bondtypes ]
CT  CT  1  0.1526  259408.0
CT  OS  1  0.1410  267776.0

[ angletypes ]
CT  CT  OS  1  109.50  418.40

[ dihedraltypes ]
CT  CT  CT  OS  9  0.0  0.65084  3
CT  CT  CT  OS  9  180.0  1.2  2
X   CT  OS  X   9  0.0  1.60247  3

[ moleculetype ]
MOL  3

[ atoms ]
1  CT  1  MOL  C1  1  -0.10  12.011
2  CT  1  MOL  C2  1   0.05
3  CA  1  MOL  C3  1   0.20  12.011
4  CT  1  MOL  C4  1   0.15  12.011
5  OS  1  MOL  O5  1  -0.30  15.999

[ bonds ]
1  2  1
2  3  1  0.1510  265000.0
3  4  1  0.1500  260000.0
4  5  1

[ pairs ]
1  4  1
2  5  1

[ angles ]
1  2  3  1  111.0  400.0
2  3  4  5  112.0  420.0  0.2500  20000.0
3  4  5  1  108.0  460.0

[ dihedrals ]
1  2  3  4  9  0.0  1.5  3
1  2  4  5  9
2  3  4  5  3  1.0  -0.5  0.3  0.2  0.0  0.0
1  3  2  4  2  10.0  40.0
1  2  3  5  4  180.0  4.6  2

[ system ]
two molecules

[ molecules ]
MOL  2
"""


def _mol_gro(path):
    rng = np.random.default_rng(4)
    lines = ["two molecules", "   10"]
    for m in range(2):
        x = np.array([1.0 + m, 1.0, 1.0])
        for a, name in enumerate(("C1", "C2", "C3", "C4", "O5")):
            v = rng.normal(size=3)
            x = x + 0.15 * v / np.linalg.norm(v)
            lines.append("%5d%-5s%5s%5d%8.3f%8.3f%8.3f" % (
                m + 1, "MOL", name, 5 * m + a + 1, *x))
    lines.append("   3.00000   3.00000   3.00000")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_bonded_topology_matches_jax(tmp_path):
    """A molecule with every bonded funct the reader takes (bonds by type
    and inline, harmonic and Urey-Bradley angles, periodic torsions by
    type with several terms, RB, harmonic and periodic impropers, [ pairs
    ]): the same lists, exclusions and forces as the JAX package's."""
    gro = _mol_gro(tmp_path / "mol.gro")
    top = tmp_path / "mol.top"
    top.write_text(MOL_TOP)
    kw = dict(nonbonded_method="cutoff", dist_neighbors=LIST_RADIUS)
    js = jax_from_gromacs(gro, str(top), dtype=jnp.float64, **kw)
    ps = pt.system_from_gromacs(gro, str(top), dtype=torch.float64,
                                device=CPU, **kw)
    assert [(s.kind, s.n_terms) for s in ps.specific_lists] == [
        (s.kind, int(s.n_terms)) for s in js.specific_lists] == [
        ("harmonic_bond", 8), ("harmonic_angle", 4), ("urey_bradley", 2),
        ("periodic_torsion", 8), ("rb_torsion", 2), ("harmonic_torsion", 2)]
    for jl, pl in zip(js.specific_lists, ps.specific_lists):
        np.testing.assert_array_equal(pl.atom_idx.numpy(),
                                      np.asarray(jl.atom_idx))
        for name, value in pl.params.items():
            np.testing.assert_array_equal(value.numpy(),
                                          np64(jl.params[name]),
                                          err_msg=f"{pl.kind} {name}")
    for field in ("excl_i", "excl_j", "spec_i", "spec_j"):
        np.testing.assert_array_equal(
            getattr(ps.exclusions, field).numpy(),
            np.asarray(getattr(js.exclusions, field)), err_msg=field)
    nbs = jax_find_neighbors(js.neighbor_finder, js.coords, js.boundary,
                             js.exclusions, 0)
    f_j, _ = jax.jit(lambda s, n: mt.forces_virial(s, n))(js, nbs)
    f_p, _ = pt.forces_virial(ps, port_neighbors(ps))
    assert max_rel(f_j, f_p) < 1e-10
