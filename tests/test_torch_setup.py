"""mollytpu_torch.models.setup.system_from_pdb against the JAX package's
system_from_pdb on the same PDB and the in-repo TIP3P XML. Setup is host
numpy in both packages, so everything must match exactly (integers) or to
1e-12 (floats: the same float64 arithmetic in the same order)."""

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.bridge import pairs_from_bitmap
from mollytpu_torch.ops.ewald import pme_mesh_dims
from torch_parity import (CPU, PME_BOXES, box_path, jax_system, np64,
                          port_system)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12


@pytest.fixture(params=PME_BOXES)
def systems(request):
    return jax_system(request.param), port_system(request.param)


@pytest.fixture(params=["tiny64", "dodeca64"])
def rf_systems(request):
    """The reaction-field ("cutoff") systems, orthorhombic and triclinic."""
    return (jax_system(request.param, "cutoff"),
            port_system(request.param, "cutoff"))


def test_waterbox_reproduces_bench_tiny_box(tmp_path):
    """water_box_pdb(64, spacing=6.5) is bench._tiny_waterbox_pdb's box."""
    import bench
    ours = pt.water_box_pdb(str(tmp_path / "w.pdb"), 64, spacing=6.5)
    with open(ours) as a, open(bench._tiny_waterbox_pdb()) as b:
        assert a.read() == b.read()


def test_liquid_box_geometry():
    path = box_path("liquid512")
    with open(path) as f:
        lines = f.read().splitlines()
    side = float(lines[0][6:15]) / 10.0
    # CRYST1 keeps 0.001 A of a ~25 A side: 1.2e-4 relative in the volume
    assert side ** 3 * pt.models.waterbox.WATER_DENSITY == pytest.approx(
        512, rel=5e-4)
    assert sum(ln.startswith("HETATM") for ln in lines) == 3 * 512


def test_atom_parameters_match(systems):
    js, ps = systems
    for field in ("mass", "charge", "sigma", "epsilon"):
        np.testing.assert_allclose(np64(getattr(ps.atoms, field)),
                                   np64(getattr(js.atoms, field)),
                                   rtol=0, atol=TOL, err_msg=field)
    np.testing.assert_array_equal(ps.atoms.atom_type.numpy(),
                                  np.asarray(js.atoms.atom_type))
    np.testing.assert_allclose(np64(ps.coords), np64(js.coords), atol=TOL)
    np.testing.assert_allclose(np64(ps.boundary.side_lengths),
                               np64(js.boundary.side_lengths), atol=TOL)
    assert ps.n_dof == js.n_dof


def test_exclusion_tables_match(systems):
    js, ps = systems
    for field in ("excl_i", "excl_j", "spec_i", "spec_j", "excl_table",
                  "spec_table", "excl_bits", "spec_bits", "far_excl",
                  "far_spec"):
        np.testing.assert_array_equal(
            getattr(ps.exclusions, field).numpy(),
            np.asarray(getattr(js.exclusions, field)), err_msg=field)


def test_constraints_match(systems):
    js, ps = systems
    (jc,), (pc,) = js.constraints, ps.constraints
    np.testing.assert_array_equal(pc.idx_i.numpy(), np.asarray(jc.idx_i))
    np.testing.assert_array_equal(pc.idx_j.numpy(), np.asarray(jc.idx_j))
    np.testing.assert_allclose(np64(pc.dists), np64(jc.dists), atol=TOL)
    assert [b.pattern for b in pc.clusters] == [b.pattern
                                               for b in jc.clusters]
    for pb, jb in zip(pc.clusters, jc.clusters):
        np.testing.assert_array_equal(pb.atoms.numpy(), np.asarray(jb.atoms))
        np.testing.assert_allclose(np64(pb.dists), np64(jb.dists), atol=TOL)
    # water bonds and angles all became constraints in both packages, and
    # both keep the emptied lists
    assert [s.n_terms for s in js.specific_lists] == [0, 0]
    assert [(s.kind, s.n_terms) for s in ps.specific_lists] == [
        (s.kind, 0) for s in js.specific_lists]


def test_pme_and_corrections_match(systems):
    js, ps = systems
    jpme, jexcl, jdisp = js.general_inters
    ppme, pexcl, pdisp = ps.general_inters
    assert type(ppme).__name__ == "PME"
    assert ppme.mesh_dims == jpme.mesh_dims
    assert ppme.alpha == pytest.approx(jpme.alpha, rel=TOL)
    for ax in "xyz":
        np.testing.assert_allclose(np64(getattr(ppme, "moduli_" + ax)),
                                   np64(getattr(jpme, "moduli_" + ax)),
                                   atol=TOL)
    # the JAX correction stores a union bitmap; the port a sparse pair list
    np.testing.assert_array_equal(
        np.stack([pexcl.pair_i.numpy(), pexcl.pair_j.numpy()], axis=1),
        pairs_from_bitmap(np.asarray(jexcl.bits), np.asarray(jexcl.far)))
    assert pexcl.alpha == pytest.approx(jexcl.alpha, rel=TOL)
    assert pdisp.factor_6 == pytest.approx(jdisp.factor_6, rel=TOL)
    assert pdisp.factor_12 == pytest.approx(jdisp.factor_12, rel=TOL)


@pytest.mark.parametrize("method", ["pme", "cutoff"])
@pytest.mark.parametrize("box", PME_BOXES)
def test_pairwise_parameters_match(box, method):
    js, ps = jax_system(box, method), port_system(box, method)
    (jlj, jco), (plj, pco) = js.pairwise_inters, ps.pairwise_inters
    assert type(plj.cutoff).__name__ == type(jlj.cutoff).__name__
    assert plj.cutoff.dist_cutoff == jlj.cutoff.dist_cutoff
    assert plj.weight_special == jlj.weight_special
    assert type(pco).__name__ == type(jco).__name__
    assert pco.weight_special == jco.weight_special
    assert pco.coulomb_const == jco.coulomb_const
    if method == "pme":
        assert pco.alpha == pytest.approx(jco.alpha, rel=TOL)
    else:
        from mollytpu.ops.pairwise import _rf_constants
        assert pco.dist_cutoff == jco.dist_cutoff
        assert pco.solvent_dielectric == jco.solvent_dielectric == 78.3
        krf, crf = _rf_constants(jco.dist_cutoff, jco.solvent_dielectric)
        assert pco.krf == pytest.approx(krf, rel=TOL)
        assert pco.crf == pytest.approx(crf, rel=TOL)


def test_rf_system_matches_jax(rf_systems):
    """The "cutoff" system: box (a Triclinic one from a triclinic CRYST1),
    atoms, exclusions and the dispersion correction as the only general
    interaction, against JAX's system_from_pdb(nonbonded_method="cutoff")."""
    js, ps = rf_systems
    assert type(ps.boundary).__name__ == type(js.boundary).__name__
    np.testing.assert_allclose(np64(ps.boundary.box_matrix()),
                               np64(js.boundary.box_matrix()), atol=TOL)
    np.testing.assert_allclose(np64(ps.coords), np64(js.coords), atol=TOL)
    for field in ("mass", "charge", "sigma", "epsilon"):
        np.testing.assert_allclose(np64(getattr(ps.atoms, field)),
                                   np64(getattr(js.atoms, field)), atol=TOL)
    for field in ("excl_i", "excl_j", "spec_i", "spec_j", "excl_bits",
                  "spec_bits", "far_excl", "far_spec"):
        np.testing.assert_array_equal(
            getattr(ps.exclusions, field).numpy(),
            np.asarray(getattr(js.exclusions, field)), err_msg=field)
    (jdisp,), (pdisp,) = js.general_inters, ps.general_inters
    assert type(pdisp).__name__ == type(jdisp).__name__
    assert pdisp.factor_6 == pytest.approx(jdisp.factor_6, rel=TOL)
    assert pdisp.factor_12 == pytest.approx(jdisp.factor_12, rel=TOL)
    assert float(ps.boundary.volume()) == pytest.approx(
        float(js.boundary.volume()), rel=TOL)
    assert ps.n_dof == js.n_dof


def test_triclinic_pme_raises(tmp_path):
    """PME in a triclinic box builds (its mesh sized from the basis
    diagonal, as the JAX package sizes it); PME still raises where the PDB
    gives no periodic box."""
    ps = pt.system_from_pdb(box_path("dodeca64"), pt.ForceField(pt.TIP3P_XML),
                            nonbonded_method="pme", device=CPU,
                            constraints="hbonds", rigid_water=True)
    pme = ps.general_inters[0]
    assert isinstance(ps.boundary, pt.Triclinic) and isinstance(pme, pt.PME)
    assert pme.mesh_dims == pme_mesh_dims(
        torch.diagonal(ps.boundary.basis).numpy(), pme.alpha, pme.error_tol)
    with open(box_path("dodeca64")) as f:
        lines = [ln for ln in f if not ln.startswith("CRYST1")]
    open_box = tmp_path / "open.pdb"
    open_box.write_text("".join(lines))
    with pytest.raises(NotImplementedError, match="PME needs a periodic"):
        pt.system_from_pdb(str(open_box), pt.ForceField(pt.TIP3P_XML),
                           nonbonded_method="pme", device=CPU,
                           constraints="hbonds", rigid_water=True)


@pytest.mark.parametrize("kwargs, what", [
    (dict(constraints="allbond"), "constraints="),
    (dict(implicit_solvent="obc3"), "implicit solvent"),
    (dict(constraints="angles"), "constraints="),
])
def test_unported_options_raise(kwargs, what):
    """"allbonds", "hangles" and implicit solvent are ported
    (tests/test_torch_constraints_global.py, tests/test_torch_gbsa.py);
    names that are no option raise, naming the argument."""
    args = dict(rigid_water=True, constraints="hbonds")
    args.update(kwargs)
    with pytest.raises(ValueError, match=what):
        pt.system_from_pdb(box_path("tiny64"), pt.ForceField(pt.TIP3P_XML),
                           device=CPU, **args)
