"""The bonded setup of mollytpu_torch.models.setup against the JAX package's
system_from_pdb(..., build_cache=False) (float64, CPU): a small molecule
whose PDB and force field the test writes (bonds, angles with a
Urey-Bradley term, proper torsions with several Fourier terms and a
wildcard, impropers in each of OpenMM's atom orderings, an RB torsion and
an RB improper), the water box with flexible angles and with rigid water,
hydrogen mass repartitioning, and add_position_restraints. Compared: the
lists' kinds, order and row counts (empty lists included), indices and
parameters exactly, the masses, n_dof, and the bonded energy to 1e-12
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.models.forcefield import ForceField as JaxForceField
from mollytpu.models.setup import add_position_restraints as jax_restrain
from mollytpu.models.setup import system_from_pdb as jax_system_from_pdb
from mollytpu.ops.bonded import specific_energy as jax_specific_energy

import mollytpu_torch as pt
from torch_parity import CPU, box_path, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MOL_XML = """<ForceField>
 <AtomTypes>
  <Type name="tCA" class="CT" element="C" mass="12.01"/>
  <Type name="tN" class="N" element="N" mass="14.01"/>
  <Type name="tHN" class="H" element="H" mass="1.008"/>
  <Type name="tC" class="C" element="C" mass="12.01"/>
  <Type name="tO" class="O" element="O" mass="16.00"/>
  <Type name="tCB" class="CB" element="C" mass="12.01"/>
  <Type name="tH" class="HC" element="H" mass="1.008"/>
 </AtomTypes>
 <Residues>
  <Residue name="LIG">
   <Atom name="CA" type="tCA" charge="-0.1"/>
   <Atom name="N" type="tN" charge="-0.4"/>
   <Atom name="HN" type="tHN" charge="0.3"/>
   <Atom name="C" type="tC" charge="0.5"/>
   <Atom name="O" type="tO" charge="-0.5"/>
   <Atom name="CB" type="tCB" charge="-0.1"/>
   <Atom name="HA1" type="tH" charge="0.05"/>
   <Atom name="HA2" type="tH" charge="0.05"/>
   <Atom name="HA3" type="tH" charge="0.0"/>
   <Atom name="HB1" type="tH" charge="0.1"/>
   <Atom name="HB2" type="tH" charge="0.05"/>
   <Atom name="HB3" type="tH" charge="0.05"/>
   <Bond atomName1="CA" atomName2="N"/>
   <Bond atomName1="N" atomName2="HN"/>
   <Bond atomName1="N" atomName2="C"/>
   <Bond atomName1="C" atomName2="O"/>
   <Bond atomName1="C" atomName2="CB"/>
   <Bond atomName1="CA" atomName2="HA1"/>
   <Bond atomName1="CA" atomName2="HA2"/>
   <Bond atomName1="CA" atomName2="HA3"/>
   <Bond atomName1="CB" atomName2="HB1"/>
   <Bond atomName1="CB" atomName2="HB2"/>
   <Bond atomName1="CB" atomName2="HB3"/>
  </Residue>
 </Residues>
 <HarmonicBondForce>
  <Bond class1="CT" class2="N" length="0.145" k="282000"/>
  <Bond class1="N" class2="H" length="0.101" k="363000"/>
  <Bond class1="N" class2="C" length="0.134" k="410000"/>
  <Bond class1="C" class2="O" length="0.123" k="476000"/>
  <Bond class1="C" class2="CB" length="0.152" k="265000"/>
  <Bond class1="CT" class2="HC" length="0.109" k="284000"/>
  <Bond class1="CB" class2="HC" length="0.109" k="284000"/>
 </HarmonicBondForce>
 <HarmonicAngleForce>
  <Angle class1="HC" class2="CT" class3="HC" angle="1.91" k="276" kub="5000" d="0.18"/>
  <Angle class1="HC" class2="CT" class3="N" angle="1.91" k="418"/>
  <Angle class1="CT" class2="N" class3="H" angle="2.06" k="418"/>
  <Angle class1="CT" class2="N" class3="C" angle="2.12" k="418"/>
  <Angle class1="H" class2="N" class3="C" angle="2.09" k="418"/>
  <Angle class1="N" class2="C" class3="O" angle="2.14" k="669"/>
  <Angle class1="N" class2="C" class3="CB" angle="2.03" k="585"/>
  <Angle class1="O" class2="C" class3="CB" angle="2.10" k="669"/>
  <Angle class1="C" class2="CB" class3="HC" angle="1.91" k="418"/>
  <Angle class1="HC" class2="CB" class3="HC" angle="1.88" k="276" kub="4000" d="0.178"/>
 </HarmonicAngleForce>
 <PeriodicTorsionForce ordering="ORDERING">
  <Proper class1="HC" class2="CT" class3="N" class4="C" periodicity1="3" phase1="0.0" k1="0.5" periodicity2="1" phase2="3.14159" k2="0.2" periodicity3="2" phase3="0.0" k3="0.0"/>
  <Proper class1="" class2="N" class3="C" class4="" periodicity1="2" phase1="3.14159" k1="10.5"/>
  <Proper class1="HC" class2="CB" class3="C" class4="N" periodicity1="3" phase1="0.0" k1="0.3"/>
  <Improper class1="N" class2="CT" class3="C" class4="H" periodicity1="2" phase1="3.14159" k1="4.6"/>
  <Improper class1="C" class2="" class3="" class4="O" periodicity1="2" phase1="3.14159" k1="43.9"/>
 </PeriodicTorsionForce>
 <RBTorsionForce>
  <Proper class1="HC" class2="CB" class3="C" class4="O" c0="0.6" c1="1.8" c2="0.0" c3="-2.4" c4="0.0" c5="0.0"/>
  <Improper class1="CB" class2="C" class3="HC" class4="HC" c0="1.0" c1="-0.5" c2="0.3" c3="0.0" c4="0.2" c5="-0.1"/>
 </RBTorsionForce>
 <NonbondedForce coulomb14scale="0.833333" lj14scale="0.5">
  <Atom type="tCA" sigma="0.34" epsilon="0.45"/>
  <Atom type="tN" sigma="0.325" epsilon="0.71"/>
  <Atom type="tHN" sigma="0.107" epsilon="0.066"/>
  <Atom type="tC" sigma="0.34" epsilon="0.36"/>
  <Atom type="tO" sigma="0.296" epsilon="0.88"/>
  <Atom type="tCB" sigma="0.34" epsilon="0.46"/>
  <Atom type="tH" sigma="0.265" epsilon="0.066"/>
 </NonbondedForce>
</ForceField>
"""
NAMES = ("CA", "N", "HN", "C", "O", "CB", "HA1", "HA2", "HA3", "HB1", "HB2",
         "HB3")
N_MOLECULES = 3


def write_molecule(tmp_path, ordering):
    """(PDB path, XML path): N_MOLECULES copies of the molecule at random
    non-overlapping positions, 1.2 nm apart, in a 3.6 nm box."""
    rng = np.random.default_rng(0)
    lines = ["CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1"
             % (36.0, 36.0, 36.0, 90.0, 90.0, 90.0)]
    serial = 1
    for res in range(N_MOLECULES):
        pos = []
        while len(pos) < len(NAMES):
            p = rng.uniform(0.0, 3.0, 3)
            if all(np.linalg.norm(p - q) > 1.0 for q in pos):
                pos.append(p)
        for name, p in zip(NAMES, pos):
            x, y, z = p + np.array([12.0 * res + 2.0, 16.0, 16.0])
            lines.append("HETATM%5d %4s %-4sA%4d    %8.3f%8.3f%8.3f"
                         "  1.00  0.00          %2s" % (
                             serial, (" " + name).ljust(4)[:4], "LIG",
                             res + 1, x, y, z, name[0]))
            serial += 1
    lines.append("END")
    pdb = tmp_path / "mol.pdb"
    pdb.write_text("\n".join(lines) + "\n")
    xml = tmp_path / f"mol-{ordering}.xml"
    xml.write_text(MOL_XML.replace("ORDERING", ordering))
    return str(pdb), str(xml)


def build(pdb, xml, **kw):
    """(JAX system, port system) of the same file and options, float64."""
    js = jax_system_from_pdb(pdb, JaxForceField(xml), dtype=jnp.float64,
                             build_cache=False, **kw)
    ps = pt.system_from_pdb(pdb, pt.ForceField(xml), dtype=torch.float64,
                            device=CPU, **kw)
    return js, ps


def assert_same_lists(js, ps):
    """Kinds, order, row counts, indices and parameters, and the energy."""
    assert [(s.kind, s.n_terms) for s in ps.specific_lists] == [
        (s.kind, int(s.n_terms)) for s in js.specific_lists]
    x = jnp.asarray(js.coords)
    for jl, pl in zip(js.specific_lists, ps.specific_lists):
        np.testing.assert_array_equal(pl.atom_idx.numpy(),
                                      np.asarray(jl.atom_idx))
        assert sorted(pl.params) == sorted(jl.params)
        for k, v in jl.params.items():
            np.testing.assert_array_equal(np64(pl.params[k]), np64(v))
        if pl.n_terms:
            e_j = float(jax.jit(jax_specific_energy)(jl, x, js.boundary))
            e_p = float(pt.specific_energy(pl, ps.coords, ps.boundary))
            assert e_p == pytest.approx(e_j, rel=1e-12, abs=1e-12)
    np.testing.assert_array_equal(np64(ps.masses), np64(js.atoms.mass))
    assert ps.n_dof == js.n_dof


@pytest.mark.parametrize("ordering, constraints, hmass", [
    ("default", "none", None), ("amber", "hbonds", 1.5),
    ("charmm", "none", 3.0)])
def test_molecule_lists_match_jax(tmp_path, ordering, constraints, hmass):
    pdb, xml = write_molecule(tmp_path, ordering)
    js, ps = build(pdb, xml, nonbonded_method="cutoff",
                   constraints=constraints, hydrogen_mass=hmass)
    kinds = [s.kind for s in ps.specific_lists]
    assert kinds == ["harmonic_bond", "harmonic_angle", "periodic_torsion",
                     "periodic_torsion", "urey_bradley", "rb_torsion",
                     "rb_torsion"]
    assert_same_lists(js, ps)
    # the forces of the whole system evaluate (pair kernel twin included)
    f, _ = pt.forces_virial(ps, ps.neighbor_finder.find(
        ps.coords, ps.boundary, ps.exclusions))
    assert torch.isfinite(f).all()


@pytest.mark.parametrize("rigid", [False, True])
def test_water_box_lists_match_jax(rigid):
    """The flexible-angle box keeps its 64 H-O-H angles (the O-H bonds
    become constraints); under rigid water both lists stay, empty."""
    js, ps = build(box_path("tiny64"), pt.TIP3P_XML, nonbonded_method="pme",
                   constraints="hbonds", rigid_water=rigid,
                   hydrogen_mass=None if rigid else 2.0)
    assert [s.n_terms for s in ps.specific_lists] == [0, 0 if rigid else 64]
    assert ps.constraints[0].n_constraints == (192 if rigid else 128)
    assert_same_lists(js, ps)


@pytest.mark.parametrize("selector, k", [
    (None, 500.0), ("mask", 1000.0), ("index", "per-atom"),
    ("predicate", 250.0)])
def test_position_restraints_match_jax(selector, k):
    js, ps = build(box_path("tiny64"), pt.TIP3P_XML, nonbonded_method="pme",
                   constraints="hbonds", rigid_water=True)
    n = ps.n_atoms
    sel = {None: None, "mask": torch.arange(n) % 3 == 0,
           "index": np.array([5, 0, 17, 100]),
           "predicate": lambda i: i % 7 == 2}[selector]
    if k == "per-atom":
        k = np.linspace(100.0, 900.0, n)
    js = jax_restrain(js, k, np.asarray(sel) if selector == "mask" else sel,
                      dtype=jnp.float64)
    ps = pt.add_position_restraints(ps, k, sel)
    assert ps.specific_lists[-1].kind == "position_restraint"
    assert_same_lists(js, ps)
    # at the restraint positions the restraint exerts no force; moved, it
    # matches the JAX package's
    moved = js.coords + 0.01
    f_j, _ = jax.jit(lambda s, c: mt.all_specific_forces(
        s.specific_lists, c, s.boundary))(js, moved)
    f_p, v_p = pt.all_specific_forces(ps.specific_lists,
                                      torch.as_tensor(np64(moved)),
                                      ps.boundary, needs_virial=True)
    np.testing.assert_allclose(f_p.numpy(), np64(f_j), atol=1e-10)
    assert not v_p.any()


def test_cmap_still_raises(tmp_path):
    """CMAP is ported (tests/test_torch_cmap.py); a map that is not a
    square grid still raises, naming CMAP (the JAX package fails to
    reshape it)."""
    pdb, xml = write_molecule(tmp_path, "default")
    text = open(xml).read().replace("</ForceField>", """ <CMAPTorsionForce>
  <Map>0 0 0 0 0</Map>
  <Torsion map="0" class1="HC" class2="CT" class3="N" class4="C" class5="CB"/>
 </CMAPTorsionForce>
</ForceField>""")
    open(xml, "w").write(text)
    with pytest.raises(ValueError, match="CMAP"):
        pt.system_from_pdb(pdb, pt.ForceField(xml), device=CPU)
    with pytest.raises(ValueError):
        jax_system_from_pdb(pdb, JaxForceField(xml), build_cache=False)
