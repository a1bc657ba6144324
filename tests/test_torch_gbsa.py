"""Generalized-Born implicit solvent of mollytpu_torch against the JAX
package (float64): OBC1, OBC2 and GBn2 built by system_from_pdb on an
open cluster of 64 TIP3P waters (nonbonded_method="none"), without and
with a distance cutoff and Debye screening: Born radii, energy and
forces; the mbondi2 / mbondi3 radii on the molecule of
tests/test_torch_bonded_setup.py (hydrogens on nitrogen); the GBn2 neck
tables, byte for byte.

Tolerances: the same dense (N, N) arithmetic in both packages, forces by
autodiff in both: 1e-12 relative for the radii and the energy, 1e-10
relative to the largest force for the forces."""

import base64
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mollytpu.models.forcefield import ForceField as JaxForceField
from mollytpu.models.setup import system_from_pdb as jax_system_from_pdb
from mollytpu.ops import _gbn2_neck as jax_neck
from mollytpu.ops.gbsa import _neck_lookup as jax_neck_lookup

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.ops import _gbn2_neck, gbsa
from test_torch_bonded_setup import build, write_molecule
from torch_parity import CPU, box_path, max_rel, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {"plain": {}, "cutoff": dict(dist_cutoff=1.0),
         "kappa": dict(kappa=0.7)}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The tiny water box's 64 waters as an open cluster (no CRYST1)."""
    with open(box_path("tiny64")) as f:
        lines = [ln for ln in f if not ln.startswith("CRYST1")]
    path = tmp_path_factory.mktemp("gb") / "cluster.pdb"
    path.write_text("".join(lines))
    return str(path)


def _gb(system):
    (gb,) = [g for g in system.general_inters if "ImplicitSolvent" in
             type(g).__name__]
    return gb


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("model", gbsa.MODELS)
def test_born_radii_energy_forces_match_jax(cluster, model, case):
    kw = dict(nonbonded_method="none", implicit_solvent=model,
              implicit_solvent_kwargs=CASES[case])
    js = jax_system_from_pdb(cluster, JaxForceField(pt.TIP3P_XML),
                             dtype=jnp.float64, build_cache=False, **kw)
    ps = pt.system_from_pdb(cluster, pt.ForceField(pt.TIP3P_XML),
                            dtype=torch.float64, device=CPU, **kw)
    jg, pg = _gb(js), _gb(ps)
    assert type(pg).__name__ == type(jg).__name__
    assert pg.dist_cutoff == jg.dist_cutoff and pg.kappa == jg.kappa
    x, b = ps.coords, ps.boundary
    r_j = np64(jax.jit(lambda c: jg.born_radii(c, js.boundary))(js.coords))
    np.testing.assert_allclose(pg.born_radii(x, b).numpy(), r_j, rtol=1e-12)
    e_j = float(jax.jit(lambda c: jg.energy(c, js.boundary, js.atoms))(
        js.coords))
    assert float(pg.energy(x, b, ps.atoms)) == pytest.approx(e_j, rel=1e-12)
    f_j, _ = jax.jit(lambda c: jg.force_virial(c, js.boundary, js.atoms))(
        js.coords)
    f_p, _ = pg.force_virial(x, b, ps.atoms)
    assert max_rel(f_j, f_p) < 1e-10
    # the bridge carries the interaction field for field
    bg = _gb(system_from_arrays(jax.device_get(js), device=CPU))
    assert type(bg) is type(pg)
    f_b, _ = bg.force_virial(x, b, ps.atoms)
    assert max_rel(f_b, f_p) < 1e-12


@pytest.mark.parametrize("model", gbsa.MODELS)
def test_molecule_radii_match_jax(tmp_path, model):
    """The molecule's intrinsic and screened radii (its HN is a hydrogen on
    nitrogen) and GBn2's per-atom parameters."""
    pdb, xml = write_molecule(tmp_path, "amber")
    js, ps = build(pdb, xml, nonbonded_method="none", implicit_solvent=model)
    jg, pg = _gb(js), _gb(ps)
    names = ["offset_radii", "scaled_radii"]
    if model == "gbn2":
        names += ["alphas", "betas", "gammas", "d0", "m0"]
    for name in names:
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np64(getattr(jg, name)), err_msg=name)
    assert len(set(np64(jg.offset_radii).round(6))) >= 3


def test_neck_tables_are_jax_bytes():
    assert _gbn2_neck.BLOB == jax_neck.BLOB
    raw = zlib.decompress(base64.b64decode(_gbn2_neck.BLOB))
    assert len(raw) == 2 * 441 * 8
    radii = np.linspace(0.09, 0.21, 7)
    for ours, theirs in zip(gbsa.neck_lookup(radii),
                            jax_neck_lookup(radii)):
        np.testing.assert_array_equal(ours, theirs)
