"""mollytpu_torch.boundary's Triclinic box against mollytpu.boundary's, the
pair kernel's back-substitution minimum image against 27 images, the
triclinic CRYST1 record against the JAX reader, and the rhombic
dodecahedron water box.

Tolerances, float64: 1e-12 absolute for the box maths (the same formulas;
the JAX package inverts the basis in its own order); minimum images are
compared exactly up to 1e-12 nm of rounding."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.models.pdb import read_pdb as jax_read_pdb
from mollytpu.ops.blockpairs import boundary_perp_widths, kernel_mic_row

import mollytpu_torch as pt
from mollytpu_torch.boundary import mic_displacement
from mollytpu_torch.models.pdb import read_pdb
from torch_parity import CPU, LIST_RADIUS, box_path, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12

#: the triclinic boxes the port's tests and chip_smoke.py use: edges (nm)
#: and angles (degrees)
BOXES = {"skewed": (2.6, (92.0, 95.0, 88.0)),
         "dodeca_small": (3.4, pt.DODECAHEDRON),
         "dodeca_full": (6.0819, pt.DODECAHEDRON)}


def _pair(name):
    side, angles = BOXES[name]
    rad = [math.radians(a) for a in angles]
    return (mt.triclinic_from_lengths_angles((side,) * 3, rad,
                                             dtype=jnp.float64),
            pt.triclinic_from_lengths_angles((side,) * 3, rad,
                                             dtype=torch.float64, device=CPU))


@pytest.mark.parametrize("name", sorted(BOXES))
def test_triclinic_matches_jax(name):
    jb, pb = _pair(name)
    np.testing.assert_allclose(np64(pb.basis), np64(jb.basis), atol=TOL)
    assert float(pb.volume()) == pytest.approx(float(jb.volume()), rel=TOL)
    np.testing.assert_allclose(pb.perp_widths(), boundary_perp_widths(jb),
                               rtol=TOL)
    np.testing.assert_allclose(np64(pb.center()), np64(jb.center()),
                               atol=TOL)
    rng = np.random.default_rng(3)
    x = rng.uniform(-8.0, 8.0, (500, 3))
    y = rng.uniform(-8.0, 8.0, (500, 3))
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_allclose(np64(pb.fractional(tx)),
                               np64(jb.fractional(jnp.asarray(x))), atol=TOL)
    np.testing.assert_allclose(np64(pb.wrap(tx)),
                               np64(jb.wrap(jnp.asarray(x))), atol=TOL)
    np.testing.assert_allclose(
        np64(pb.displacement(tx, ty)),
        np64(jb.displacement(jnp.asarray(x), jnp.asarray(y))), atol=TOL)
    # the kernel's 9-float row
    np.testing.assert_allclose(pb.mic_row_tensor().tolist(),
                               np64(kernel_mic_row(jb, jnp.float64))[0, :9],
                               rtol=TOL)


def test_orthorhombic_mic_row_opens_infinite_axes():
    box = pt.rectangular([2.0, float("inf"), 4.0], dtype=torch.float64,
                         device=CPU)
    assert box.mic_row_tensor().tolist() == [2.0, 0.0, 0.0, 0.0, 0.0, 4.0,
                                             0.5, 0.0, 0.25]
    d = mic_displacement(
        box, torch.tensor([[0.1, 0.0, 0.1]], dtype=torch.float64),
        torch.tensor([[1.9, 7.0, 3.9]], dtype=torch.float64))
    np.testing.assert_allclose(d.numpy(), [[-0.2, 7.0, -0.2]], atol=TOL)


@pytest.mark.parametrize("name", sorted(BOXES))
def test_both_minimum_images_are_the_shortest_below_list_radius(name):
    """For 200,000 random pairs (fractional positions in [-1, 2)), the
    kernel's back-substitution image and the fractional-rounding image are
    the shortest of the 125 images within two cells, for every pair whose
    shortest image is under the 1.15 nm list radius."""
    _, pb = _pair(name)
    rng = np.random.default_rng(5)
    h = pb.basis
    xi = torch.as_tensor(rng.uniform(-1.0, 2.0, (200_000, 3))) @ h
    xj = torch.as_tensor(rng.uniform(-1.0, 2.0, (200_000, 3))) @ h
    back = torch.linalg.vector_norm(mic_displacement(pb, xi, xj), dim=1)
    frac = torch.linalg.vector_norm(pb.displacement(xi, xj), dim=1)
    shifts = torch.tensor(list(itertools.product(range(-2, 3), repeat=3)),
                          dtype=torch.float64) @ h
    best = torch.full_like(back, float("inf"))
    base = pb.displacement(xi, xj)
    for s in shifts:
        best = torch.minimum(best, torch.linalg.vector_norm(base + s, dim=1))
    near = best < LIST_RADIUS
    assert int(near.sum()) > 5000
    np.testing.assert_allclose(back[near].numpy(), best[near].numpy(),
                               atol=TOL)
    np.testing.assert_allclose(frac[near].numpy(), best[near].numpy(),
                               atol=TOL)


def test_triclinic_cryst1_reads_as_jax():
    path = box_path("dodeca64")
    ours, theirs = read_pdb(path), jax_read_pdb(path)
    assert ours.box.shape == (3, 3)
    np.testing.assert_array_equal(ours.box, theirs.box)
    np.testing.assert_array_equal(ours.coords, theirs.coords)
    assert ours.atom_names == theirs.atom_names


def test_dodecahedron_water_box(tmp_path):
    """5,318 waters in the xy-square rhombic dodecahedron at the cube's
    volume: d = 6.0819 nm, smallest perpendicular width d / sqrt(2) = 4.30
    nm, nearest oxygens 0.338 nm apart (d / 18)."""
    path = pt.water_box_pdb(str(tmp_path / "d.pdb"), 5318,
                            angles=pt.DODECAHEDRON)
    with open(path) as f:
        first = f.readline()
    assert first.startswith("CRYST1")
    assert first[33:54] == "  60.00  60.00  90.00"
    sys = pt.system_from_pdb(path, pt.ForceField(pt.TIP3P_XML),
                             dtype=torch.float64, device=CPU,
                             constraints="hbonds", rigid_water=True,
                             dist_neighbors=LIST_RADIUS)
    box = sys.boundary
    assert isinstance(box, pt.Triclinic)
    d = float(box.basis[0, 0])
    assert d == pytest.approx(6.0819, abs=1e-3)
    cube = 5318 / pt.models.waterbox.WATER_DENSITY          # nm^3
    assert float(box.volume()) == pytest.approx(cube, rel=1e-4)
    assert min(box.perp_widths()) == pytest.approx(d / math.sqrt(2),
                                                   rel=1e-9)
    assert min(box.perp_widths()) > 2 * LIST_RADIUS
    ox = sys.coords[::3]
    dist = torch.linalg.vector_norm(box.displacement(
        ox[:300, None, :], ox[None, :, :]), dim=-1)
    dist[torch.arange(300), torch.arange(300)] = float("inf")
    assert float(dist.min()) == pytest.approx(d / 18, abs=2e-3)
