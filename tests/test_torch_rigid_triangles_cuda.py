"""The rigid-triangle kernel (csrc/rigid_triangles.cu) against its PyTorch
twin (SHAKERattle's cluster solve) on the same card tensors: the
committed SPC tile (1,000 rigid waters) with every atom moved by up to
0.004 nm, a step's SHAKE from the tile and a RATTLE at the moved frame,
in float32 and float64, in the tile's cube and in a skewed triclinic box;
one launch per call. Every test needs a CUDA card and skips
without one (the kernel has no CPU mode). It imports neither JAX nor the
JAX package, so it runs on a card host without them:

    python -m pytest --noconftest -q tests/test_torch_rigid_triangles_cuda.py
"""

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.models import gromacs, waterbox
from mollytpu_torch.ops import constraints, native

#: float32: a few ulps of a 3 nm coordinate; float64: rounding
TOL = {torch.float32: 2e-6, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test, as the parity tests run under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def tile_on(dev, dtype, tmp_path, triclinic=False):
    gro = gromacs.read_gro(waterbox.SPC_TILE)
    top = waterbox.spc_topology(str(tmp_path / "spc.top"), len(gro[0]) // 3)
    s = gromacs.system_from_gromacs(
        gro, top, nonbonded_method="pme", device=dev, dtype=dtype,
        use_settles=True, velocities_from_gro=False)
    if triclinic:
        edge = float(s.boundary.side_lengths[0])
        s = s.update(boundary=pt.boundary.triclinic(
            np.diag([edge] * 3) + np.array([[0, 0, 0], [0.3, 0, 0],
                                            [0, 0, 0]]),
            dtype=dtype, device=dev))
    g = torch.Generator(device=dev).manual_seed(9)
    moved = s.coords + 0.004 * (2 * torch.rand(
        s.coords.shape, generator=g, dtype=dtype, device=dev) - 1)
    vels = torch.randn(s.coords.shape, generator=g, dtype=dtype, device=dev)
    return s, moved, vels


def both(monkeypatch, call):
    """(kernel's result, twin's result, kernel launches in the call)."""
    before = native.LAUNCHES["rigid_triangles"]
    got = call()
    launches = native.LAUNCHES["rigid_triangles"] - before
    with monkeypatch.context() as m:
        m.setattr(constraints, "_on_kernel", lambda *a: False)
        want = call()
    return got, want, launches


@pytest.mark.parametrize("triclinic", [False, True],
                         ids=["cube", "triclinic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shake_matches_the_twin(dtype, triclinic, tmp_path, monkeypatch):
    dev = card()
    s, moved, vels = tile_on(dev, dtype, tmp_path, triclinic)
    (c,) = s.constraints
    (x, v), (x_t, v_t), launches = both(monkeypatch, lambda: (
        c.apply_position_constraints(s.coords, moved, vels, s.masses,
                                     s.boundary, 0.002)))
    assert launches == 1
    assert float((x - x_t).abs().max()) < TOL[dtype]
    assert float((v - v_t).abs().max()) < TOL[dtype] / 0.002
    assert float(c.max_violation(x, s.boundary)) < 50 * TOL[dtype]


@pytest.mark.parametrize("triclinic", [False, True],
                         ids=["cube", "triclinic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rattle_matches_the_twin(dtype, triclinic, tmp_path, monkeypatch):
    dev = card()
    s, moved, vels = tile_on(dev, dtype, tmp_path, triclinic)
    (c,) = s.constraints
    v, v_t, launches = both(monkeypatch, lambda: (
        c.apply_velocity_constraints(moved, vels, s.masses, s.boundary)))
    assert launches == 1
    assert float((v - v_t).abs().max()) < 10 * TOL[dtype]


def test_half_precision_on_the_card_raises(tmp_path):
    dev = card()
    s, moved, vels = tile_on(dev, torch.float32, tmp_path)
    (c,) = s.constraints
    with pytest.raises(TypeError, match="float32 or float64"):
        c.apply_velocity_constraints(moved.half(), vels.half(),
                                     s.masses.half(), s.boundary)
