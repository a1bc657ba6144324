"""The kernels' build and launch seam (ops/native.py): the library's name
follows the headers its source includes, so an edited header is rebuilt
(on the CPU: nvcc is replaced by a stub that writes an empty library);
and on a CUDA card each kernel's launch counts one in native.LAUNCHES
under its own name and nothing under another. The card tests skip
without a card (the kernels have no CPU mode). It imports neither JAX nor
the JAX package, so it runs on a card host without them:

    python -m pytest --noconftest -q tests/test_torch_native_cuda.py
"""

import collections
import shutil
import subprocess

import pytest
import torch

from mollytpu_torch.models import gromacs, ljbench, waterbox
from mollytpu_torch.ops import native, pair_kernel
from mollytpu_torch.ops.nonbonded import neighbor_forces
from mollytpu_torch.sim.simulate import missing_min_distance

KERNELS = ("pair_nonbonded", "cell_neighbors", "lj_table",
           "rigid_triangles", "table_check")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test, as the parity tests run under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", KERNELS)
def test_build_rebuilds_when_an_included_header_changes(name, tmp_path,
                                                        monkeypatch):
    """Each source is built once while nothing changes; editing mic.cuh
    builds anew the sources that include it, and only those."""
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC, csrc)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_nvcc", lambda: "nvcc")
    built = []

    def nvcc(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        built.append(out)
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(native.subprocess, "run", nvcc)
    src = str(csrc / f"{name}.cu")
    first = native.build(name, src)[0]
    assert native.build(name, src)[0] == first and len(built) == 1
    with open(csrc / "mic.cuh", "a") as fh:
        fh.write("// edited\n")
    includes = '#include "mic.cuh"' in (csrc / f"{name}.cu").read_text()
    assert includes == (name != "pair_nonbonded")
    assert (native.build(name, src)[0] != first) == includes
    assert len(built) == 1 + includes


def one_launch(name, dev, tmp_path):
    """A call that launches kernel ``name`` once: the pair kernel and the
    rigid-triangle kernel on the committed SPC tile (1,000 rigid waters,
    PME on the cluster-pair list), the cell-list, table and table-check
    kernels on in.lj at 500 atoms."""
    if name in ("cell_neighbors", "lj_table", "table_check"):
        s = ljbench.lj_bench_system(5, torch.float32, dev, n_steps=5)
        find = (lambda: s.neighbor_finder.find(s.coords, s.boundary,
                                               s.exclusions))
        if name == "cell_neighbors":
            return find
        nb = find()
        if name == "table_check":
            return lambda: missing_min_distance(nb, nb, s.coords, s.boundary,
                                                ljbench.CUTOFF)
        return lambda: neighbor_forces(s.pairwise_inters, s.atoms, s.coords,
                                       s.boundary, nb)
    gro = gromacs.read_gro(waterbox.SPC_TILE)
    top = waterbox.spc_topology(str(tmp_path / "spc.top"), len(gro[0]) // 3)
    s = gromacs.system_from_gromacs(
        gro, top, nonbonded_method="pme", device=dev, use_settles=True,
        velocities_from_gro=False, neighbor_finder="block")
    if name == "rigid_triangles":
        (c,) = s.constraints
        vels = torch.ones_like(s.coords)
        return lambda: c.apply_velocity_constraints(s.coords, vels, s.masses,
                                                    s.boundary)
    nb = s.neighbor_finder.find(s.coords, s.boundary, s.exclusions)
    nb.pos4[:, :3] = s.coords[nb.src]
    spec = pair_kernel.build_fused_spec(s.pairwise_inters)
    return lambda: pair_kernel.pair_nonbonded(spec, nb, s.boundary,
                                              s.n_atoms)


@pytest.mark.parametrize("name", KERNELS)
def test_a_launch_counts_one_under_its_own_name(name, tmp_path):
    call = one_launch(name, card(), tmp_path)
    before = native.LAUNCHES.copy()
    call()
    torch.cuda.synchronize()
    assert native.LAUNCHES - before == collections.Counter({name: 1})
