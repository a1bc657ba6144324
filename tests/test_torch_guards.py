"""Guards of the PyTorch port: it never imports JAX or the JAX package,
importing it never runs nvcc, CPU tensors never count as kernel launches,
its entry points build on the CUDA card unless told device="cpu", and
chip_smoke.py refuses to run without a CUDA card (no CPU fallback)."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.ops import native, pair_kernel
from torch_parity import CPU
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mollytpu_torch")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_mollytpu():
    bad = re.compile(r"^\s*(import|from)\s+(jax|mollytpu)(\.|\s|$)", re.M)
    offenders = [p for p in _sources() if bad.search(open(p).read())]
    assert not offenders


def _clean_env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTHON", "JAX", "XLA"))}
    env.update(PYTHONPATH=REPO, HOME=str(tmp_path), **extra)
    return env


def test_import_never_touches_nvcc(tmp_path):
    """Import every module of the port with a fake nvcc first on PATH that
    leaves a mark if it is ever run; jax must not be imported either."""
    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    mark = tmp_path / "nvcc_ran"
    nvcc = fake_bin / "nvcc"
    nvcc.write_text(f"#!/bin/sh\ntouch {mark}\nexit 1\n")
    nvcc.chmod(0o755)
    code = ("import importlib, pkgutil, sys, mollytpu_torch\n"
            "for m in pkgutil.walk_packages(mollytpu_torch.__path__, "
            "'mollytpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'mollytpu')]\n"
            "assert not bad, bad\n")
    env = _clean_env(tmp_path, PATH=f"{fake_bin}:{os.environ['PATH']}",
                     CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert not mark.exists()
    assert not os.path.exists(os.path.join(PKG, "_build", "stale-marker"))


def test_cpu_tensors_do_not_count_as_launches():
    n = 40
    gen = torch.Generator().manual_seed(0)
    coords = torch.rand((n, 3), generator=gen, dtype=torch.float64) * 2.4
    boundary = pt.cubic(2.4, dtype=torch.float64, device=CPU)
    atoms = pt.make_atoms(n=n, mass=1.0, sigma=0.3, epsilon=0.2,
                          charge=torch.linspace(-0.3, 0.3, n,
                                                dtype=torch.float64),
                          dtype=torch.float64, device=CPU)
    excl = pt.Exclusions.build(n, device=CPU)
    nb = pt.BlockPairFinder.setup(boundary, 1.0, n, atoms).find(
        coords, boundary, excl)
    spec = pair_kernel.FusedSpec(lj_mode=1, lj_rc=0.9, lj_w=0.5,
                                 coul_mode=3, coul_rc=0.9, ke=138.935,
                                 alpha=3.0, coul_w=0.8333, cut_max=0.9)
    before = native.LAUNCHES["pair_nonbonded"]
    f, e, v = pair_kernel.pair_nonbonded(spec, nb, boundary, n, True)
    assert native.LAUNCHES["pair_nonbonded"] == before
    assert f.shape == (n, 3) and torch.isfinite(f).all()


def test_cuda_wrapper_refuses_cpu_inputs():
    """The kernel wrapper itself takes only CUDA tensors: no silent CPU
    path behind it."""
    n = 32
    boundary = pt.cubic(2.4, dtype=torch.float32, device=CPU)
    atoms = pt.make_atoms(n=n, mass=1.0, sigma=0.3, epsilon=0.2, device=CPU)
    coords = torch.rand((n, 3)) * 2.4
    nb = pt.BlockPairFinder.setup(boundary, 1.0, n, atoms).find(
        coords, boundary, pt.Exclusions.build(n, device=CPU))
    spec = pair_kernel.FusedSpec(lj_mode=1, lj_rc=0.9, lj_w=0.5,
                                 coul_mode=3, coul_rc=0.9, ke=138.935,
                                 alpha=3.0, coul_w=0.8333, cut_max=0.9)
    before = native.LAUNCHES["pair_nonbonded"]
    with pytest.raises(ValueError, match="CUDA"):
        pair_kernel._pair_nonbonded_cuda(spec, nb, boundary, n)
    assert native.LAUNCHES["pair_nonbonded"] == before


def test_resolve_device(monkeypatch):
    """The card when there is one, an error naming device="cpu" when there
    is none, never a silent CPU; a given device wins either way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pt.resolve_device(None) == torch.device("cuda")
    assert pt.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.resolve_device(None)
    assert pt.resolve_device("cpu") == torch.device("cpu")


def _water_pdb(tmp_path):
    return pt.water_box_pdb(str(tmp_path / "w.pdb"), 64, spacing=6.5)


ENTRY_POINTS = {
    "system_from_pdb": lambda tmp, **kw: pt.system_from_pdb(
        _water_pdb(tmp), pt.ForceField(pt.TIP3P_XML), constraints="hbonds",
        rigid_water=True, **kw).coords,
    "cubic": lambda tmp, **kw: pt.cubic(2.0, **kw).side_lengths,
    "rectangular": lambda tmp, **kw: pt.rectangular(
        [2.0, 3.0, 4.0], **kw).side_lengths,
    "triclinic_from_lengths_angles": lambda tmp, **kw:
        pt.triclinic_from_lengths_angles((3.0,) * 3, (1.2, 1.1, 1.0),
                                         **kw).basis,
    "make_atoms": lambda tmp, **kw: pt.make_atoms(n=4, **kw).mass,
    "Exclusions.build": lambda tmp, **kw: pt.Exclusions.build(
        4, [(0, 1)], **kw).excl_bits,
    "crystal_system": lambda tmp, **kw: _crystal(**kw).coords,
    "make_ensemble": lambda tmp, **kw: pt.make_ensemble(
        _crystal(**kw), 2).coords,
    "ReplicaExchangeMD.simulate": lambda tmp, **kw: pt.ReplicaExchangeMD(
        temperatures=[100.0, 110.0], simulator=_langevin(),
        cycle_length=2).simulate(_crystal(**kw), 1)[0].coords,
    "HamiltonianReplicaExchangeMD.simulate": lambda tmp, **kw:
        pt.HamiltonianReplicaExchangeMD(
            lambdas=[1.0, 0.5], simulator=_langevin(),
            cycle_length=2).simulate(_crystal(**kw), 1)[0].coords,
    "Calculator": lambda tmp, **kw: pt.Calculator(_crystal(**kw)).forces(
        np.zeros((4, 3)) + np.arange(4)[:, None] * 0.11),
}


def _crystal(**kw):
    """Four LJ atoms of one fcc cell (0.5 nm) in float64."""
    return pt.crystal_system(0.5, 40.0, 1, dtype=torch.float64, **kw)


def _langevin():
    return pt.Langevin(dt=0.001, temperature=100.0, friction=1.0)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, entry):
    """Without a device an entry point asks for the card (here made absent)
    and raises; with device="cpu" it builds CPU tensors."""
    build = ENTRY_POINTS[entry]
    assert build(tmp_path, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        build(tmp_path)


def test_cutoff_system_without_device_is_on_the_card(tmp_path):
    """system_from_pdb(nonbonded_method="cutoff") with no device: on the
    card where there is one, an error where there is none (this decides at
    run time, so the same test runs on both hosts)."""
    build = ENTRY_POINTS["system_from_pdb"]
    if torch.cuda.is_available():
        assert build(tmp_path, nonbonded_method="cutoff").is_cuda
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(tmp_path, nonbonded_method="cutoff")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """Without a CUDA card (this host) chip_smoke.py exits non-zero with a
    message about the missing GPU and prints no result; copied into an
    otherwise empty directory it fails as well."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path / "alone")
        os.mkdir(cwd)
        shutil.copy(script, cwd)
        script = os.path.join(cwd, "chip_smoke.py")
    env = _clean_env(tmp_path, CUDA_VISIBLE_DEVICES="")
    if where == "alone":
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    if where == "repo":
        assert "no CUDA GPU" in proc.stderr
