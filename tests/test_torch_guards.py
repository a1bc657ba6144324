"""Guards of the PyTorch port: it never imports JAX or the JAX package,
importing it never runs nvcc, CPU tensors never count as kernel launches,
and chip_smoke.py refuses to run without a CUDA card (no CPU fallback)."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.ops import pair_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mollytpu_torch")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


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
    boundary = pt.cubic(2.4, dtype=torch.float64)
    atoms = pt.make_atoms(n=n, mass=1.0, sigma=0.3, epsilon=0.2,
                          charge=torch.linspace(-0.3, 0.3, n,
                                                dtype=torch.float64),
                          dtype=torch.float64)
    excl = pt.Exclusions.build(n)
    nb = pt.BlockPairFinder.setup(boundary, 1.0, n, atoms).find(
        coords, boundary, excl)
    spec = pair_kernel.PairSpec(cutoff=0.9, lj_w=0.5, coul_w=0.8333,
                                ke=138.935, alpha=3.0)
    before = pair_kernel.LAUNCHES
    f, e, v = pair_kernel.pair_nonbonded(spec, nb, boundary, n, True)
    assert pair_kernel.LAUNCHES == before
    assert f.shape == (n, 3) and torch.isfinite(f).all()


def test_cuda_wrapper_refuses_cpu_inputs():
    """The kernel wrapper itself takes only CUDA tensors: no silent CPU
    path behind it."""
    n = 32
    boundary = pt.cubic(2.4, dtype=torch.float32)
    atoms = pt.make_atoms(n=n, mass=1.0, sigma=0.3, epsilon=0.2)
    coords = torch.rand((n, 3)) * 2.4
    nb = pt.BlockPairFinder.setup(boundary, 1.0, n, atoms).find(
        coords, boundary, pt.Exclusions.build(n))
    spec = pair_kernel.PairSpec(0.9, 0.5, 0.8333, 138.935, 3.0)
    before = pair_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        pair_kernel._pair_nonbonded_cuda(spec, nb, boundary, n)
    assert pair_kernel.LAUNCHES == before


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
