"""Build and load the hand-written CUDA kernels under ``mollytpu_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C launcher. It is compiled by
``nvcc`` for ``sm_90a`` into ``mollytpu_torch/_build/<name>-<hash>.so`` on
first use (the hash covers the source and the flags, so an edited source is
rebuilt) and loaded with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of mollytpu_torch "
                       "are built on a machine with the CUDA toolkit")


def build(name, src=None):
    """Compile csrc/<name>.cu (or the source ``src``, into a library of
    that name) unless an up-to-date library exists. Returns (path, seconds
    spent building, compiler log); the log is kept beside the library
    (``<path>.log``) and returned again when the library is up to date."""
    src = src or os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out) and os.path.exists(out + ".log"):
        with open(out + ".log") as fh:
            return out, 0.0, fh.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    with open(f"{tmp}.log", "w") as fh:
        fh.write(log)
    os.replace(f"{tmp}.log", out + ".log")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, log


def load(name, signatures, src=None):
    """The ctypes library of csrc/<name>.cu (or of ``src``, as in build)
    with ``signatures`` (function name -> argtypes) declared; each function
    returns a C int."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _, _ = build(name, src)
        lib = ctypes.CDLL(path)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
