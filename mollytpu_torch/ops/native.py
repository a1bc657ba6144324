"""Build, load and launch the hand-written CUDA kernels under
``mollytpu_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C launcher. It is compiled by
``nvcc`` for ``sm_90a`` into ``mollytpu_torch/_build/<name>-<hash>.so`` on
first use (the hash covers the source, the headers it includes by quoted
name and the flags, so an edited source or header is rebuilt) and loaded
with ``ctypes``. ``launch`` calls a launcher on the current stream and
counts the launch in ``LAUNCHES``. Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

#: launches through ``launch`` since import, per library name
#: ("pair_nonbonded", "cell_neighbors", "lj_table", "rigid_triangles",
#: "table_check")
LAUNCHES = collections.Counter()


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


def _sources(path):
    """The bytes of ``path`` and of every header it includes by quoted name
    (found beside the including file), and of theirs."""
    with open(path, "rb") as fh:
        text = fh.read()
    return text + b"".join(
        _sources(os.path.join(os.path.dirname(path), inc.decode()))
        for inc in _INCLUDE.findall(text))


def build(name, src=None):
    """Compile csrc/<name>.cu (or the source ``src``, into a library of
    that name) unless an up-to-date library exists. Returns (path, seconds
    spent building, compiler log); the log is kept beside the library
    (``<path>.log``) and returned again when the library is up to date."""
    src = src or os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(_sources(src) + " ".join(NVCC_FLAGS).encode())
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


def launch(name, fn, signatures, *args, device):
    """Call the C launcher ``fn`` of csrc/<name>.cu (loaded with
    ``signatures``) with ``args``, a tensor by its data pointer, a ctypes
    structure by its address, None (null) and ints as they are, and the
    current stream of ``device`` appended, under
    ``torch.cuda.device(device)``: a launcher launches on the calling
    thread's current device. Raises RuntimeError on a nonzero return (a
    CUDA error code) and counts the launch in ``LAUNCHES[name]``."""
    lib = load(name, signatures)
    args = [a.data_ptr() if isinstance(a, torch.Tensor)
            else ctypes.addressof(a) if isinstance(a, ctypes.Structure)
            else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}.{fn} failed: CUDA error {err}")
    LAUNCHES[name] += 1
