#!/usr/bin/env python3
"""The pair kernel K1 of this checkout against other builds of its source,
on chip_smoke.py's four main-path frames (PME cube, RF cube, RF
dodecahedron, FEP-water at lambda 0.75; 15,954 atoms, built frame and
list): each build first held against the twin (an other build may
disagree: a variant made only to time a change), then the device time per
launch in turns (other, this, this, other; chip_smoke.device_ms: CUDA
events around 25 back-to-back launches), forces-only and with energy.

    python3 k1_bench.py --baseline PATH.cu [--baseline PATH.cu ...]

PATH.cu is another version of mollytpu_torch/csrc/pair_nonbonded.cu, for
example an earlier commit's, written into a directory that .gitignore lists:

    git show REV:mollytpu_torch/csrc/pair_nonbonded.cu > _baseline/k1.cu

Its C interface must be this one's: the launcher takes the box's
minimum-image row as a device pointer after lam_role, and its LaunchSpec is
a prefix of this one's (fields are only appended). A source that still
carries the box in LaunchSpec (``float mic[9]``) has another interface and
cannot be compared here. Needs one CUDA card and nvcc, as chip_smoke.py
does.
"""

import argparse
import tempfile

import chip_smoke as cs


def frames(workdir):
    """(label, system) of the four main-path frames."""
    import torch
    import mollytpu_torch as pt
    dev = torch.device(cs.DEVICE)
    out = []
    for label, method, angles, _, _ in cs.MAIN_PATHS:
        out.append((label, cs.water_system(dev, torch.float32, workdir,
                                           method, angles)))
    fep, mask = cs.fep_system(out[0][1])
    out.append((f"FEP-water lambda={cs.FEP_TIMED}",
                pt.set_lambda(fep, cs.FEP_TIMED, atom_mask=mask)))
    return out


def against_twin(lib, spec, nbk, box, n, lam_role, f0):
    """One forces-only launch of ``lib`` into zeroed buffers: max|dF| over
    rms|F| against the twin's forces f0."""
    import torch
    from mollytpu_torch.ops import pair_kernel as pk
    forces = torch.zeros((n, 3), dtype=torch.float32, device=nbk.pos4.device)
    args = pk.launch_args(spec, nbk, box, n, lam_role, forces)
    err = lib.pair_nonbonded_launch(*args[:-1])
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    rms = float(f0.pow(2).sum(dim=1).mean().sqrt())
    return float((forces - f0).abs().max()) / rms


def compare_builds(label, system, name, base):
    from mollytpu_torch.ops import native
    from mollytpu_torch.ops import pair_kernel as pk
    spec = pk.build_fused_spec(system.pairwise_inters)
    box, n = system.boundary, system.n_atoms
    nb = system.neighbor_finder.find(system.coords, box, system.exclusions)
    nbk, lam_role, _ = pk.kernel_inputs(spec, system.coords, system.atoms,
                                        nb)
    this = native.load("pair_nonbonded", pk._SIG)
    f0, _, _ = pk.pair_nonbonded_plain(spec, nbk, box, n, False, lam_role)
    errs = [against_twin(lib, spec, nbk, box, n, lam_role, f0)
            for lib in (base, this)]
    line = (f"{label} ({pk.instance_family(spec, box)}): against the twin, "
            f"max|dF|/rms|F| other ({name}) {errs[0]:.3e}, this "
            f"{errs[1]:.3e}")
    print(line, flush=True)
    if errs[1] > cs.TOL_FORCE:
        raise RuntimeError(line + " exceeds the tolerance")
    for energy in (False, True):
        t = [cs.device_ms(spec, nbk, box, n, lam_role, energy, lib=lib)
             for lib in (base, this, this, base)]
        ratio = (t[0] + t[3]) / (t[1] + t[2])
        print(f"{label} energy={energy}: device ms per launch, in turns: "
              f"other ({name}) {t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, "
              f"other {t[3]:.4f}; other / this {ratio:.3f}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", required=True,
                    help="another pair_nonbonded.cu (repeatable)")
    args = ap.parse_args()
    line = cs.require_cuda()
    from mollytpu_torch.ops import native
    from mollytpu_torch.ops import pair_kernel as pk
    cs.build_kernels()
    bases = {}
    for k, src in enumerate(args.baseline):
        name = f"pair_nonbonded_baseline{k}"
        _, secs, _ = native.build(name, src)
        print(f"built {src} in {secs:.1f} s", flush=True)
        bases[src] = native.load(name, pk._SIG, src)
    with tempfile.TemporaryDirectory() as workdir:
        for label, system in frames(workdir):
            for src, base in bases.items():
                compare_builds(label, system, src, base)
    print(f"card: {line}", flush=True)


if __name__ == "__main__":
    main()
