#!/usr/bin/env python3
"""On-card smoke run of mollytpu_torch, the PyTorch / CUDA port of mollytpu.

    python3 chip_smoke.py

needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each printing one line or more before the next starts:

1. versions and the card (name and power limit from nvidia-smi);
2. build of the hand-written kernels from mollytpu_torch/csrc;
3. each kernel against its plain PyTorch twin on the same f32 inputs, at
   the main path's shape and on a small system with 1-4 and far-window
   exclusions, forces-only and with energy + virial; times of both at the
   main-path shape (CUDA events, median of 25 launches after warm-up);
4. the main path: a 5,318-water TIP3P box (15,954 atoms, liquid density)
   built from the in-repo force field, PME + rigid water, Langevin at 2 fs
   and 300 K, rebuild every 20 steps, one 100-step warm-up chunk then
   3 x 100 timed steps; checks that every force evaluation launched the
   pair kernel, that coordinates are finite and constrained, the
   temperature sane, and the full-force-field f32 forces against a float64
   evaluation through the plain twins on the final coordinates.

The second-to-last line is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
before either is printed; so does a machine without a CUDA card.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

N_WATERS = 5318          # 15,954 atoms, the 6mrr atom count
LIST_RADIUS = 1.15       # 1.0 nm cutoff + 0.15 nm skin
CADENCE = 20
DT, TEMP, FRICTION = 0.002, 300.0, 1.0
CHUNK, N_TIMED_CHUNKS = 100, 3
SEED = 0
DEVICE = "cuda"

# kernel against twin, both f32 on the same inputs: atomics and the tile
# loop reorder ~1e3-term sums of |F| up to ~1e3 kJ/mol/nm, so the force
# error is ~1e-6 of rms|F|; exact erfcf/expf on both sides. 1e-4 leaves
# two decades; energy and virial sum ~1e7 pair terms: 1e-4 relative.
TOL_FORCE, TOL_ENERGY, TOL_VIRIAL = 1e-4, 1e-4, 1e-4
# f32 main path against a float64 evaluation of the same force field
TOL_F64 = 1e-3


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_cuda():
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU is available; the port's "
                         "kernels run only on the card and there is no CPU "
                         "fallback")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card_line()
    print(f"card: {line}", flush=True)
    return line


def build_kernels():
    from mollytpu_torch.ops import native
    path, secs, log = native.build("pair_nonbonded")
    print(f"built {os.path.relpath(path)} in {secs:.1f} s", flush=True)
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  ptxas: " + ln.strip(), flush=True)


def water_system(device, dtype, n_waters, workdir):
    import torch
    import mollytpu_torch as pt
    path = pt.water_box_pdb(os.path.join(workdir, f"water{n_waters}.pdb"),
                            n_waters, seed=SEED)
    return pt.system_from_pdb(
        path, pt.ForceField(pt.TIP3P_XML), nonbonded_method="pme",
        dtype=dtype, device=device, constraints="hbonds", rigid_water=True,
        dist_neighbors=LIST_RADIUS, neighbor_n_steps=CADENCE)


def exclusion_system(device):
    """64 atoms with chain exclusions, 1-4 pairs and pairs whose id span
    exceeds the bitmap window, randomly placed in a 2.4 nm box."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops.cutoffs import DistanceCutoff
    from mollytpu_torch.ops.pairwise import CoulombEwald, LennardJones
    n, side = 64, 2.4
    rng = np.random.default_rng(SEED)
    pts = []
    while len(pts) < n:
        c = rng.uniform(0.0, side, 3)
        d = np.array(pts) - c if pts else np.zeros((0, 3))
        d -= side * np.round(d / side)
        if not pts or np.min(np.linalg.norm(d, axis=1)) > 0.25:
            pts.append(c)
    coords = np.array(pts)
    d = coords[:, None] - coords[None]
    d = np.linalg.norm(d - side * np.round(d / side), axis=-1)
    far = [(a, b) for a, b in zip(*np.nonzero((d > 0.05) & (d < 0.8)))
           if b - a > 31][:6]
    excl = ([(i, i + 1) for i in range(n - 1)]
            + [(i, i + 2) for i in range(n - 2)] + far[:3])
    spec = [(i, i + 3) for i in range(0, n - 3, 2)] + far[3:]
    q = rng.uniform(-0.5, 0.5, n)
    eps = rng.uniform(0.1, 0.3, n)
    eps[::5] = 0.0
    atoms = pt.make_atoms(n=n, mass=10.0, charge=q - q.mean(),
                          sigma=rng.uniform(0.25, 0.35, n), epsilon=eps,
                          device=device)
    boundary = pt.cubic(side, device=device)
    exclusions = pt.Exclusions.build(n, excl, spec, device=device)
    inters = (LennardJones(cutoff=DistanceCutoff(0.9), weight_special=0.5),
              CoulombEwald(dist_cutoff=0.9, alpha=3.0, weight_special=0.8333))
    finder = pt.BlockPairFinder.setup(boundary, 1.0, n, atoms)
    return pt.System(atoms=atoms, coords=torch.as_tensor(
        coords, dtype=torch.float32, device=device), boundary=boundary,
        pairwise_inters=inters, exclusions=exclusions,
        neighbor_finder=finder), len(far)


def compare(label, system, timing=False):
    """Kernel against twin on the same packed inputs, both modes."""
    import torch
    from mollytpu_torch.ops import pair_kernel as pk
    nb = system.neighbor_finder.find(system.coords, system.boundary,
                                     system.exclusions)
    nb.pos4[:, :3] = system.coords[nb.src]
    spec = pk.build_pair_spec(system.pairwise_inters)
    n = system.n_atoms
    out = {}
    for energy in (False, True):
        f, e, v = pk._pair_nonbonded_cuda(spec, nb, system.boundary, n, energy)
        f0, e0, v0 = pk.pair_nonbonded_plain(spec, nb, system.boundary, n,
                                             energy)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(f).all()):
            raise RuntimeError(f"{label}: kernel forces are not finite")
        df = float((f - f0).abs().max())
        rms = float(f0.pow(2).sum(dim=1).mean().sqrt())
        line = (f"{label} energy={energy}: max|dF| {df:.3e} rms|F| "
                f"{rms:.3e} ratio {df / rms:.3e}")
        if df / rms > TOL_FORCE:
            raise RuntimeError(line + f" exceeds {TOL_FORCE}")
        if energy:
            de = abs(float(e) - float(e0)) / max(1.0, abs(float(e0)))
            dv = float((v - v0).abs().max()) / max(1.0, float(v0.abs().max()))
            line += f"; rel dE {de:.3e} (E {float(e0):.6e}); rel dvir {dv:.3e}"
            if de > TOL_ENERGY or dv > TOL_VIRIAL:
                raise RuntimeError(line + " exceeds the tolerance")
        else:
            out["max_abs_err"] = df
        print(line, flush=True)
    if timing:
        for energy in (False, True):
            t_k = _time(lambda: pk._pair_nonbonded_cuda(
                spec, nb, system.boundary, n, energy))
            t_p = _time(lambda: pk.pair_nonbonded_plain(
                spec, nb, system.boundary, n, energy))
            print(f"{label} energy={energy}: kernel {t_k:.4f} ms, plain "
                  f"twin {t_p:.4f} ms ({nb.n_pairs} cluster pairs, "
                  f"{nb.n_clusters} clusters)", flush=True)
            if not energy:
                out["ms"], out["plain_ms"] = t_k, t_p
    return out


def _time(fn, warmup=3, reps=25):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def reference_forces(sys32, coords32):
    """Forces and potential energy of the full force field on coords32,
    evaluated in float64 through the plain twins on the card."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    system = pt.System(
        atoms=sys32.atoms.to(dtype=torch.float64),
        coords=coords32.double(), boundary=sys32.boundary.to(
            dtype=torch.float64),
        pairwise_inters=sys32.pairwise_inters,
        general_inters=tuple(
            g if not hasattr(g, "moduli_x") else dataclasses.replace(
                g, moduli_x=g.moduli_x.double(),
                moduli_y=g.moduli_y.double(), moduli_z=g.moduli_z.double())
            for g in sys32.general_inters),
        exclusions=sys32.exclusions,
        neighbor_finder=pt.BlockPairFinder.setup(
            sys32.boundary.to(dtype=torch.float64), LIST_RADIUS,
            sys32.n_atoms, sys32.atoms.to(dtype=torch.float64)))
    nb = system.neighbor_finder.find(system.coords, system.boundary,
                                     system.exclusions)
    nb.pos4[:, :3] = system.coords[nb.src]
    spec = pk.build_pair_spec(system.pairwise_inters)
    f, e, v = pk.pair_nonbonded_plain(spec, nb, system.boundary,
                                      system.n_atoms, True)
    f, e, v = pk.far_pair_corrections(spec, system.coords, system.boundary,
                                      system.atoms, system.exclusions, f, e, v)
    for g in system.general_inters:
        fg, _ = g.force_virial(system.coords, system.boundary, system.atoms)
        f = f + fg
        e = e + g.energy(system.coords, system.boundary, system.atoms)
    return f, e


def main_path(workdir):
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    system = water_system(dev, torch.float32, N_WATERS, workdir)
    torch.cuda.synchronize()
    print(f"main path: {system.n_atoms} atoms in a "
          f"{float(system.boundary.side_lengths[0]):.4f} nm box, "
          f"{system.constraints[0].n_constraints} constraints, PME mesh "
          f"{system.general_inters[0].mesh_dims}; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    system = system.update(
        velocities=pt.random_velocities(system.masses, TEMP, gen))
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)

    pk.LAUNCHES = 0
    t0 = time.perf_counter()
    system, nb, aux = pt.simulate(system, sim, CHUNK, generator=gen)
    torch.cuda.synchronize()
    print(f"warm-up chunk of {CHUNK} steps: {time.perf_counter() - t0:.2f} s",
          flush=True)
    step = CHUNK
    t0 = time.perf_counter()
    for _ in range(N_TIMED_CHUNKS):
        system, nb, aux = pt.simulate(system, sim, CHUNK, generator=gen,
                                   neighbors=nb, aux=aux, init_step=step)
        step += CHUNK
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = pk.LAUNCHES
    n_evals = 1 + step            # init_aux + one per step
    if launches != n_evals:
        raise RuntimeError(f"pair kernel launched {launches} times for "
                           f"{n_evals} force evaluations")
    if not bool(torch.isfinite(system.coords).all()):
        raise RuntimeError("non-finite coordinates after the run")
    viol = float(system.constraints[0].max_violation(system.coords,
                                                     system.boundary))
    temp = float(pt.temperature(system.masses, system.velocities,
                                system.n_dof))
    if not viol < 1e-4:
        raise RuntimeError(f"constraint violation {viol:.3e} nm")
    if not (temp == temp and temp < 1000.0):
        raise RuntimeError(f"temperature {temp} K")
    ms = 1e3 * elapsed / (N_TIMED_CHUNKS * CHUNK)
    ns_day = pt.units.ps_per_step_to_ns_per_day(DT, ms * 1e-3)
    print(f"main path: {step} steps, {launches} pair-kernel launches for "
          f"{n_evals} force evaluations; T {temp:.2f} K, max constraint "
          f"violation {viol:.3e} nm, {nb.n_pairs} cluster pairs", flush=True)
    print(f"main path: {ms:.4f} ms/step, {ns_day:.4f} ns/day "
          f"({N_TIMED_CHUNKS * CHUNK} timed steps)", flush=True)

    f32 = aux["forces"]
    f64, e64 = reference_forces(system, system.coords)
    e32 = pt.potential_energy(system, nb)
    rms = float(f64.pow(2).sum(dim=1).mean().sqrt())
    df = float((f32.double() - f64).abs().max()) / rms
    de = abs(float(e32) - float(e64)) / abs(float(e64))
    print(f"main path vs float64 twins: max|dF|/rms|F| {df:.3e}, rel dE "
          f"{de:.3e} (E {float(e64):.6e} kJ/mol)", flush=True)
    if df > TOL_F64 or de > TOL_F64:
        raise RuntimeError("main-path forces disagree with the float64 "
                           "reference")
    return launches, ms, ns_day


def main():
    line = require_cuda()
    import torch
    build_kernels()
    with tempfile.TemporaryDirectory() as workdir:
        dev = torch.device(DEVICE)
        small, n_far = exclusion_system(dev)
        print(f"exclusion system: 64 atoms, {n_far} far-window pairs",
              flush=True)
        compare("exclusions64", small)
        big = water_system(dev, torch.float32, N_WATERS, workdir)
        stats = compare(f"water{big.n_atoms}", big, timing=True)
        del big
        launches, ms, ns_day = main_path(workdir)
    print(f"card: {line}; {ms:.4f} ms/step, {ns_day:.4f} ns/day", flush=True)
    print(json.dumps({"kernels": [{
        "name": "pair_nonbonded (K1a)", "route": "cuda",
        "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": "mollytpu/ops/pallas_pairwise.py:636",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
