#!/usr/bin/env python3
"""On-card smoke run of mollytpu_torch, the PyTorch / CUDA port of mollytpu.

    python3 chip_smoke.py

needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each printing one line or more before the next starts:

1. versions and the card (name and power limit from nvidia-smi);
2. build of the hand-written kernels from mollytpu_torch/csrc, with each
   kernel instance's registers and spills;
3. the pair kernel against its plain PyTorch twin on the same f32 inputs,
   forces-only and with energy + virial: on a 64-atom system with 1-4 and
   far-window exclusions, in a cube and in a skewed triclinic box, for
   every mode without alchemical lambda (K1a and K1b);
4. three main paths, each at 5,318 TIP3P waters (15,954 atoms, liquid
   density) built from the in-repo force field with rigid water and H-bond
   constraints, Langevin at 2 fs and 300 K, rebuild every 10 steps:
   PME in the cube (K1a), the reaction field (nonbonded_method="cutoff") in
   the cube and in the rhombic dodecahedron (K1b). For each: the kernel
   against its twin on the built system with CUDA-event times of both
   (median of 25) and the kernel's bound; then the launch counts set to 0,
   one 100-step warm-up chunk and 100-step timed chunks, the counts read;
   gates: every force evaluation launched the path's kernel instance,
   coordinates finite, constraints held, temperature sane, no stale list
   (no atom pair the list left out came inside the cutoff by any rebuild),
   and the f32 forces against a float64 evaluation through the plain twins;
5. for the reaction field in the cube: CUDA-event times of the step's
   components and a torch.profiler summary of 20 steps.

The second-to-last line is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
before either is printed; so does a machine without a CUDA card.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

N_WATERS = 5318          # 15,954 atoms, the 6mrr atom count
LIST_RADIUS = 1.15       # 1.0 nm cutoff + 0.15 nm skin
# rebuild cadence, the JAX package's system_from_pdb default: at 20 steps
# the lattice start, which heats the box well above 300 K before the
# thermostat catches it, moves unlisted atom pairs inside the cutoff and
# the stale-list check stops the run (PERF.md)
CADENCE = 10
DT, TEMP, FRICTION = 0.002, 300.0, 1.0
CHUNK = 100
SEED = 0
DEVICE = "cuda"
CUBE = (90.0, 90.0, 90.0)
DODECAHEDRON = (60.0, 60.0, 90.0)   # mollytpu_torch.models.waterbox

#: the main paths: label, nonbonded_method, cell angles, timed chunks,
#: and the kernel instance family each runs (pair_kernel.instance_family)
MAIN_PATHS = (("PME", "pme", CUBE, 2, "coul3-ortho"),
              ("RF-ortho", "cutoff", CUBE, 3, "coul2-ortho"),
              ("RF-dodecahedron", "cutoff", DODECAHEDRON, 2,
               "coul2-triclinic"))

#: the kernels line: one entry per instance family
FAMILIES = {
    "coul3-ortho": "pair_nonbonded K1a (LJ + Ewald real space, "
                   "orthorhombic)",
    "coul2-ortho": "pair_nonbonded K1b (LJ + reaction field, orthorhombic)",
    "coul2-triclinic": "pair_nonbonded K1b (LJ + reaction field, "
                       "triclinic)",
}

# kernel against twin, both f32 on the same inputs: atomics and the tile
# loop reorder ~1e3-term sums of |F| up to ~1e3 kJ/mol/nm, so the force
# error is ~1e-6 of rms|F|; exact erfcf/expf on both sides. 1e-4 leaves
# two decades; energy and virial sum ~1e7 pair terms: 1e-4 relative (to
# max(1, |E|), the kernel keeps its sums across warps in double).
TOL_FORCE, TOL_ENERGY, TOL_VIRIAL = 1e-4, 1e-4, 1e-4
# f32 main path against a float64 evaluation of the same force field, over
# the atoms with no listed pair within NEAR_CUT nm of a cutoff: f32
# coordinates of a 5.4 nm box are 4.8e-7 nm apart, so the f32 minimum
# image and r^2 may put such a pair on the other side of the cutoff, where
# a truncated potential's force jumps (for an O-H pair under the reaction
# field by ~1 kJ/mol/nm, 1e-3 of rms|F|)
TOL_F64, NEAR_CUT = 1e-3, 2e-6

# The kernel's bound: the largest of its bytes over the card's memory
# rate, its FP32 operations over the card's FP32 rate and its special-
# function operations over the special-function units' rate (H100 SXM at
# 700 W: 3.35 TB/s HBM3 and 67 TFLOP/s dense FP32, NVIDIA's datasheet; 16
# special-function results per SM per clock, CUDA C++ Programming Guide,
# at the 1.98 GHz that the 67 TFLOP/s assumes). Operations are counted per
# pair inside the cutoff (the pairs these inputs need), from
# csrc/pair_nonbonded.cu with an FMA as 2 and sqrt, divide and rint as 1:
# minimum image and r^2 20 (orthorhombic) or 26 (triclinic), 1/r and 1/r^2
# 3, LJ 18, reaction field 11, Ewald 37 (CUDA's erfcf ~20, expf ~3), force
# accumulation 12; special functions: sqrt and reciprocal, plus the
# exponentials of erfcf and expf under Ewald.
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
OPS_PER_PAIR = {"coul3-ortho": 20 + 3 + 18 + 37 + 12,
                "coul2-ortho": 20 + 3 + 18 + 11 + 12,
                "coul2-triclinic": 26 + 3 + 18 + 11 + 12}
SFU_PER_PAIR = {"coul3-ortho": 4, "coul2-ortho": 2, "coul2-triclinic": 2}

#: the small system's modes: (lj_mode, coul_mode, LJ radius, Coulomb
#: radius); radii differ both ways so each term's own mask is exercised
SMALL_MODES = ((1, 0, 0.9, 0.0), (2, 0, 0.9, 0.0), (3, 0, 0.9, 0.0),
               (1, 1, 0.8, 0.9), (2, 1, 0.9, 0.75), (3, 1, 0.8, 0.9),
               (1, 2, 0.9, 0.9), (2, 2, 0.8, 0.9), (3, 2, 0.9, 0.8),
               (4, 1, 0.0, 0.9), (4, 2, 0.0, 0.9), (1, 3, 0.9, 0.9))


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
    """Build csrc/pair_nonbonded.cu; print the time and, per instance
    (Coulomb mode, triclinic, energy), ptxas's registers and spills."""
    from mollytpu_torch.ops import native
    path, secs, log = native.build("pair_nonbonded")
    print(f"built {os.path.relpath(path)} in {secs:.1f} s", flush=True)
    inst, spill = None, ""
    for ln in log.splitlines():
        m = re.search(r"pair_nonbonded_kernelILi(\d)ELb([01])ELb([01])E", ln)
        if "Compiling entry function" in ln and m:
            inst = "coul={} triclinic={} energy={}".format(*m.groups())
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            print(f"  ptxas: instance {inst}: "
                  f"{regs.group(1) if regs else ln.strip()} registers; "
                  f"{spill}", flush=True)


def water_system(device, dtype, workdir, method, angles):
    import mollytpu_torch as pt
    tag = "cube" if angles == CUBE else "dodeca"
    path = pt.water_box_pdb(os.path.join(workdir, f"water-{tag}.pdb"),
                            N_WATERS, seed=SEED, angles=angles)
    return pt.system_from_pdb(
        path, pt.ForceField(pt.TIP3P_XML), nonbonded_method=method,
        dtype=dtype, device=device, constraints="hbonds", rigid_water=True,
        dist_neighbors=LIST_RADIUS, neighbor_n_steps=CADENCE)


def small_inters(lj_mode, coul_mode, lj_rc, coul_rc):
    import mollytpu_torch as pt
    cut = {1: pt.DistanceCutoff, 2: pt.ShiftedPotentialCutoff,
           3: pt.ShiftedForceCutoff}
    out = []
    if lj_mode:
        out.append(pt.LennardJones(
            cutoff=pt.NoCutoff() if lj_mode == 4 else cut[lj_mode](lj_rc),
            weight_special=0.5))
    if coul_mode == 1:
        out.append(pt.Coulomb(cutoff=pt.DistanceCutoff(coul_rc),
                              weight_special=0.8333))
    elif coul_mode == 2:
        out.append(pt.CoulombReactionField(dist_cutoff=coul_rc,
                                           weight_special=0.8333))
    elif coul_mode == 3:
        out.append(pt.CoulombEwald(dist_cutoff=coul_rc, alpha=3.0,
                                   weight_special=0.8333))
    return tuple(out)


def exclusion_system(device, box):
    """64 atoms with chain exclusions, 1-4 pairs and pairs whose id span
    exceeds the bitmap window, randomly placed (0.25 nm apart) in a 2.4 nm
    cube or a 2.6 nm 92/95/88 degree box."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    n = 64
    if box == "cube":
        boundary = pt.cubic(2.4, dtype=torch.float64, device="cpu")
    else:
        boundary = pt.triclinic_from_lengths_angles(
            (2.6,) * 3, [math.radians(a) for a in (92.0, 95.0, 88.0)],
            dtype=torch.float64, device="cpu")
    h = boundary.box_matrix().numpy()
    rng = np.random.default_rng(SEED)
    pts = []
    while len(pts) < n:
        c = torch.as_tensor(rng.uniform(0.0, 1.0, 3) @ h)
        if pts and float(torch.linalg.vector_norm(boundary.displacement(
                torch.stack(pts), c[None]), dim=1).min()) <= 0.25:
            continue
        pts.append(c)
    x = torch.stack(pts)
    d = torch.linalg.vector_norm(boundary.displacement(
        x[:, None], x[None]), dim=-1).numpy()
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
    boundary = boundary.to(device=device, dtype=torch.float32)
    return pt.System(
        atoms=atoms, coords=x.to(device=device, dtype=torch.float32),
        boundary=boundary,
        exclusions=pt.Exclusions.build(n, excl, spec, device=device),
        neighbor_finder=pt.BlockPairFinder.setup(boundary, 1.0, n, atoms)
    ), len(far)


def compare(label, system, timing=False):
    """Kernel against twin on the same packed inputs, both modes; with
    ``timing`` also their CUDA-event times and the kernel's bound."""
    import torch
    from mollytpu_torch.ops import pair_kernel as pk
    nb = system.neighbor_finder.find(system.coords, system.boundary,
                                     system.exclusions)
    nb.pos4[:, :3] = system.coords[nb.src]
    spec = pk.build_fused_spec(system.pairwise_inters)
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
        out.update(bound(label, spec, nb, system.boundary, n))
    return out


def bound(label, spec, nb, boundary, n):
    """The least time the card could take for the forces-only launch."""
    from mollytpu_torch.ops import pair_kernel as pk
    family = pk.instance_family(spec, boundary)
    live = pk.live_pair_count(spec, nb, boundary, n)
    ops = live * OPS_PER_PAIR[family]
    nbytes = 4 * (nb.pos4.numel() + nb.lj2.numel() + nb.ids.numel()
                  + nb.bits.numel() + nb.pairs.numel() + 3 * n)
    t_ops = max(ops / FP32_OPS_PER_S,
                live * SFU_PER_PAIR[family] / SFU_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    ms = 1e3 * max(t_ops, t_bytes)
    print(f"{label} bound: {live:.0f} pairs inside {spec.cut_max} nm x "
          f"{OPS_PER_PAIR[family]} FP32 ops = {ops:.4e} ops "
          f"({1e3 * ops / FP32_OPS_PER_S:.6f} ms at 67 TFLOP/s), x "
          f"{SFU_PER_PAIR[family]} special functions "
          f"({1e3 * live * SFU_PER_PAIR[family] / SFU_OPS_PER_S:.6f} ms); "
          f"{nbytes} bytes ({1e3 * t_bytes:.6f} ms at 3.35 TB/s); bound "
          f"{ms:.6f} ms by {by}", flush=True)
    return {"bound_ms": ms, "bound_by": by, "family": family}


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


def small_modes(dev):
    """Every non-alchemical kernel mode against its twin on the 64-atom
    exclusion system, in the cube and in the skewed triclinic box."""
    for box in ("cube", "skewed"):
        system, n_far = exclusion_system(dev, box)
        print(f"exclusion system ({box}): 64 atoms, {n_far} far-window "
              "pairs", flush=True)
        for mode in SMALL_MODES:
            compare(f"exclusions64-{box} lj{mode[0]}/coul{mode[1]}",
                    system.update(pairwise_inters=small_inters(*mode)))


def near_cutoff_atoms(spec, nb, boundary, n):
    """(n,) mask of the atoms in a listed pair whose distance lies within
    NEAR_CUT of one of the spec's cutoffs."""
    import torch
    from mollytpu_torch.ops import pair_kernel as pk
    row, x, _, idc, bitc, chunks = pk._tiles(nb, boundary, 1024)
    radii = {spec.cut_max, spec.lj_rc, spec.coul_rc} - {0.0}
    flag = torch.zeros(n + 1, dtype=torch.bool, device=x.device)
    for I, J in chunks:
        r = pk._tile_geometry(spec, row, x[I], x[J], idc[I], idc[J],
                              bitc[I], n)[1].sqrt()
        near = torch.zeros_like(r, dtype=torch.bool)
        for rc in radii:
            near |= (r - rc).abs() < NEAR_CUT
        flag[idc[I][:, :, None].expand_as(near)[near]] = True
        flag[idc[J][:, None, :].expand_as(near)[near]] = True
    return flag[:n]


def reference_forces(sys32, coords32):
    """Forces and potential energy of the full force field on coords32,
    evaluated in float64 through the plain twins on the card, and the
    atoms near a cutoff (near_cutoff_atoms)."""
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
    spec = pk.build_fused_spec(system.pairwise_inters)
    f, e, v = pk.pair_nonbonded_plain(spec, nb, system.boundary,
                                      system.n_atoms, True)
    f, e, v = pk.far_pair_corrections(spec, system.coords, system.boundary,
                                      system.atoms, system.exclusions, f, e, v)
    for g in system.general_inters:
        fg, _ = g.force_virial(system.coords, system.boundary, system.atoms)
        f = f + fg
        e = e + g.energy(system.coords, system.boundary, system.atoms)
    return f, e, near_cutoff_atoms(spec, nb, system.boundary, system.n_atoms)


def describe(system):
    box = system.boundary
    if hasattr(box, "basis"):
        shape = (f"rhombic dodecahedron of edge {float(box.basis[0, 0]):.4f}"
                 f" nm (widths {min(box.perp_widths()):.4f}-"
                 f"{max(box.perp_widths()):.4f} nm)")
    else:
        shape = f"{float(box.side_lengths[0]):.4f} nm cube"
    mesh = [g.mesh_dims for g in system.general_inters
            if hasattr(g, "mesh_dims")]
    return (f"{system.n_atoms} atoms in a {shape}, "
            f"{system.constraints[0].n_constraints} constraints, "
            + (f"PME mesh {mesh[0]}" if mesh else "reaction field"))


def main_path(label, system, n_chunks, family):
    """Drive the main path from the built system; check its gates."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    dev = system.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    system = system.update(
        velocities=pt.random_velocities(system.masses, TEMP, gen))
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)

    pk.reset_launch_counts()
    t0 = time.perf_counter()
    system, nb, aux = pt.simulate(system, sim, CHUNK, generator=gen)
    torch.cuda.synchronize()
    print(f"{label}: warm-up chunk of {CHUNK} steps: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    step, closest = CHUNK, math.inf
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        # simulate()'s own loop, which also returns the stale-list check's
        # reading: the closest unlisted atom pair, or a lower bound on it
        # that is at least the cutoff
        system, nb, aux, near = pt.run_chunk(sim, system, nb, aux, step,
                                             CHUNK, generator=gen)
        closest = min(closest, near)
        step += CHUNK
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = pk.LAUNCHES
    own = pk.INSTANCE_LAUNCHES[family]
    n_evals = 1 + step            # init_aux + one per step
    if launches != n_evals or own != n_evals:
        raise RuntimeError(
            f"{label}: pair kernel launched {launches} times ({own} of "
            f"instance {family}) for {n_evals} force evaluations")
    if not bool(torch.isfinite(system.coords).all()):
        raise RuntimeError(f"{label}: non-finite coordinates after the run")
    viol = float(system.constraints[0].max_violation(system.coords,
                                                     system.boundary))
    temp = float(pt.temperature(system.masses, system.velocities,
                                system.n_dof))
    if not viol < 1e-4:
        raise RuntimeError(f"{label}: constraint violation {viol:.3e} nm")
    if not (temp == temp and temp < 1000.0):
        raise RuntimeError(f"{label}: temperature {temp} K")
    ms = 1e3 * elapsed / (n_chunks * CHUNK)
    ns_day = pt.units.ps_per_step_to_ns_per_day(DT, ms * 1e-3)
    print(f"{label}: {step} steps, {launches} pair-kernel launches "
          f"(instance {family}) for {n_evals} force evaluations; "
          f"T {temp:.2f} K, max constraint violation {viol:.3e} nm, "
          f"{nb.n_pairs} cluster pairs; unlisted atom pairs at the timed "
          f"chunks' rebuilds at least {closest:.4f} nm apart", flush=True)
    print(f"{label}: {ms:.4f} ms/step, {ns_day:.4f} ns/day "
          f"({n_chunks * CHUNK} timed steps)", flush=True)

    f32 = aux["forces"]
    f64, e64, near = reference_forces(system, system.coords)
    e32 = pt.potential_energy(system, nb)
    rms = float(f64.pow(2).sum(dim=1).mean().sqrt())
    err = (f32.double() - f64).abs().amax(dim=1) / rms
    df = float(err[~near].max())
    de = abs(float(e32) - float(e64)) / abs(float(e64))
    print(f"{label} vs float64 twins: max|dF|/rms|F| {df:.3e} over the "
          f"{int((~near).sum())} atoms with no pair within {NEAR_CUT} nm of "
          f"the cutoff ({float(err[near].max()) if near.any() else 0.0:.3e}"
          f" over the other {int(near.sum())}), rel dE {de:.3e} "
          f"(E {float(e64):.6e} kJ/mol)", flush=True)
    if df > TOL_F64 or de > TOL_F64:
        raise RuntimeError(f"{label}: forces disagree with the float64 "
                           "reference")
    return dict(launches=launches, ms=ms, ns_day=ns_day, system=system,
                nb=nb, aux=aux, sim=sim, gen=gen, step=step)


def components(label, run):
    """CUDA-event times (median of 20) of the step's parts on the state the
    main path ended in, and a torch.profiler summary of 20 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mollytpu_torch import forces_virial
    from mollytpu_torch.ops import pair_kernel as pk
    from mollytpu_torch.ops.blockpairs import unlisted_min_distance
    system, nb, aux, sim, gen = (run[k] for k in ("system", "nb", "aux",
                                                  "sim", "gen"))
    spec = pk.build_fused_spec(system.pairwise_inters)
    c = system.constraints[0]
    x, v, m, box = system.coords, system.velocities, system.masses, \
        system.boundary
    parts = {
        "whole Langevin step": lambda: sim.step(system, nb, aux, run["step"],
                                                generator=gen),
        "forces_virial (all forces)": lambda: forces_virial(system, nb),
        "pair: gather + kernel + far pairs": lambda: pk.block_nonbonded(
            spec, x, box, system.atoms, system.exclusions, nb),
        "pair kernel alone": lambda: pk.pair_nonbonded(spec, nb, box,
                                                       system.n_atoms),
        "SHAKE (positions)": lambda: c.apply_position_constraints(
            x, x + DT * v, v, m, box, DT),
        "RATTLE (velocities)": lambda: c.apply_velocity_constraints(
            x, v, m, box),
        "rebuild (find)": lambda: system.neighbor_finder.find(
            x, box, system.exclusions),
        "stale-list check": lambda: unlisted_min_distance(
            nb, x, box, spec.cut_max),
    }
    for name, fn in parts.items():
        print(f"{label} component: {name}: {_time(fn, 2, 20):.4f} ms",
              flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s, a = system, aux
        for k in range(20):
            s, a = sim.step(s, nb, a, run["step"] + k, generator=gen)
        torch.cuda.synchronize()
    avgs = prof.key_averages()

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    device_ms = sum(dev_us(e) for e in avgs) / 1e3
    top = sorted(avgs, key=dev_us, reverse=True)[:5]
    print(f"{label} profile, 20 steps: {launches} kernel launches, "
          f"{device_ms:.3f} ms device time ({device_ms / 20:.4f} ms per "
          "step); top: " + "; ".join(
              f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms" for e in top),
          flush=True)


def main():
    line = require_cuda()
    import torch
    build_kernels()
    dev = torch.device(DEVICE)
    small_modes(dev)
    stats, runs = {}, {}
    with tempfile.TemporaryDirectory() as workdir:
        for label, method, angles, n_chunks, family in MAIN_PATHS:
            t0 = time.perf_counter()
            system = water_system(dev, torch.float32, workdir, method, angles)
            torch.cuda.synchronize()
            print(f"{label}: {describe(system)}; setup "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            stats[family] = compare(f"{label} water{system.n_atoms}", system,
                                    timing=True)
            if stats[family]["family"] != family:
                raise RuntimeError(f"{label} runs instance "
                                   f"{stats[family]['family']}")
            runs[label] = main_path(label, system, n_chunks, family)
            if label == "RF-ortho":
                components(label, runs[label])
            runs[label] = {k: runs[label][k]
                           for k in ("launches", "ms", "ns_day")}
            del system
    print(f"card: {line}; " + "; ".join(
        f"{label} {r['ms']:.4f} ms/step, {r['ns_day']:.4f} ns/day"
        for label, r in runs.items()), flush=True)
    print(json.dumps({"kernels": [{
        "name": FAMILIES[family], "route": "cuda",
        "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": "mollytpu/ops/pallas_pairwise.py:636",
        "launches": runs[label]["launches"],
        "max_abs_err": stats[family]["max_abs_err"],
        "ms": stats[family]["ms"], "plain_ms": stats[family]["plain_ms"],
        "bound_ms": stats[family]["bound_ms"],
        "bound_by": stats[family]["bound_by"], "library_ms": None}
        for label, _, _, _, family in MAIN_PATHS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
