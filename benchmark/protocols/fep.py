"""One lambda window of an FEP run with U sampled at every lambda: the
protocol of the ``fep`` traffic file (GROMACS's free-energy = yes with
nstdhdl and calc-lambda-neighbors = -1; integrator md, tcoupl v-rescale).

Set-up builds the coupled system from the seed (the builder's ``build``,
with the traffic's ``lambda`` added to the inputs it hands the reference),
sets the solute's lambda to it with ``set_lambda``, evaluates the first
forces and runs ``warmup_steps`` as the window runs, so that every kernel
the window launches, the sampling's included, has run once. The window
runs chunks of ``chunk_steps`` through ``run_chunk`` (the cluster-pair
list rebuilt every ``rebuild_every`` steps with its exact stale check) at
that lambda until ``--seconds`` have passed. After each chunk that ends on
a multiple of ``sample_every_steps``, U at every lambda of ``lambdas``
comes from ``ExtendedStateSpace.state_energies`` (the path of AWH, TSS and
H-REMD, here with the system's PerturbedTerms) into a preallocated device
buffer, read once after the window: sampling adds no host read. The rate
is all the window's steps over all its time, the samples' included.

The checks, each on what the timed path produced at the timed size:

- ``e_start``, ``f_end``, ``x_chunk``, ``c_end``: the nvt protocol's
  (protocols/nvt.py ``check``), at the window's lambda;
- ``du_cross`` (kT at ref_t): at the run's last sample, the largest
  |dU_k - dU_k,ref| over the lambdas, dU_k = U_k - U(lambda) against the
  running lambda, the reference's U from the program's coordinates of that
  sample.

``control``: the nvt protocol's (the reference in TF32 in the program's
place, from the program's start velocities, for ``control_warmup_steps``
and ``control_chunks`` chunks) at the window's lambda, with the TF32
reference's U at every lambda at its end, judged by the same checks.
"""

from __future__ import annotations

import sys
import time
import types

from protocols import nvt
from protocols.nvt import _draws, _generator, _thermostat, sync

#: the sample buffer's rows: far more samples than a window takes
CAPACITY = 1 << 14


def _kt(mdp):
    return 0.00831446261815324 * mdp["ref_t"]


def _at_window(run):
    """The cell's builder with the traffic's lambda added to the inputs it
    hands the reference, so that the nvt protocol's control and checks
    hold the reference at the window's lambda."""
    builder, lam = run.builder, run.traffic["lambda"]

    def build(cfg, seed, device, work):
        system, inputs = builder.build(cfg, seed, device, work)
        return system, dict(inputs, **{"lambda": lam})
    return types.SimpleNamespace(build=build, reference=builder.reference)


def _sampler(run, pt, system, mask):
    """(ExtendedStateSpace, sample(system, nb, buffer, row)) of the
    traffic's lambdas."""
    space = pt.ExtendedStateSpace.lambda_grid(
        run.traffic["lambdas"], run.cfg["mdp"]["ref_t"], atom_mask=mask,
        perturbed_terms=pt.PerturbedTerms.setup(system, mask))

    def sample(system, nb, buffer, row):
        buffer[row].copy_(space.state_energies(system, nb))
    return space, sample


def _chunks(pt, sim, system, nb, aux, step, n_chunks, chunk, gen, every,
            take):
    """``n_chunks`` chunks through run_chunk, ``take(system, nb, step)``
    after each that ends on a multiple of ``every``."""
    for _ in range(n_chunks):
        system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, step, chunk,
                                          generator=gen)
        step += chunk
        if step % every == 0:
            take(system, nb, step)
    return system, nb, aux, step


def run(run):
    run.builder = _at_window(run)
    if run.control:
        return _run_control(run)
    import torch
    import mollytpu_torch as pt
    t, mdp = run.traffic, run.cfg["mdp"]
    dt, chunk, every = mdp["dt"], t["chunk_steps"], t["sample_every_steps"]
    t_import = time.perf_counter() - run.t_start
    system, inputs = run.builder.build(run.cfg, run.seed, run.device,
                                       run.work)
    mask = inputs["mask"]
    system = pt.set_lambda(system, t["lambda"], mask)
    t_built = time.perf_counter() - run.t_start
    thermo = _thermostat(pt, mdp)
    sim = pt.Verlet(dt=dt, coupling=(thermo,), remove_cm=False)
    gen = _generator(run)
    nb = pt.find_neighbors(system.neighbor_finder, system.coords,
                           system.boundary, system.exclusions, 0)
    aux = sim.init_aux(system, nb)
    start = {"e": pt.potential_energy(system, nb)}
    space, sample = _sampler(run, pt, system, mask)
    buffer = torch.zeros((CAPACITY, space.n_states), dtype=torch.float64,
                         device=run.device)
    taken = {"rows": 0, "x": None}

    def take(system, nb, step):
        sample(system, nb, buffer, taken["rows"] % CAPACITY)
        taken["rows"] += 1
        taken["x"] = system.coords.clone()
    sync(run.device)
    t_first = time.perf_counter() - run.t_start
    system, nb, aux, step = _chunks(pt, sim, system, nb, aux, 0,
                                    t["warmup_steps"] // chunk, chunk, gen,
                                    every, take)
    sync(run.device)
    setup_s = time.perf_counter() - run.t_start

    chunks, ends, warm_rows = 0, [], taken["rows"]
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        last = {"x": system.coords, "v": system.velocities, "step": step,
                "gen": gen.get_state()}
        system, nb, aux, step = _chunks(pt, sim, system, nb, aux, step, 1,
                                        chunk, gen, every, take)
        sync(run.device)
        chunks += 1
        now = time.perf_counter()
        ends.append(now)
        if now >= deadline:
            break
    rows = taken["rows"]
    if rows > CAPACITY:
        raise RuntimeError(f"{rows} samples overflow the buffer's "
                           f"{CAPACITY} rows")
    energies = buffer[:rows].cpu()
    run.window = {"steps": chunks * chunk, "seconds": now - t0,
                  "chunks": chunks, "dt_ps": dt, "setup_s": setup_s,
                  "samples": rows - warm_rows}
    run.end = {"system": system, "nb": nb, "aux": aux, "sim": sim,
               "step": step, "pt": pt, "gen": gen, "sample": sample,
               "n_states": space.n_states}
    replay = _generator(run)
    replay.set_state(last.pop("gen"))
    last["draws"] = _draws(thermo, system, replay, chunk)
    run.check_inputs = {"inputs": inputs, "start": start, "last": last,
                        "end_x": system.coords, "end_f": aux["forces"],
                        "sample": {"x": taken["x"], "u": energies[-1]}}
    temp = float(pt.temperature(system.masses, system.velocities,
                                system.n_dof))
    per = sorted(1e3 * (b - a) / chunk for a, b in zip([t0] + ends, ends))
    du = energies[-1] - energies[-1][t["lambdas"].index(t["lambda"])]
    print(f"fep: set-up {setup_s:.3f} s (imports done {t_import:.3f}, "
          f"system built {t_built:.3f}, first forces {t_first:.3f}); "
          f"window {chunks} chunks of {chunk} steps in {now - t0:.3f} s, "
          f"{rows - warm_rows} samples "
          "(ms/step by chunk: p10 "
          f"{per[len(per) // 10]:.2f}, median {per[len(per) // 2]:.2f}, "
          f"p90 {per[9 * len(per) // 10]:.2f}); T at the end {temp:.2f} K; "
          "U_k - U(lambda) at the last sample (kJ/mol): "
          + ", ".join(f"{v:.6f}" for v in du.tolist()),
          file=sys.stderr, flush=True)


def steps_of_more_chunks(run):
    return run.traffic["trace_chunks"] * run.traffic["chunk_steps"]


def more_chunks(run):
    """``trace_chunks`` chunks from the window's end state, through the
    window's entry and its sampling (into a buffer of their own), on a
    copy of the thermostat's generator; the end state the other readers
    use is left as is."""
    import torch
    e, t = run.end, run.traffic
    gen = torch.Generator(device=run.device)
    gen.set_state(e["gen"].get_state())
    buffer = torch.zeros((t["trace_chunks"], e["n_states"]),
                         dtype=torch.float64, device=run.device)
    rows = []

    def take(system, nb, step):
        e["sample"](system, nb, buffer, len(rows))
        rows.append(step)
    _chunks(e["pt"], e["sim"], e["system"], e["nb"], e["aux"], e["step"],
            t["trace_chunks"], t["chunk_steps"], gen,
            t["sample_every_steps"], take)


def _run_control(run):
    """The nvt protocol's control at the window's lambda, and the TF32
    reference's U at every lambda at its end."""
    from reference.precision import TF32
    nvt._run_control(run)
    ci = run.check_inputs
    model = run.builder.reference(run.cfg, ci["inputs"], TF32, run.device)
    ci["sample"] = {"x": ci["end_x"], "u": model.energies(
        ci["end_x"], run.traffic["lambdas"]).double().cpu()}


def check(run):
    """The nvt protocol's checks and ``du_cross`` (see the module's
    docstring), worked out once the program's state is freed."""
    import torch
    from reference.precision import F64
    out = nvt.check(run)
    ci, t = run.check_inputs, run.traffic
    ref = run.builder.reference(run.cfg, ci["inputs"], F64, run.device)
    k = t["lambdas"].index(t["lambda"])
    u = ci["sample"]["u"].to(torch.float64)
    u_ref = ref.energies(ci["sample"]["x"], t["lambdas"]).to(
        torch.float64).cpu()
    du = (u - u[k]) - (u_ref - u_ref[k])
    out["du_cross"] = float(du.abs().max()) / _kt(run.cfg["mdp"])
    return out
