"""Leap-frog with the v-rescale thermostat in whole chunks: the protocol of
the ``nvt`` traffic file (GROMACS's integrator = md, tcoupl = v-rescale).

Set-up builds the system from the seed (the builder's ``build``, which
draws the start velocities), evaluates the first forces and runs
``warmup_steps`` through ``run_chunk``, the window's own entry, so that
every kernel the window launches has run once. The thermostat draws from
one ``torch.Generator`` seeded from the seed. The window then runs chunks
of ``chunk_steps`` through ``run_chunk`` (the cluster-pair list rebuilt
every ``rebuild_every`` steps with its exact stale check, one host read
per chunk) until ``--seconds`` have passed; the rate is all its steps
over all its time.

The checks, each computed on what the timed path produced at the timed
size:

- ``e_start``: the program's potential energy at the start against the
  reference's at its own start (the same tile, laid out and constrained
  by the reference), relative;
- ``f_end``: the forces the window's last step left in ``aux`` against the
  reference's at the same coordinates (checks.force_gap);
- ``x_chunk`` (nm): the window's last chunk followed again by the
  reference in float64 from the program's state at its start, with the
  thermostat's draws of that chunk replayed from the generator's state,
  against the program's end frame (checks.position_gap);
- ``c_end``: the largest relative deviation of a water's distances from
  SPC's at the window's end.

``control``: the reference in TF32 (reference/precision.py) is put in
the program's place, from the program's start velocities, for
``control_warmup_steps`` and ``control_chunks`` chunks, and judged by the
same checks.
"""

from __future__ import annotations

import gc
import sys
import time


def sync(device):
    import torch
    if str(device).split(":")[0] == "cuda":
        torch.cuda.synchronize()


def _thermostat(pt, mdp):
    return pt.VelocityRescaleThermostat(mdp["ref_t"], mdp["tau_t"])


def _generator(run):
    """The thermostat's generator, seeded from the seed (the builder's
    velocities take the seed itself)."""
    import torch
    return torch.Generator(device=run.device).manual_seed(
        (int(run.seed) * 2654435761 + 1) % (1 << 63))


def _draws(thermo, system, generator, n):
    """The thermostat's (r1, g) of n steps from ``generator``."""
    out = []
    for _ in range(n):
        d = thermo.draw(system, generator)
        out.append((float(d["r1"]), float(d["g"])))
    return out


def run(run):
    if run.control:
        return _run_control(run)
    import mollytpu_torch as pt
    t, mdp = run.traffic, run.cfg["mdp"]
    dt, chunk = mdp["dt"], t["chunk_steps"]
    t_import = time.perf_counter() - run.t_start
    system, inputs = run.builder.build(run.cfg, run.seed, run.device,
                                       run.work)
    t_built = time.perf_counter() - run.t_start
    thermo = _thermostat(pt, mdp)
    sim = pt.Verlet(dt=dt, coupling=(thermo,), remove_cm=False)
    gen = _generator(run)
    nb = pt.find_neighbors(system.neighbor_finder, system.coords,
                           system.boundary, system.exclusions, 0)
    aux = sim.init_aux(system, nb)
    start = {"e": pt.potential_energy(system, nb)}
    sync(run.device)
    t_first = time.perf_counter() - run.t_start
    system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, 0,
                                      t["warmup_steps"], generator=gen)
    sync(run.device)
    setup_s = time.perf_counter() - run.t_start

    step, chunks, ends = t["warmup_steps"], 0, []
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        last = {"x": system.coords, "v": system.velocities, "step": step,
                "gen": gen.get_state()}
        system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, step, chunk,
                                          generator=gen)
        sync(run.device)
        step += chunk
        chunks += 1
        now = time.perf_counter()
        ends.append(now)
        if now >= deadline:
            break
    run.window = {"steps": chunks * chunk, "seconds": now - t0,
                  "chunks": chunks, "dt_ps": dt, "setup_s": setup_s}
    run.end = {"system": system, "nb": nb, "aux": aux, "sim": sim,
               "step": step, "pt": pt, "gen": gen}
    replay = _generator(run)
    replay.set_state(last.pop("gen"))
    last["draws"] = _draws(thermo, system, replay, chunk)
    run.check_inputs = {"inputs": inputs, "start": start, "last": last,
                        "end_x": system.coords, "end_f": aux["forces"]}
    temp = float(pt.temperature(system.masses, system.velocities,
                                system.n_dof))
    per = sorted(1e3 * (b - a) / chunk for a, b in zip([t0] + ends, ends))
    print(f"nvt: set-up {setup_s:.3f} s (imports done {t_import:.3f}, "
          f"system built {t_built:.3f}, first forces {t_first:.3f}); "
          f"window {chunks} chunks of {chunk} steps in {now - t0:.3f} s "
          "(ms/step by chunk: p10 "
          f"{per[len(per) // 10]:.2f}, median {per[len(per) // 2]:.2f}, "
          f"p90 {per[9 * len(per) // 10]:.2f}); T at the end {temp:.2f} K",
          file=sys.stderr, flush=True)


def steps_of_more_chunks(run):
    return run.traffic["trace_chunks"] * run.traffic["chunk_steps"]


def more_chunks(run):
    """``trace_chunks`` chunks from the window's end state, through the
    window's entry, on a copy of the thermostat's generator; the end state
    the other readers use is left as is."""
    import torch
    e, t = run.end, run.traffic
    pt, system, nb, aux, step = e["pt"], e["system"], e["nb"], e["aux"], \
        e["step"]
    gen = torch.Generator(device=run.device)
    gen.set_state(e["gen"].get_state())
    for _ in range(t["trace_chunks"]):
        system, nb, aux, _ = pt.run_chunk(e["sim"], system, nb, aux, step,
                                          t["chunk_steps"], generator=gen)
        step += t["chunk_steps"]


def _run_control(run):
    """The reference in TF32 in the program's place."""
    import mollytpu_torch as pt
    from reference.precision import TF32
    t, mdp = run.traffic, run.cfg["mdp"]
    chunk = t["chunk_steps"]
    system, inputs = run.builder.build(run.cfg, run.seed, run.device,
                                       run.work)
    thermo = _thermostat(pt, mdp)
    gen = _generator(run)
    model = run.builder.reference(run.cfg, inputs, TF32, run.device)
    x, v = model.start, system.velocities.to(model.prec.dtype)
    start = {"e": model.energy(model.start)}

    def follow(x, v, draws):
        return model.leapfrog(x, v, len(draws), mdp["dt"], mdp["ref_t"],
                              mdp["tau_t"], draws)
    t0 = time.perf_counter()
    x, v = follow(x, v, _draws(thermo, system, gen,
                               t["control_warmup_steps"]))
    last = None
    for _ in range(t["control_chunks"]):
        last = {"x": x, "v": v, "draws": _draws(thermo, system, gen, chunk)}
        x, v = follow(x, v, last["draws"])
    sync(run.device)
    run.window = {"steps": t["control_chunks"] * chunk,
                  "seconds": time.perf_counter() - t0,
                  "chunks": t["control_chunks"], "dt_ps": mdp["dt"],
                  "setup_s": 0.0}
    run.check_inputs = {"inputs": inputs, "start": start, "last": last,
                        "end_x": x, "end_f": model.forces(x)}


def check(run):
    """The numbers compared with the cell's limits (see the module's
    docstring), worked out once the program's state is freed."""
    import torch
    from checks import force_gap, position_gap
    from reference.precision import F64
    ci, mdp = run.check_inputs, run.cfg["mdp"]
    run.end.clear()
    gc.collect()
    if str(run.device).split(":")[0] == "cuda":
        torch.cuda.empty_cache()
    ref = run.builder.reference(run.cfg, ci["inputs"], F64, run.device)
    e_ref = float(ref.energy(ref.start))
    out = {"e_start": abs(float(ci["start"]["e"]) - e_ref) / abs(e_ref),
           "f_end": force_gap(ci["end_f"], ref.forces(ci["end_x"]))}
    last = ci["last"]
    x_ref, _ = ref.leapfrog(last["x"], last["v"], run.traffic["chunk_steps"],
                            mdp["dt"], mdp["ref_t"], mdp["tau_t"],
                            last["draws"])
    out["x_chunk"] = position_gap(ci["end_x"], x_ref, ref.mic)
    out["c_end"] = ref.constraint_deviation(ci["end_x"])
    return out
