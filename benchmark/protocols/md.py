"""Molecular dynamics in whole chunks: the protocol of the ``nve`` traffic
file.

Set-up builds the system from the seed, evaluates the first forces, and
runs ``warmup_steps`` through ``run_chunk``, the window's own entry, so
that every kernel the window launches has run once. The window then runs
chunks of ``chunk_steps`` through ``run_chunk`` (one host read per chunk,
its stale-list check) until ``--seconds`` have passed, and the rate is all
its steps over all its time.

The check: the program's energy at the start (its forces vanish there by
symmetry) against the reference's from the same inputs; the forces the
window's last step left in ``aux`` against the reference's at the same
coordinates; and the window's last chunk followed again by the reference
in float64 from the program's state at its start, against the program's
end frame. A trajectory is chaotic, so the reference follows the
program's own state for one chunk only; the earlier chunks run the same
code.

``control``: the reference in TF32 (reference/precision.py) is put in
the program's place, with the same inputs, warm-up and chunks, and
judged by the same check.
"""

from __future__ import annotations

import gc
import sys
import time


def dt_ps(run):
    return run.traffic["dt_reduced"] * run.builder.time_unit_ps(run.cfg)


def sync(device):
    import torch
    if str(device).split(":")[0] == "cuda":
        torch.cuda.synchronize()


def program_integrator(pt, traffic, dt):
    if traffic["integrator"] == "velocity_verlet":
        return pt.VelocityVerlet(dt=dt, remove_cm=False)
    raise ValueError(f"unknown integrator {traffic['integrator']!r}")


def reference_integrate(run, model, x, v, n_steps):
    from reference.integrate import INTEGRATORS
    return INTEGRATORS[run.traffic["integrator"]](model, x, v, n_steps,
                                                  dt_ps(run))


def run(run):
    if run.control:
        return _run_control(run)
    import mollytpu_torch as pt
    t = run.traffic
    dt, chunk = dt_ps(run), t["chunk_steps"]
    t_import = time.perf_counter() - run.t_start
    system, inputs = run.builder.build(run.cfg, run.seed, run.device)
    t_built = time.perf_counter() - run.t_start
    sim = program_integrator(pt, t, dt)
    nb = pt.find_neighbors(system.neighbor_finder, system.coords,
                           system.boundary, system.exclusions, 0)
    aux = sim.init_aux(system, nb)
    start = run.builder.program_start(system, nb, aux)
    sync(run.device)
    t_first = time.perf_counter() - run.t_start
    system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, 0,
                                      t["warmup_steps"])
    sync(run.device)
    setup_s = time.perf_counter() - run.t_start

    step, chunks, ends = t["warmup_steps"], 0, []
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        last = {"x": system.coords, "v": system.velocities, "step": step}
        system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, step, chunk)
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
               "step": step, "pt": pt}
    run.check_inputs = {"inputs": inputs, "start": start, "last": last,
                        "end_x": system.coords, "end_f": aux["forces"]}
    temp = float(pt.temperature(system.masses, system.velocities,
                                system.n_dof))
    per = sorted(1e3 * (b - a) / chunk for a, b in zip([t0] + ends, ends))
    print(f"md: set-up {setup_s:.3f} s (imports done {t_import:.3f}, "
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
    window's entry; the end state the other readers use is left as is."""
    e, t = run.end, run.traffic
    pt, system, nb, aux, step = e["pt"], e["system"], e["nb"], e["aux"], \
        e["step"]
    for _ in range(t["trace_chunks"]):
        system, nb, aux, _ = pt.run_chunk(e["sim"], system, nb, aux, step,
                                          t["chunk_steps"])
        step += t["chunk_steps"]


def _run_control(run):
    """The reference in TF32 in the program's place."""
    from reference.precision import TF32
    t = run.traffic
    chunk = t["chunk_steps"]
    system, inputs = run.builder.build(run.cfg, run.seed, run.device)
    model = run.builder.reference(run.cfg, inputs, TF32, run.device)
    x = model.start
    v = system.velocities.to(model.prec.dtype)
    del system
    start = run.builder.control_start(model)
    t0 = time.perf_counter()
    x, v = reference_integrate(run, model, x, v, t["warmup_steps"])
    last = None
    for _ in range(t["control_chunks"]):
        last = {"x": x, "v": v}
        x, v = reference_integrate(run, model, x, v, chunk)
    sync(run.device)
    run.window = {"steps": t["control_chunks"] * chunk,
                  "seconds": time.perf_counter() - t0,
                  "chunks": t["control_chunks"], "dt_ps": dt_ps(run),
                  "setup_s": 0.0}
    run.check_inputs = {"inputs": inputs, "start": start, "last": last,
                        "end_x": x, "end_f": model.forces(x)}


def check(run):
    """The numbers compared with the cell's limits (see the module's
    docstring), worked out once the program's state is freed."""
    import torch
    from checks import force_gap, position_gap
    from reference.precision import F64
    ci = run.check_inputs
    run.end.clear()
    gc.collect()
    if str(run.device).split(":")[0] == "cuda":
        torch.cuda.empty_cache()
    ref = run.builder.reference(run.cfg, ci["inputs"], F64, run.device)
    out = run.builder.start_checks(ref, ci["start"])
    out["f_end"] = force_gap(ci["end_f"], ref.forces(ci["end_x"]))
    last = ci["last"]
    x_ref, _ = reference_integrate(run, ref, last["x"], last["v"],
                                    run.traffic["chunk_steps"])
    out["x_chunk"] = position_gap(ci["end_x"], x_ref, ref.mic)
    return out
