"""What the per-layer metric readers share: each reads one quantity from
the run's trace, from the host's clock around many calls of one layer on
the window's end state, or from the physics count, and returns None where
the system has no such layer."""

from __future__ import annotations


def idle_pct(run):
    """The share of a step's time in which nothing runs on the device: the
    traced stretch's device busy time per step over the (unprofiled)
    window's time per step."""
    tr, w = run.trace(), run.window
    busy_per_step = tr.busy_s / tr.steps
    return 100.0 * (1.0 - busy_per_step / (w["seconds"] / w["steps"]))


def launches_per_step(run):
    tr = run.trace()
    return tr.launches / tr.steps


def pair_system(run):
    """The end state with only its pairwise interactions: forces_virial of
    it is the short-range pair call and nothing else."""
    s = run.end["system"]
    return s.update(general_inters=(), specific_lists=())


def nonbonded_roofline_pct(run):
    """The least time the physics count of the pair work needs, over the
    device time of the kernels one short-range pair call launches."""
    from reference.precision import F64
    from roofline.ops import least_time_s
    pt, s, nb = run.end["pt"], run.end["system"], run.end["nb"]
    roof = run.cfg["roofline"]
    pairs, lj_pairs = run.once("pairs", lambda: run.builder.reference(
        run.cfg, run.check_inputs["inputs"], F64, run.device
    ).pair_count(s.coords))
    least, _, _, _, _ = least_time_s(pairs, lj_pairs, s.n_atoms,
                                     roof["coulomb"], roof["lj"],
                                     roof["input_bytes_per_atom"])
    only = pair_system(run)
    device_s = run.device_s_per_call(
        "pair", lambda: pt.forces_virial(only, nb))
    return 100.0 * least / device_s


def rebuild_ms(run):
    """A rebuild as the loop makes it: the new list, and the stale-list
    check of the last evaluation on the old one."""
    from mollytpu_torch.sim import simulate
    check = getattr(simulate, "list_check", None)
    cutoff = getattr(simulate, "list_cutoff", None)
    pt, s, nb = run.end["pt"], run.end["system"], run.end["nb"]
    if check is None or cutoff is None or s.neighbor_finder is None:
        return None
    rc = cutoff(s)

    def rebuild():
        new = pt.find_neighbors(s.neighbor_finder, s.coords, s.boundary,
                                s.exclusions, run.end["step"])
        check(s, nb, rc, new)
    return run.host_ms("rebuild", rebuild)
