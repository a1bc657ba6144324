"""pair_kernel_roofline_pct.fep: the fep cell's pair call on K1c (one call
of the pairwise interactions alone, as ``.water``'s) against the least
time of this Hamiltonian's physics count: the water count, with the
solute's pairs at the soft-core path's operations
(roofline/softcore.least_time_s) (timesteps_per_s)."""


def read(run):
    from readers import pair_system
    from reference.precision import F64
    from roofline.softcore import least_time_s
    pt, s, nb = run.end["pt"], run.end["system"], run.end["nb"]
    roof = run.cfg["roofline"]

    def count():
        ref = run.builder.reference(run.cfg, run.check_inputs["inputs"],
                                    F64, run.device)
        return ref.pair_count(s.coords), ref.solute_pair_count(s.coords)
    (pairs, lj_pairs), (soft, soft_lj) = run.once("fep_pairs", count)
    least, _, _, _, _ = least_time_s(
        pairs, lj_pairs, soft, soft_lj, s.n_atoms, roof["coulomb"],
        roof["lj"], roof["input_bytes_per_atom"]
        + roof["lambda_bytes_per_atom"])
    only = pair_system(run)
    device_s = run.device_s_per_call(
        "pair", lambda: pt.forces_virial(only, nb))
    return 100.0 * least / device_s
