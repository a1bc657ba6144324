"""GROMACS's water benchmark as the port builds it: the committed SPC tile
laid out ``tiles_per_side`` times along each edge
(``waterbox.tile_gro``), read by ``system_from_gromacs`` on the pair
kernel's path (the cluster-pair list, PME by GROMACS's rules, rigid waters
by SHAKE / RATTLE, no dispersion correction), and started by
``gen_vel_start`` from the seed at ``gen_temp`` (gen-vel = yes,
continuation = no). Its plain reference is ``reference/spc_water.py``,
which lays out the same tile itself."""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def build(cfg, seed, device, work):
    import torch
    from mollytpu_torch.models import gromacs, waterbox
    w, mdp, nb = cfg["water"], cfg["mdp"], cfg["neighbors"]
    gro = waterbox.tile_gro(gromacs.read_gro(os.path.join(REPO, w["tile"])),
                            w["tiles_per_side"])
    top = waterbox.spc_topology(os.path.join(work, "spc.top"),
                                len(gro[0]) // 3)
    system = gromacs.system_from_gromacs(
        gro, top, nonbonded_method="pme", dist_cutoff=mdp["rcoulomb"],
        dist_neighbors=nb["radius_nm"], neighbor_n_steps=nb["rebuild_every"],
        device=device, use_settles=True, dispersion_correction=False,
        velocities_from_gro=False, neighbor_finder=nb["finder"],
        ewald_rtol=mdp["ewald_rtol"], fourier_spacing=mdp["fourierspacing"],
        pme_order=mdp["pme_order"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return gromacs.gen_vel_start(system, mdp["gen_temp"], gen), {}


def reference(cfg, inputs, prec, device):
    from reference.spc_water import SPCWater
    return SPCWater(cfg, prec, device)
