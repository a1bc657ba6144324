"""Make spc1000.gro, the equilibrated periodic box of SPC water beside this
script, with the port.

    python mollytpu_torch/data/make_spc_tile.py --seed 20261018 \
        --out mollytpu_torch/data/spc1000.gro [--device cuda]

From a simple cubic lattice of ``--waters`` SPC waters (a cube number) at
``--density`` molecules/nm^3, all in one orientation, built with
``system_from_gromacs`` on the pair kernel's path (PME by GROMACS's rules,
SETTLE-rigid water by SHAKE / RATTLE, no dispersion correction) and
started by ``gen_vel_start`` from the seed at ``--temperature``: leap-frog
at ``--dt`` ps with the v-rescale thermostat (tau 0.1 ps) for
``--melt-ps`` ps at the lattice's volume, then ``--npt-ps`` ps with the
Monte Carlo barostat at 1 bar added (a move every 25 steps), then
``--nvt-ps`` ps at the volume the barostat left. Writes the last frame
with each water whole (its hydrogens at the oxygen's minimum image), and
prints one JSON line: the density at the end, the mean and spread of the
volume over each quarter of the NPT stretch (it has settled when the last
quarters agree), and the temperature at the end.

The same seed gives the same tile on the CPU; on the card the sums of the
pair kernel and of PME's charge spreading are not bitwise reproducible, so
a rerun there gives another tile of the same density.
"""

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import mollytpu_torch as pt  # noqa: E402
from mollytpu_torch.models import gromacs, waterbox  # noqa: E402
from mollytpu_torch.units import BAR  # noqa: E402

#: molar mass of a water (u), for the density
SPC_MASS = 15.9994 + 2 * 1.008


def lattice(n_waters, density):
    """(coordinates (3 n_waters, 3) nm, the cube's edge): waters on a
    simple cubic lattice, H1 along +x and H2 at SPC's 109.47 degrees in
    the xy plane."""
    m = round(n_waters ** (1.0 / 3.0))
    if m ** 3 != n_waters:
        raise ValueError(f"--waters {n_waters} is not a cube number")
    edge = (n_waters / density) ** (1.0 / 3.0)
    a = edge / m
    theta = 2.0 * math.asin(0.5 * waterbox.SPC_DHH / waterbox.SPC_DOH)
    h1 = np.array([waterbox.SPC_DOH, 0.0, 0.0])
    h2 = waterbox.SPC_DOH * np.array([math.cos(theta), math.sin(theta), 0.0])
    sites = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 1, 3) * a + 0.25 * a
    return (sites + np.stack([np.zeros(3), h1, h2])[None]).reshape(-1, 3), \
        edge


def whole(coords, edge):
    """Each water's hydrogens moved to the oxygen's minimum image."""
    x = coords.reshape(-1, 3, 3)
    d = x - x[:, :1]
    return (x[:, :1] + d - edge * np.round(d / edge)).reshape(-1, 3)


def build(coords, edge, args, work):
    gro = waterbox.write_gro(os.path.join(work, "start.gro"), coords,
                             [edge] * 3)
    top = waterbox.spc_topology(os.path.join(work, "spc.top"),
                                coords.shape[0] // 3)
    return pt.system_from_gromacs(
        gro, top, nonbonded_method="pme", dist_cutoff=args.cutoff,
        dist_neighbors=args.rlist, neighbor_n_steps=10, device=args.device,
        use_settles=True, dispersion_correction=False,
        velocities_from_gro=False, neighbor_finder="block", ewald_rtol=1e-5,
        fourier_spacing=0.12, pme_order=4)


def run(sys_, couplers, n_steps, args, gen, chunk=50, on_chunk=None):
    sim = pt.Verlet(dt=args.dt, coupling=couplers, remove_cm=False)
    nb = pt.find_neighbors(sys_.neighbor_finder, sys_.coords, sys_.boundary,
                           sys_.exclusions, 0)
    aux = sim.init_aux(sys_, nb)
    for step in range(0, n_steps, chunk):
        sys_, nb, aux, _ = pt.run_chunk(sim, sys_, nb, aux, step,
                                        min(chunk, n_steps - step),
                                        generator=gen)
        sys_, nb = pt.npt_resetup(sim, sys_, nb, step + chunk)
        if on_chunk is not None:
            on_chunk(sys_)
    return sys_


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--waters", type=int, default=1000)
    p.add_argument("--density", type=float, default=33.0)
    p.add_argument("--temperature", type=float, default=300.0)
    p.add_argument("--dt", type=float, default=0.002)
    p.add_argument("--melt-ps", type=float, default=10.0)
    p.add_argument("--npt-ps", type=float, default=50.0)
    p.add_argument("--nvt-ps", type=float, default=10.0)
    p.add_argument("--cutoff", type=float, default=1.0)
    p.add_argument("--rlist", type=float, default=1.2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    steps = {k: int(round(getattr(args, k) / args.dt))
             for k in ("melt_ps", "npt_ps", "nvt_ps")}
    coords, edge = lattice(args.waters, args.density)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    thermo = pt.VelocityRescaleThermostat(args.temperature, 0.1)
    with tempfile.TemporaryDirectory() as work:
        sys_ = gromacs.gen_vel_start(build(coords, edge, args, work),
                                     args.temperature, gen)
        sys_ = run(sys_, (thermo,), steps["melt_ps"], args, gen)
        volumes = []
        sys_ = run(sys_, (thermo, pt.MonteCarloBarostat(
            BAR, args.temperature, n_steps=25)), steps["npt_ps"], args, gen,
            on_chunk=lambda s: volumes.append(float(s.boundary.volume())))
        sys_ = run(sys_, (thermo,), steps["nvt_ps"], args, gen)
    edge = float(sys_.boundary.volume()) ** (1.0 / 3.0)
    x = whole(sys_.coords.detach().cpu().double().numpy(), edge)
    waterbox.write_gro(args.out, x, [edge] * 3,
                       title=f"SPC water, {args.waters} molecules, "
                       f"{args.temperature:g} K 1 bar, seed {args.seed}")
    quarters = np.array_split(np.asarray(volumes), 4)
    temp = float(pt.temperature(sys_.masses, sys_.velocities, sys_.n_dof))
    print(json.dumps({
        "waters": args.waters, "seed": args.seed, "edge_nm": edge,
        "density_kg_m3": args.waters * SPC_MASS * 1.66053906660 / edge ** 3,
        "molecules_per_nm3": args.waters / edge ** 3,
        "npt_volume_quarters_nm3": [[float(q.mean()), float(q.std())]
                                    for q in quarters if q.size],
        "temperature_end_k": temp, "steps": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
