"""Replica ensembles on one card (counterpart of
mollytpu/parallel/replicas.py:33-137).

The JAX package vmaps the per-replica MD over a stacked replica axis and
shards that axis over a device mesh. Here the replicas' (R, N, 3)
coordinates and velocities stay stacked tensors on the card, and the plain
form of the vmap is a loop over replicas, each with its own list, aux and
generator. The multi-device mesh (``replica_mesh``, ``shard_ensemble``) is
not ported: ``mesh=`` other than None raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.neighbors import find_neighbors
from ..sim.simulate import run_chunk
from ..spatial import kinetic_energy


@dataclasses.dataclass(frozen=True)
class ReplicaEnsemble:
    """R replicas of one System template: coordinates and velocities
    stacked on a leading replica axis, (R, N, 3) each."""

    template: object
    coords: torch.Tensor
    velocities: torch.Tensor

    @property
    def n_replicas(self):
        return self.coords.shape[0]

    def replica(self, i):
        return self.template.update(coords=self.coords[i],
                                    velocities=self.velocities[i])


def refuse_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mollytpu_torch runs replicas on one card; the multi-device "
            "replica mesh is not ported (pass mesh=None)")


def make_ensemble(sys, n_replicas, generator=None, jitter=0.0, noise=None):
    """Stack a System into an ensemble, the coordinates jittered by
    ``jitter`` (nm) times standard normals when jitter > 0 and either
    ``generator`` or ``noise`` (an injected (R, N, 3) tensor of the
    normals) is given."""
    shape = (n_replicas,) + tuple(sys.coords.shape)
    coords = sys.coords.expand(shape).clone()
    vels = sys.velocities.expand(shape).clone()
    if jitter > 0 and (generator is not None or noise is not None):
        if noise is None:
            noise = torch.randn(shape, generator=generator,
                                dtype=coords.dtype, device=coords.device)
        coords = coords + jitter * noise.to(coords)
    return ReplicaEnsemble(template=sys, coords=coords, velocities=vels)


def replica_generators(generator, n_replicas, device):
    """One generator per replica on ``device``, seeded from ``generator``
    (a fresh default-seeded one when None)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    seeds = torch.randint(0, 2 ** 62, (n_replicas,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def run_replica(simulator, template, coords, vels, n_steps, generator=None,
                noise=None, needs_virial=False):
    """One replica's segment, as the JAX package's scan runs it: a fresh
    list and aux at the segment's step 0, then ``n_steps`` steps with the
    list rebuilt at the finder's cadence (sim.simulate.run_chunk, which
    raises on a stale list). ``noise`` is an optional step_n -> the step's
    normals. Returns (sys, neighbors)."""
    sys = template.update(coords=coords, velocities=vels)
    nbs = find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                         sys.exclusions, 0)
    aux = simulator.init_aux(sys, nbs, needs_virial=needs_virial)
    sys, nbs, _, _ = run_chunk(
        simulator, sys, nbs, aux, 0, n_steps, generator=generator,
        noise=noise, virial_at=lambda step_n: needs_virial)
    return sys, nbs


def make_ensemble_step(simulator, template, n_inner_steps=1,
                       needs_virial=False):
    """The ensemble step: every replica advances n_inner_steps from a fresh
    list. Returns step(coords (R, N, 3), vels (R, N, 3), generators (R of
    them), noise=None) -> (coords, vels, (R,) kinetic energies); ``noise``
    is an optional (replica, step_n) -> that step's normals."""

    def step(coords, vels, generators, noise=None):
        out = []
        for r in range(coords.shape[0]):
            rnoise = None if noise is None else (
                lambda step_n, r=r: noise(r, step_n))
            sys, _ = run_replica(simulator, template, coords[r], vels[r],
                                 n_inner_steps, generators[r], rnoise,
                                 needs_virial)
            out.append((sys.coords, sys.velocities,
                        kinetic_energy(sys.masses, sys.velocities)))
        new_c, new_v, kes = zip(*out)
        return torch.stack(new_c), torch.stack(new_v), torch.stack(kes)

    return step


def simulate_ensemble(sys, simulator, n_replicas, n_steps, generator=None,
                      mesh=None, chunk=10, noise=None):
    """Advance n_replicas copies of ``sys`` in chunks of ``chunk`` steps
    (rounded up to whole chunks, as the JAX package does), each chunk from
    a fresh list, each replica on its own generator seeded from
    ``generator``. ``noise`` is an optional (chunk index, replica, step_n)
    -> normals. Returns the final ReplicaEnsemble."""
    refuse_mesh(mesh)
    ens = make_ensemble(sys, n_replicas)
    gens = replica_generators(generator, n_replicas, sys.device)
    step = make_ensemble_step(simulator, ens.template, n_inner_steps=chunk)
    coords, vels = ens.coords, ens.velocities
    done = c = 0
    while done < n_steps:
        cnoise = None if noise is None else (
            lambda r, step_n, c=c: noise(c, r, step_n))
        coords, vels, _ = step(coords, vels, gens, cnoise)
        done += chunk
        c += 1
    return ReplicaEnsemble(template=ens.template, coords=coords,
                           velocities=vels)
