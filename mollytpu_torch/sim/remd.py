"""Replica-exchange molecular dynamics (counterpart of
mollytpu/sim/remd.py:31-264).

Temperature REMD (ReplicaExchangeMD) and Hamiltonian REMD over a lambda
ladder (HamiltonianReplicaExchangeMD). A cycle runs every replica's MD
segment from a fresh list, each on its device of the replica mesh
(parallel/replicas.py run_segments; the JAX package vmaps them over its
sharded replica axis), then one exchange sweep on the mesh's first
device: alternating-parity neighbour pairs, one uniform per pair taken
from the lower slot, Metropolis on Delta, and states swapped between slots
by a gather. T-REMD rescales the velocities by sqrt(T_i / T_j) when state
j moves into slot i; H-REMD does not rescale. Without a mesh, a system on
a card is sharded over gcd(cards, replicas) cards when that exceeds 1, as
the JAX package does over its devices.

The acceptance test runs in float64 whatever the system's dtype (the JAX
package runs it in the energies' dtype), so that it is reproducible from
the energies and uniforms alone. Each cycle reads its acceptance count on
the host once, as the JAX package does. The uniforms come from the
caller's generator, or are injected (``uniforms``), as is the Langevin
noise (``noise``), so that a test replays the JAX package's keys.
"""

from __future__ import annotations

import dataclasses

import torch

from ..forces import potential_energy
from ..ops.neighbors import find_neighbors
from ..parallel.replicas import (ReplicaEnsemble, make_ensemble,
                                 mesh_size_for, placed, replica_generators,
                                 replica_mesh, run_segments)
from ..units import KB


def _ladder(values):
    """A ladder (sequence or tensor) as a tuple of Python floats."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().tolist()
    return tuple(float(v) for v in values)


def exchange_pairs(n_replicas, cycle_n):
    """The partner of each slot in this cycle's sweep, (0, 1), (2, 3), ...
    on even cycles and (1, 2), (3, 4), ... on odd ones, as host lists:
    (partner clipped into the ladder, is the lower slot, has a partner)."""
    parity = cycle_n % 2
    partner, lower, valid = [], [], []
    for i in range(n_replicas):
        lo = i % 2 == parity
        p = i + 1 if lo else i - 1
        valid.append(0 <= p < n_replicas)
        lower.append(lo)
        partner.append(min(max(p, 0), n_replicas - 1))
    return partner, lower, valid


def metropolis_swaps(delta, u, partner, lower, valid):
    """(slot permutation (R,) int64, accepted pairs) on the device: a pair
    swaps when its lower slot's uniform u < exp(min(-Delta, 0))."""
    dev = delta.device
    idx = torch.arange(len(partner), device=dev)
    part = torch.as_tensor(partner, device=dev)
    is_lower = torch.as_tensor(lower, device=dev)
    ok = torch.as_tensor(valid, device=dev)
    u = u.to(device=dev, dtype=torch.float64)
    u_pair = torch.where(is_lower, u, u[part])
    accept = ok & (u_pair < torch.exp(torch.clamp(-delta, max=0.0)))
    return torch.where(accept, part, idx), (accept & is_lower).sum()


def _uniforms(uniforms, generator, cycle_n, r, device):
    if uniforms is not None:
        return uniforms(cycle_n)
    return torch.rand((r,), generator=generator, dtype=torch.float64,
                      device=generator.device).to(device)


def _start(sys, r, generator, jitter, jitter_noise, mesh):
    """(ensemble, the template on the device the exchange runs on, each
    replica as a System on its device, one generator per replica, the
    exchange's generator: the caller's, or a fresh one seeded 0)."""
    if mesh is None and sys.device.type == "cuda":
        n_dev = mesh_size_for(torch.cuda.device_count(), r)
        if n_dev is not None:
            mesh = replica_mesh(n_dev)
    if generator is None:
        generator = torch.Generator(device=sys.device).manual_seed(0)
    ens = make_ensemble(sys, r, generator=generator, jitter=jitter,
                        noise=jitter_noise)
    template, reps = placed(ens, mesh)
    gens = replica_generators(generator, [s.device for s in reps])
    return ens, template, reps, gens, generator


def _injected(noise, cycle_n, i):
    return None if noise is None else (
        lambda step_n: noise(cycle_n, i, step_n))


def _gathered(out, home):
    """The segments' (R, N, 3) coordinates and velocities on ``home``."""
    return (torch.stack([s.coords.to(home) for s, _ in out]),
            torch.stack([s.velocities.to(home) for s, _ in out]))


@dataclasses.dataclass(frozen=True)
class ReplicaExchangeMD:
    """T-REMD. ``simulator`` is a template integrator with a
    ``temperature`` field, replaced per replica by its rung's."""

    temperatures: object              # (R,) ladder, K
    simulator: object
    cycle_length: int = 100

    @property
    def n_replicas(self):
        return len(_ladder(self.temperatures))

    def exchange(self, coords, vels, pes, cycle_n, u):
        """The alternating-parity sweep on (R,) energies ``pes`` with the
        (R,) uniforms ``u``: permuted (coords, vels) and the accepted
        pairs (a device scalar)."""
        temps = _ladder(self.temperatures)
        partner, lower, valid = exchange_pairs(len(temps), cycle_n)
        t = torch.as_tensor(temps, dtype=torch.float64, device=pes.device)
        betas = 1.0 / (KB * t)
        e = pes.to(torch.float64)
        delta = (betas - betas[partner]) * (e[partner] - e)
        perm, n_acc = metropolis_swaps(delta, u, partner, lower, valid)
        scale = torch.sqrt(t / t[perm]).to(vels.dtype)
        return coords[perm], vels[perm] * scale[:, None, None], n_acc

    def simulate(self, sys, n_cycles, generator=None, mesh=None, jitter=0.0,
                 noise=None, uniforms=None, jitter_noise=None):
        """Run T-REMD; returns (ReplicaEnsemble, {"exchange_rate", "pes"
        (cycles, R) on the device}). ``noise`` is an optional (cycle,
        replica, step_n) -> Langevin normals, ``uniforms`` an optional
        cycle -> (R,) uniforms, ``jitter_noise`` the (R, N, 3) normals of
        the start's jitter."""
        temps = _ladder(self.temperatures)
        r = len(temps)
        ens, template, reps, gens, generator = _start(
            sys, r, generator, jitter, jitter_noise, mesh)
        home = template.device
        coords, vels = ens.coords.to(home), ens.velocities.to(home)
        total_acc, pes_hist = 0, []
        for c in range(n_cycles):
            out = run_segments([(
                dataclasses.replace(self.simulator, temperature=temps[i]),
                reps[i], coords[i].to(reps[i].device),
                vels[i].to(reps[i].device), gens[i], _injected(noise, c, i))
                for i in range(r)], self.cycle_length)
            pes = torch.stack([potential_energy(s, nb).to(home)
                               for s, nb in out])
            coords, vels = _gathered(out, home)
            u = _uniforms(uniforms, generator, c, r, home)
            coords, vels, n_acc = self.exchange(coords, vels, pes, c, u)
            total_acc += int(n_acc)
            pes_hist.append(pes)
        n_attempts = n_cycles * (r // 2)
        return ReplicaEnsemble(template=template, coords=coords,
                               velocities=vels), {
            "exchange_rate": total_acc / max(n_attempts, 1),
            "pes": torch.stack(pes_hist) if pes_hist else None}


@dataclasses.dataclass(frozen=True)
class HamiltonianReplicaExchangeMD:
    """H-REMD: replicas share the simulator's temperature and run at the
    lambdas of a ladder (on the atoms of ``atom_mask``, or all), and
    exchange on the cross energies Delta = beta [U_i(x_j) + U_j(x_i) -
    U_i(x_i) - U_j(x_j)]. Each energy is taken on a list rebuilt for it.
    No velocity rescale."""

    lambdas: object                   # (R,) ladder
    simulator: object
    cycle_length: int = 100
    atom_mask: torch.Tensor = None

    @property
    def n_replicas(self):
        return len(_ladder(self.lambdas))

    def _with_lambda(self, template, coords, lam):
        from ..free_energy.thermo import set_lambda
        return set_lambda(template.update(coords=coords), lam, self.atom_mask)

    def _energy(self, template, coords, lam):
        sys = self._with_lambda(template, coords, lam)
        nbs = find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                             sys.exclusions, 0)
        return potential_energy(sys, nbs)

    def energies(self, template, coords, partner, replicas=None):
        """(U_i(x_i), U_i(x_partner(i))) for every slot i, each (R,) on
        the coordinates' device; slot i's on its replica's device when
        ``replicas`` (one System per slot) is given."""
        lams = _ladder(self.lambdas)
        home = coords.device
        replicas = replicas or [template] * len(lams)

        def energy(i, j):
            dev = replicas[i].device
            return self._energy(replicas[i], coords[j].to(dev),
                                lams[i]).to(home)

        e_self = torch.stack([energy(i, i) for i in range(len(lams))])
        e_cross = torch.stack([energy(i, partner[i])
                               for i in range(len(lams))])
        return e_self, e_cross

    def exchange(self, template, coords, vels, cycle_n, u, replicas=None):
        """The sweep on the cross energies (``replicas`` as in
        ``energies``): permuted (coords, vels), the self energies (R,)
        and the accepted pairs (a device scalar)."""
        temp = getattr(self.simulator, "temperature", 300.0)
        beta = 1.0 / (KB * temp)
        partner, lower, valid = exchange_pairs(self.n_replicas, cycle_n)
        e_self, e_cross = self.energies(template, coords, partner, replicas)
        es, ec = e_self.to(torch.float64), e_cross.to(torch.float64)
        delta = beta * (ec + ec[partner] - es - es[partner])
        perm, n_acc = metropolis_swaps(delta, u, partner, lower, valid)
        return coords[perm], vels[perm], e_self, n_acc

    def simulate(self, sys, n_cycles, generator=None, mesh=None, jitter=0.0,
                 noise=None, uniforms=None, jitter_noise=None):
        """Run H-REMD. Returns (ReplicaEnsemble, {"exchange_rate",
        "energies": the (cycles, R) self energies on the device}), the
        injection points as in ReplicaExchangeMD.simulate."""
        lams = _ladder(self.lambdas)
        r = len(lams)
        ens, template, reps, gens, generator = _start(
            sys, r, generator, jitter, jitter_noise, mesh)
        home = template.device
        coords, vels = ens.coords.to(home), ens.velocities.to(home)
        total_acc, e_hist = 0, []
        for c in range(n_cycles):
            out = run_segments([(
                self.simulator,
                self._with_lambda(reps[i], coords[i].to(reps[i].device),
                                  lams[i]),
                coords[i].to(reps[i].device), vels[i].to(reps[i].device),
                gens[i], _injected(noise, c, i)) for i in range(r)],
                self.cycle_length)
            coords, vels = _gathered(out, home)
            u = _uniforms(uniforms, generator, c, r, home)
            coords, vels, e_self, n_acc = self.exchange(
                template, coords, vels, c, u, reps)
            total_acc += int(n_acc)
            e_hist.append(e_self)
        n_attempts = n_cycles * (r // 2)
        return ReplicaEnsemble(template=template, coords=coords,
                               velocities=vels), {
            "exchange_rate": total_acc / max(n_attempts, 1),
            "energies": torch.stack(e_hist) if e_hist else None}
