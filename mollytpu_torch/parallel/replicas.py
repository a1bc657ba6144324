"""Replica ensembles over a mesh of devices (counterpart of
mollytpu/parallel/replicas.py:26-137).

The JAX package vmaps the per-replica MD over a stacked replica axis and
shards that axis over a ``jax.sharding.Mesh``. Here a ``ReplicaMesh`` is
an ordered tuple of devices along one named axis (``replica_mesh``: the
first n CUDA devices), and ``shard_ensemble`` lays an ensemble out on it
as ``NamedSharding(mesh, P(axis))`` does: contiguous blocks of replicas,
one per device, the template copied to each. Each replica runs its own
segment on its device, with its own list, aux and generator
(``run_segments``): the replicas' steps are enqueued in turn, one step of
each, and their stale-list checks are read on the host only after every
replica's last step is enqueued, so that the devices run side by side.
Results are gathered on the mesh's first device. On one device, or on
the CPU, the mesh changes no number: each replica runs the same
operations in the same order wherever it is placed.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.neighbors import find_neighbors
from ..sim.simulate import chunk_steps, finish_chunk
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


@dataclasses.dataclass(frozen=True)
class ReplicaMesh:
    """The port's device mesh: devices in order along the named axis (a
    JAX Mesh of one axis). Any devices may be given, so that a test builds
    one of several CPU entries."""

    devices: tuple
    axis_names: tuple = ("replicas",)

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        # "cuda" is the current card: the index a tensor there reports
        object.__setattr__(self, "devices", tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d
            for d in devices))
        if not self.devices:
            raise ValueError("a replica mesh needs at least one device")


def replica_mesh(n_devices=None, axis_name="replicas"):
    """The mesh of the first ``n_devices`` CUDA devices (all of them when
    None)."""
    if not torch.cuda.is_available():
        raise RuntimeError("replica_mesh: no CUDA device; build a "
                           "ReplicaMesh of explicit devices instead")
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"replica_mesh: {n} devices asked, {count} present")
    return ReplicaMesh(tuple(torch.device("cuda", i) for i in range(n)),
                       (axis_name,))


def mesh_size_for(n_devices, n_replicas):
    """The REMD drivers' mesh when none is given
    (mollytpu/sim/remd.py:98-104): gcd(devices, replicas) devices when
    there is more than one device and the gcd exceeds 1, else None."""
    if n_devices <= 1:
        return None
    n = math.gcd(n_devices, n_replicas)
    return n if n > 1 else None


def _check_mesh(mesh, axis_name, n_replicas):
    if not isinstance(mesh, ReplicaMesh):
        raise TypeError(f"mesh must be a ReplicaMesh (replica_mesh()), not "
                        f"{type(mesh).__name__}")
    if axis_name not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis_name!r} "
                         f"(axes {mesh.axis_names})")
    d = len(mesh.devices)
    if n_replicas % d:
        raise ValueError(f"{n_replicas} replicas do not split evenly over "
                         f"{d} devices")


def to_device(obj, device):
    """``obj`` with every tensor it holds on ``device``: tensors, tuples,
    lists, and dataclasses field by field (those with their own ``to``,
    boxes, Atoms and bonded lists, through it); anything else as it
    is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(x, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if callable(getattr(obj, "to", None)):
            return obj.to(device=device)
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


@dataclasses.dataclass(frozen=True)
class ShardedEnsemble:
    """An ensemble laid out over a mesh: per mesh device its copy of the
    template and its contiguous block of replicas. ``coords``,
    ``velocities`` and ``replica`` read it as a ReplicaEnsemble is read
    (the blocks gathered on the mesh's first device)."""

    mesh: ReplicaMesh
    templates: tuple        # one System per mesh device
    coord_blocks: tuple     # (R / D, N, 3) per mesh device
    velocity_blocks: tuple

    @property
    def template(self):
        return self.templates[0]

    @property
    def n_replicas(self):
        return sum(b.shape[0] for b in self.coord_blocks)

    @property
    def coords(self):
        return torch.cat([b.to(self.mesh.devices[0])
                          for b in self.coord_blocks])

    @property
    def velocities(self):
        return torch.cat([b.to(self.mesh.devices[0])
                          for b in self.velocity_blocks])

    def replica(self, i):
        per = self.coord_blocks[0].shape[0]
        d, k = divmod(i, per)
        return self.templates[d].update(coords=self.coord_blocks[d][k],
                                        velocities=self.velocity_blocks[d][k])


def shard_ensemble(ens, mesh, axis_name="replicas"):
    """Place the replica axis over the mesh (the template copied to each
    device; mollytpu/parallel/replicas.py:71-78). Raises TypeError for an
    object that is not a ReplicaMesh and ValueError when the replica count
    does not split evenly over the devices."""
    _check_mesh(mesh, axis_name, ens.n_replicas)
    per = ens.n_replicas // len(mesh.devices)
    return ShardedEnsemble(
        mesh=mesh,
        templates=tuple(to_device(ens.template, d) for d in mesh.devices),
        coord_blocks=tuple(ens.coords[k * per:(k + 1) * per].to(d)
                           for k, d in enumerate(mesh.devices)),
        velocity_blocks=tuple(ens.velocities[k * per:(k + 1) * per].to(d)
                              for k, d in enumerate(mesh.devices)))


def placed(ens, mesh=None, axis_name="replicas"):
    """(the template on the device the results gather on, each replica as
    a System on its device: the template's copy there with the replica's
    coordinates and velocities). Without a mesh everything stays on the
    template's device; with one, the results gather on its first
    device."""
    if mesh is not None:
        ens = shard_ensemble(ens, mesh, axis_name)
    return ens.template, [ens.replica(i) for i in range(ens.n_replicas)]


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


def replica_generators(generator, devices):
    """One generator per replica, on its device (``devices``, one per
    replica), seeded from ``generator`` (a fresh default-seeded one on the
    first replica's device when None): the same seeds wherever the
    replicas run."""
    if generator is None:
        generator = torch.Generator(device=devices[0]).manual_seed(0)
    seeds = torch.randint(0, 2 ** 62, (len(devices),), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=d).manual_seed(s)
            for d, s in zip(devices, seeds)]


def run_segments(jobs, n_steps, needs_virial=False):
    """Each replica's segment, as the JAX package's scan runs it: a fresh
    list and aux at the segment's step 0 on the job's template, then
    ``n_steps`` steps with the list rebuilt at the finder's cadence
    (sim.simulate.chunk_steps). ``jobs`` holds one (simulator, template,
    coords, velocities, generator, noise) per replica, ``noise`` an
    optional step_n -> the step's normals. The replicas' steps interleave,
    one step of each in turn; each replica's stale-list and overflow
    checks are read after every replica's last step is enqueued (and
    raise, as run_chunk's). Returns [(sys, neighbors)] per replica."""
    started = []
    for sim, template, coords, vels, gen, noise in jobs:
        sys = template.update(coords=coords, velocities=vels)
        nbs = find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                             sys.exclusions, 0)
        aux = sim.init_aux(sys, nbs, needs_virial=needs_virial)
        started.append((sys, chunk_steps(
            sim, sys, nbs, aux, 0, n_steps, generator=gen, noise=noise,
            virial_at=lambda step_n: needs_virial)))
    done = [None] * len(started)
    pending = list(range(len(started)))
    while pending:
        for i in list(pending):
            try:
                next(started[i][1])
            except StopIteration as stop:
                done[i] = stop.value
                pending.remove(i)
    return [finish_chunk(sys, out, n_steps)[:2]
            for (sys, _), out in zip(started, done)]


def make_ensemble_step(simulator, template, n_inner_steps=1,
                       needs_virial=False):
    """The ensemble step: every replica advances n_inner_steps from a fresh
    list on the template's device. Returns step(coords (R, N, 3), vels
    (R, N, 3), generators (R of them), noise=None) -> (coords, vels, (R,)
    kinetic energies); ``noise`` is an optional (replica, step_n) -> that
    step's normals."""

    def step(coords, vels, generators, noise=None):
        jobs = [(simulator, template, coords[r], vels[r], generators[r],
                 None if noise is None else (
                     lambda step_n, r=r: noise(r, step_n)))
                for r in range(coords.shape[0])]
        out = run_segments(jobs, n_inner_steps, needs_virial)
        return (torch.stack([s.coords for s, _ in out]),
                torch.stack([s.velocities for s, _ in out]),
                torch.stack([kinetic_energy(s.masses, s.velocities)
                             for s, _ in out]))

    return step


def simulate_ensemble(sys, simulator, n_replicas, n_steps, generator=None,
                      mesh=None, axis_name="replicas", chunk=10, noise=None):
    """Advance n_replicas copies of ``sys`` in chunks of ``chunk`` steps
    (rounded up to whole chunks, as the JAX package does), each chunk from
    a fresh list, each replica on its own generator seeded from
    ``generator``, sharded over ``mesh``: replica_mesh() (every CUDA
    device) when None and ``sys`` is on a card, as JAX builds its mesh of
    every device; ``sys``'s own device otherwise. ``noise`` is an optional
    (chunk index, replica, step_n) -> normals. Returns the final
    ReplicaEnsemble, gathered on the mesh's first device."""
    if mesh is None:
        mesh = (replica_mesh(axis_name=axis_name)
                if sys.device.type == "cuda"
                else ReplicaMesh((sys.device,), (axis_name,)))
    template, reps = placed(make_ensemble(sys, n_replicas), mesh, axis_name)
    home = template.device
    gens = replica_generators(generator, [s.device for s in reps])
    coords = [s.coords for s in reps]
    vels = [s.velocities for s in reps]
    done = c = 0
    while done < n_steps:
        jobs = [(simulator, reps[r], coords[r], vels[r], gens[r],
                 None if noise is None else (
                     lambda step_n, c=c, r=r: noise(c, r, step_n)))
                for r in range(n_replicas)]
        out = run_segments(jobs, chunk)
        coords = [s.coords for s, _ in out]
        vels = [s.velocities for s, _ in out]
        done += chunk
        c += 1
    return ReplicaEnsemble(
        template=template,
        coords=torch.stack([x.to(home) for x in coords]),
        velocities=torch.stack([v.to(home) for v in vels]))
