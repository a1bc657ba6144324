"""The integrators the traffic files name, written plainly over a reference
model (``forces``, ``wrap``, ``mass``). ``velocity_verlet`` is ``fix
nve``: kick, drift, wrap, kick."""

from __future__ import annotations


def velocity_verlet(model, x, v, n_steps, dt):
    dtp = model.prec.dtype
    x, v = x.to(dtp), v.to(dtp)
    m = model.mass[:, None]
    f = model.forces(x)
    for _ in range(n_steps):
        v = v + 0.5 * dt * f / m
        x = model.wrap(x + dt * v)
        f = model.forces(x)
        v = v + 0.5 * dt * f / m
    return x, v


INTEGRATORS = {"velocity_verlet": velocity_verlet}
