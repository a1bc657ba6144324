"""Checkpoint and resume (counterpart of mollytpu/utils/checkpoint.py).

A checkpoint is one npz of the dynamic state: coordinates, velocities,
the box, the step counter and the state of the run's torch.Generator
(``get_state()``, where the JAX package keeps its key), so a resumed run
draws the same noise as the uninterrupted one. Given the integrator's
``aux``, it also keeps the forces, the virial and the integrator's own
state (Nose-Hoover's zeta, Stormer-Verlet's previous coordinates, a Monte
Carlo barostat's counters), which a run resumed with them does not
recompute: on the CPU in float64, a run resumed at a rebuild step is then
the uninterrupted run bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary import Orthorhombic, Triclinic


def _host(x):
    return x.detach().cpu().numpy()


def save_checkpoint(path, sys, step_n=0, generator=None, extra=None,
                    aux=None):
    """Write sys's coordinates, velocities and box, ``step_n``, the
    generator's state, ``extra`` (name -> array) and the tensors of
    ``aux`` (the integrator's state, one level of dicts) to ``path``."""
    data = {"coords": _host(sys.coords), "velocities": _host(sys.velocities),
            "step_n": np.asarray(step_n)}
    if isinstance(sys.boundary, Orthorhombic):
        data["box_sides"] = _host(sys.boundary.side_lengths)
    else:
        data["box_basis"] = _host(sys.boundary.basis)
        data["box_approx_images"] = np.asarray(sys.boundary.approx_images)
    if generator is not None:
        data["rng_state"] = _host(generator.get_state())
    for k, v in (extra or {}).items():
        data["extra_" + k] = _host(v) if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    for k, v in (aux or {}).items():
        items = v.items() if isinstance(v, dict) else [(None, v)]
        for sub, t in items:
            data["aux_" + k + ("" if sub is None else "." + sub)] = _host(t)
    np.savez(path, **data)


def load_checkpoint(path, sys, generator=None):
    """(sys with the saved coordinates, velocities and box, step_n, the
    generator, extra dict). The saved generator state is set on
    ``generator``, or on a new generator on sys's device; None when the
    checkpoint holds none. A saved aux comes back on sys's device as
    extra["aux"], for ``simulate(..., aux=extra["aux"], init_step=step_n)``."""
    z = np.load(path)
    dtype, dev = sys.coords.dtype, sys.device

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    sys = sys.update(coords=tensor(z["coords"]),
                     velocities=tensor(z["velocities"]))
    if "box_sides" in z:
        sys = sys.update(boundary=Orthorhombic(tensor(z["box_sides"])))
    else:
        sys = sys.update(boundary=Triclinic(
            tensor(z["box_basis"]),
            approx_images=bool(z["box_approx_images"])))
    if "rng_state" in z:
        generator = generator or torch.Generator(device=dev)
        generator.set_state(torch.as_tensor(z["rng_state"]))
    else:
        generator = None
    extra = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    aux = {}
    for k in z.files:
        if k.startswith("aux_"):
            name, _, sub = k[4:].partition(".")
            value = torch.as_tensor(z[k], device=dev)
            if sub:
                aux.setdefault(name, {})[sub] = value
            else:
                aux[name] = value
    if aux:
        extra["aux"] = aux
    return sys, int(z["step_n"]), generator, extra
