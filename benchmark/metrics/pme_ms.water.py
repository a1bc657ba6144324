"""pme_ms.water: device ms per step of PME (the ``forces.pme`` spans: the
charge spreading, the FFTs with the influence function, the force gather)
inside the water cell's loop (timesteps_per_s). None for a program
without that span."""

from spans import per_step


def read(run):
    return per_step(run, lambda r: r.device_us("forces.pme") * 1e-3
                    if r.count.get("forces.pme") else None)
