"""pme_ms.fep: device ms per step of PME on the scheduled charges (the
``forces.pme`` spans: the spreading, the FFTs with the influence function,
the gather and the excluded pairs, which PME subtracts itself here) inside
the fep cell's loop (timesteps_per_s). None for a program without that
span."""

from spans import per_step


def read(run):
    return per_step(run, lambda r: r.device_us("forces.pme") * 1e-3
                    if r.count.get("forces.pme") else None)
