"""constraints_ms.fep: device ms per step of the rigid waters' SHAKE and
RATTLE (the ``md.constraints`` spans) inside the fep cell's loop
(timesteps_per_s)."""

from spans import per_step


def read(run):
    return per_step(run, lambda r: r.device_us("md.constraints") * 1e-3
                    if r.count.get("md.constraints") else None)
