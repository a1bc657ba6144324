"""host_step_ms.lj256k: host ms per ``md.step`` span in the traced stretch
of the 256,000-atom LJ cell's loop, the time the host takes to issue one
step's work (timesteps_per_s.lj256k)."""

from spans import span_trace


def read(run):
    red = span_trace(run)
    if red is None or not red.count.get("md.step"):
        return None
    return red.host_us["md.step"] * 1e-3 / red.count["md.step"]
