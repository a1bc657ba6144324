"""host_syncs_per_step.fep: blocking runtime calls (stream, device and
event synchronizes, synchronous copies) inside ``md.chunk`` per step of the
fep cell's loop (timesteps_per_s)."""

from spans import host_syncs_per_step as read  # noqa: F401
