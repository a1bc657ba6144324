"""host_syncs_per_step.lj256k: blocking runtime calls (stream, device and
event synchronizes, synchronous copies) inside ``md.chunk`` per step of the
256,000-atom LJ cell's loop (timesteps_per_s.lj256k)."""

from spans import host_syncs_per_step as read  # noqa: F401
