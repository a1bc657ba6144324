"""host_syncs_per_step.water: blocking runtime calls (stream, device and
event synchronizes, synchronous copies) inside ``md.chunk`` per step of the
water cell's loop (timesteps_per_s)."""

from spans import host_syncs_per_step as read  # noqa: F401
