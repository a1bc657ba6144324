"""device_idle_pct.fep: the share of the fep cell's step in which the
device is idle: one minus the traced device busy time per step over the
unprofiled window's time per step, the samples' share of both included
(timesteps_per_s)."""

from readers import idle_pct as read  # noqa: F401
