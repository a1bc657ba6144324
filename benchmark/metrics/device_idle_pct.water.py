"""device_idle_pct.water: the share of the water cell's step in which the
device is idle: one minus the traced device busy time per step over the
unprofiled window's time per step (timesteps_per_s)."""

from readers import idle_pct as read  # noqa: F401
