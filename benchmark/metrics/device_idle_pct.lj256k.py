"""device_idle_pct.lj256k: the share of the 256,000-atom LJ cell's step in
which the device is idle: one minus the traced device busy time per step
over the unprofiled window's time per step (timesteps_per_s.lj256k)."""

from readers import idle_pct as read  # noqa: F401
