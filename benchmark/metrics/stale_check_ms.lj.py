"""stale_check_ms.lj: device ms of one exact stale-list check (the
``neighbors.check`` span) inside the LJ cell's loop (timesteps_per_s)."""

from spans import stale_check_ms as read  # noqa: F401
