"""stale_check_ms.lj256k: device ms of one exact stale-list check (the
``neighbors.check`` span) inside the 256,000-atom LJ cell's loop
(timesteps_per_s.lj256k)."""

from spans import stale_check_ms as read  # noqa: F401
