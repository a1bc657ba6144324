"""stale_check_ms.fep: device ms of one exact stale-list check of the
cluster-pair list (the ``neighbors.check`` span) inside the fep cell's
loop (timesteps_per_s)."""

from spans import stale_check_ms as read  # noqa: F401
