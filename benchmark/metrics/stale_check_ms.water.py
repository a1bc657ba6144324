"""stale_check_ms.water: device ms of one exact stale-list check of the
cluster-pair list (the ``neighbors.check`` span) inside the water cell's
loop (timesteps_per_s)."""

from spans import stale_check_ms as read  # noqa: F401
