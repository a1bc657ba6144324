"""find_ms.water: device ms of one rebuild of the cluster-pair list (the
``neighbors.find`` span) inside the water cell's loop (timesteps_per_s)."""

from spans import find_ms as read  # noqa: F401
