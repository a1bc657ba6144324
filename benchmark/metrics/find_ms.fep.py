"""find_ms.fep: device ms of one rebuild of the cluster-pair list (the
``neighbors.find`` span) inside the fep cell's loop (timesteps_per_s)."""

from spans import find_ms as read  # noqa: F401
