"""find_ms.lj: device ms of one cell-list rebuild (the ``neighbors.find``
span) inside the LJ cell's loop (timesteps_per_s)."""

from spans import find_ms as read  # noqa: F401
