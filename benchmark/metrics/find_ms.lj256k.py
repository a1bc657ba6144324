"""find_ms.lj256k: device ms of one cell-list rebuild (the ``neighbors.find``
span) inside the 256,000-atom LJ cell's loop (timesteps_per_s.lj256k)."""

from spans import find_ms as read  # noqa: F401
