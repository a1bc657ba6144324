"""pairs_ms.lj: device ms per step of the pair engine (the ``forces.pairs``
spans) inside the LJ cell's loop (timesteps_per_s)."""

from spans import pairs_ms as read  # noqa: F401
