"""pairs_ms.water: device ms per step of the pair kernel K1 (the
``forces.pairs`` spans) inside the water cell's loop (timesteps_per_s)."""

from spans import pairs_ms as read  # noqa: F401
