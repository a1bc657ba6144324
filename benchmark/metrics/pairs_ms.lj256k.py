"""pairs_ms.lj256k: device ms per step of the pair engine (the
``forces.pairs`` spans) inside the 256,000-atom LJ cell's loop
(timesteps_per_s.lj256k)."""

from spans import pairs_ms as read  # noqa: F401
