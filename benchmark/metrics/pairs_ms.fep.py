"""pairs_ms.fep: device ms per step of the pair kernel's soft-core
instance K1c (the ``forces.pairs`` spans) inside the fep cell's loop; the
samples' pair work lies under ``fep.cross`` (timesteps_per_s)."""

from spans import pairs_ms as read  # noqa: F401
