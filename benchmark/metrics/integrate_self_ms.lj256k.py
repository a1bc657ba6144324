"""integrate_self_ms.lj256k: device ms per step launched in ``md.step``
outside ``forces``: the integrator's own work in the 256,000-atom LJ
cell's loop (timesteps_per_s.lj256k)."""

from spans import integrate_self_ms as read  # noqa: F401
