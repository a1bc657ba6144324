"""integrate_self_ms.lj: device ms per step launched in ``md.step`` outside
``forces``: the integrator's own work in the LJ cell's loop
(timesteps_per_s)."""

from spans import integrate_self_ms as read  # noqa: F401
