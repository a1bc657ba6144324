"""integrate_self_ms.fep: device ms per step launched in ``md.step``
outside ``forces``: leap-frog, the rigid waters' constraints and the
thermostat in the fep cell's loop (timesteps_per_s)."""

from spans import integrate_self_ms as read  # noqa: F401
