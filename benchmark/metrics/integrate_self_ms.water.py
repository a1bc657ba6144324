"""integrate_self_ms.water: device ms per step launched in ``md.step``
outside ``forces``: leap-frog, the rigid waters' constraints and the
thermostat in the water cell's loop (timesteps_per_s)."""

from spans import integrate_self_ms as read  # noqa: F401
