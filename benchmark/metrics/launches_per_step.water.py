"""launches_per_step.water: kernel-launch calls per step in the traced
stretch of the water cell's loop (timesteps_per_s)."""

from readers import launches_per_step as read  # noqa: F401
