"""launches_per_step.fep: kernel-launch calls per step in the traced
stretch of the fep cell's loop, the one sample's included
(timesteps_per_s)."""

from readers import launches_per_step as read  # noqa: F401
