"""launches_per_step.lj256k: kernel-launch calls per step in the traced
stretch of the 256,000-atom LJ cell's loop (timesteps_per_s.lj256k)."""

from readers import launches_per_step as read  # noqa: F401
