"""nonbonded_roofline_pct.lj: the LJ cell's pair call on the neighbor
engine against the physics count's least time (timesteps_per_s)."""

from readers import nonbonded_roofline_pct as read  # noqa: F401
