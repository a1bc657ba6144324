"""nonbonded_roofline_pct.lj256k: the 256,000-atom LJ cell's pair call on
the neighbor engine against the physics count's least time
(timesteps_per_s.lj256k)."""

from readers import nonbonded_roofline_pct as read  # noqa: F401
