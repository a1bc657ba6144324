"""pair_kernel_roofline_pct.water: the water cell's pair call on the pair
kernel K1 (Ewald real space and truncated LJ, one call of the pairwise
interactions alone) against the physics count's least time
(roofline/ops.least_time_s with coulomb "ewald") (timesteps_per_s)."""

from readers import nonbonded_roofline_pct as read  # noqa: F401
