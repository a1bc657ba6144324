"""rebuild_ms.fep: host-clock ms of a cluster-pair list rebuild and its
stale check on the fep cell's end state, the mean over 20 or more that
last 0.5 s or more (timesteps_per_s)."""

from readers import rebuild_ms as read  # noqa: F401
