"""rebuild_ms.lj256k: host-clock ms of a cell-list rebuild and its stale
check on the end state of the 256,000-atom LJ cell, the mean over 20 or
more that last 0.5 s or more (timesteps_per_s.lj256k)."""

from readers import rebuild_ms as read  # noqa: F401
