"""timesteps_per_s.lj256k: timesteps_per_s of the 256,000-atom LJ cell,
whose step the host sets, under a bound of its own: all the window's
steps over all its time (host clock around whole chunks)."""


def read(run):
    w = run.window
    return w["steps"] / w["seconds"]
