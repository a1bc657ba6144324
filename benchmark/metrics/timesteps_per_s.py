"""timesteps_per_s: LAMMPS's own unit, all the window's steps over all its
time (host clock around whole chunks)."""


def read(run):
    w = run.window
    return w["steps"] / w["seconds"]
