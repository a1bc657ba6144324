"""setup_s: from the start of the process to the first timed step: the
imports, the build of the system and its lists, the load (or first build)
of the kernels, the first forces and the warm-up chunk."""


def read(run):
    return run.window["setup_s"]
