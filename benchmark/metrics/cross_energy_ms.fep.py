"""cross_energy_ms.fep: device ms of one sample of U at every lambda (the
``fep.cross`` span around ExtendedStateSpace.state_energies) in the fep
cell's traced chunks (timesteps_per_s). None for a program without that
span."""

from spans import per_call_ms


def read(run):
    return per_call_ms(run, "fep.cross")
