"""Free energy (counterpart of mollytpu/free_energy): lambda schedulers,
window Hamiltonians, MBAR and PMFs, time-series statistics, collective
variables and biases, extended state spaces, AWH and TSS."""
