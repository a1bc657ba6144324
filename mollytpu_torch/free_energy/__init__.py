"""Alchemical free energy: lambda schedulers, window Hamiltonians, MBAR and
time-series statistics (counterpart of mollytpu/free_energy)."""
