"""Internal unit system of the PyTorch port (counterpart of mollytpu/units.py).

Every tensor is a plain float in these units:

    length       nm
    time         ps
    mass         u  (g/mol)
    energy       kJ/mol
    charge       e  (proton charge)
    temperature  K

1 kJ/mol == 1 u nm^2 / ps^2, so acceleration = force / mass needs no factor.
"""

from __future__ import annotations

# Boltzmann constant in kJ/(mol*K), molar form.
BOLTZMANN = 0.008314462618153239
KB = BOLTZMANN

# Coulomb constant 1/(4 pi eps0) in kJ*nm/(mol*e^2).
COULOMB_CONST = 138.93545764438198

# Avogadro constant (1/mol).
AVOGADRO = 6.02214076e23

# 1 bar in kJ/(mol*nm^3).
BAR = 0.06022140760000001
ATM = 1.01325 * BAR

ANGSTROM = 0.1          # nm
FEMTOSECOND = 1e-3      # ps
NANOSECOND = 1e3        # ps
KCAL = 4.184            # kJ


def ps_per_step_to_ns_per_day(dt_ps, seconds_per_step):
    """Simulated ns/day given the wall seconds of one MD step of dt_ps."""
    return 86400.0 / seconds_per_step * dt_ps * 1e-3
