"""Lennard-Jones mixing rules (counterpart of mollytpu/ops/mixing.py).
The pair kernel implements Lorentz-Berthelot only; these tags select it."""


class LorentzMixing:
    """Arithmetic mean (sigma_i + sigma_j) / 2."""


class GeometricMixing:
    """Geometric mean sqrt(eps_i eps_j)."""
