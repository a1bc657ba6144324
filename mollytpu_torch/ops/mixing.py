"""Mixing rules (counterpart of mollytpu/ops/mixing.py). The pair kernel
implements Lorentz-Berthelot for sigma and epsilon and the minimum for the
alchemical lambda; these tags select them."""


class LorentzMixing:
    """Arithmetic mean (sigma_i + sigma_j) / 2."""


class GeometricMixing:
    """Geometric mean sqrt(eps_i eps_j)."""


class MinimumMixing:
    """min(lam_i, lam_j): the alchemical lambda mixing the pair kernel
    takes (mollytpu/ops/mixing.py:87-100)."""
