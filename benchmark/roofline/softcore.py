"""The least time of the alchemical window's pair work: the water's
physics count (roofline/ops.py), with the pairs of the coupled molecule at
the soft-core path's operations in place of the plain ones.

Per soft-core pair, counted from the arithmetic of the pair kernel's
soft-core path as its plain twin writes it (mollytpu_torch/ops/
pair_kernel.py, ``pair_lambdas`` and ``_pair_terms_alch``; an FMA as 2,
sqrt, divide and rint as 1): the pair's lambdas through the scheduler
(12); Beutler soft-core Ewald real space (48: the soft-core radius
(a (1 - l) sigma^6 + r^6)^(-1/6) through log and exp, the
Abramowitz-Stegun erfc, the energy and dU/dr / r) with 3 special
functions (log, exp, and the erfc's exp) in place of Ewald's 2; and for a
pair of two LJ atoms Beutler soft-core LJ (24) in place of the truncated
LJ's 18. Every pair still pays the minimum image, 1/r and the force
accumulation. The bytes add each atom's (lambda, role) row."""

from __future__ import annotations

from roofline.ops import (ACCUM_OPS, BASE_SFU, COUL_OPS, EWALD_SFU,
                          FP32_OPS_PER_S, HBM_BYTES_PER_S, INV_R_OPS, LJ_OPS,
                          MIC_OPS_ORTHO, SFU_OPS_PER_S)

LAMBDA_OPS = 12
SOFT_COUL_OPS = 48
SOFT_COUL_SFU = 3
SOFT_LJ_OPS = 24


def least_time_s(pairs, lj_pairs, soft, soft_lj, n_atoms, coulomb, lj,
                 input_bytes_per_atom, force_bytes_per_atom=12):
    """(least seconds, what bounds it, FP32 operations, special functions,
    bytes) of the forces of ``pairs`` pairs inside the cutoff (``lj_pairs``
    of them with LJ), ``soft`` of them (``soft_lj`` with LJ) on the
    soft-core path."""
    plain, plain_lj = pairs - soft, lj_pairs - soft_lj
    common = MIC_OPS_ORTHO + INV_R_OPS + ACCUM_OPS
    ops = (plain * (common + COUL_OPS[coulomb]) + plain_lj * LJ_OPS[lj]
           + soft * (common + LAMBDA_OPS + SOFT_COUL_OPS)
           + soft_lj * SOFT_LJ_OPS)
    sfu = (plain * (BASE_SFU + (EWALD_SFU if coulomb == "ewald" else 0))
           + soft * (BASE_SFU + SOFT_COUL_SFU))
    nbytes = n_atoms * (input_bytes_per_atom + force_bytes_per_atom)
    times = {"FP32 operations": ops / FP32_OPS_PER_S,
             "special functions": sfu / SFU_OPS_PER_S,
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by], by, ops, sfu, nbytes
