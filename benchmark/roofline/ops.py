"""What one pair of the nonbonded work costs, and the least time the card
could take for it.

The per-pair operation counts are a frozen copy of ``chip_smoke.py``'s
(``MIC_OPS``, ``COUL_OPS``, ``LJ_OPS``, ``pair_ops``; counted from the pair
kernel's arithmetic with an FMA as 2 and sqrt, divide and rint as 1):
every pair inside the cutoff pays the minimum image and r^2 (20 in an
orthorhombic box), 1/r and 1/r^2 (3), its Coulomb term and the force
accumulation (12), and 2 special functions (sqrt, 1/r) plus 2 more under
Ewald (the exponentials of erfc and exp); a pair whose atoms both carry
LJ pays the LJ term. The bytes are each per-atom input read once and
each force written once. Peaks of one NVIDIA H100 SXM (data sheet, 700 W):
67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s of HBM; special
functions at 16 per SM per clock on 132 SMs at 1.98 GHz (CUDA C++
Programming Guide)."""

from __future__ import annotations

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9

MIC_OPS_ORTHO = 20
INV_R_OPS = 3
ACCUM_OPS = 12
#: Coulomb: none, plain, reaction field, Ewald real space
COUL_OPS = {"none": 0, "plain": 9, "reaction_field": 11, "ewald": 37}
#: LJ: truncated at the cutoff, shifted potential, shifted force
LJ_OPS = {"distance_cutoff": 18, "shifted_potential": 27,
          "shifted_force": 38}
BASE_SFU, EWALD_SFU = 2, 2


def least_time_s(pairs, lj_pairs, n_atoms, coulomb, lj, input_bytes_per_atom,
                 force_bytes_per_atom=12):
    """(least seconds, what bounds it, FP32 operations, special functions,
    bytes) of the forces of ``pairs`` pairs inside the cutoff."""
    ops = pairs * (MIC_OPS_ORTHO + INV_R_OPS + COUL_OPS[coulomb] + ACCUM_OPS) \
        + lj_pairs * LJ_OPS[lj]
    sfu = pairs * (BASE_SFU + (EWALD_SFU if coulomb == "ewald" else 0))
    nbytes = n_atoms * (input_bytes_per_atom + force_bytes_per_atom)
    times = {"FP32 operations": ops / FP32_OPS_PER_S,
             "special functions": sfu / SFU_OPS_PER_S,
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by], by, ops, sfu, nbytes
