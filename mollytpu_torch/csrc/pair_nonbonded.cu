// Nonbonded pair kernel K1 (modes K1a, K1b and K1c): Lennard-Jones (no /
// distance / shifted-potential / shifted-force cutoff, Lorentz-Berthelot
// mixing) plus plain, reaction-field or Ewald real-space Coulomb, with
// windowed exclusion / 1-4 bitmaps, over a list of 32 x 32 atom-cluster
// pairs in an orthorhombic or triclinic box; and the alchemical path
// (K1c): Beutler or Gapsys soft-core LJ and soft-core Coulomb, bare or
// under the Ewald screen, at per-pair lambdas resolved from per-atom
// (lambda, role) rows by one of four schedulers.
//
// Replaces mollytpu/ops/pallas_pairwise.py::_kernel (launched by
// pallas_block_nonbonded), with the pair terms of its _pair_terms (:462) for
// every mode without alchemical lambda, its _pair_terms_alch (:320) and the
// per-pair lambda block of the kernel body (:814-840) for the soft-core
// path, and both of its minimum-image forms (hoisted and per-pair,
// :714-754), which a per-pair MIC covers. The scaled-charge family
// (scale_q, :982-989) needs no instance of its own: the wrapper scales the
// charge column per call and launches K1a/K1b. The plain PyTorch twin is
// mollytpu_torch/ops/pair_kernel.py::pair_nonbonded_plain.
//
// What bounds it on an H100: instruction issue. The bytes it must move
// (~1 MB at 16k atoms) take well under a microsecond, and no step is a
// matrix product, so the tensor cores do not apply. Two kinds of work
// share the SMs' issue slots: the slot test (minimum image, r^2, the
// exclusion bits) on every listed slot, ~24 M at 16k atoms of which ~15%
// lie inside the cutoff, and the pair terms on the live slots (FP32 and
// the special-function unit: sqrt and reciprocal for every live pair, erfc
// and exp under Ewald; K1c adds a log/exp pair for rQ^(-1/6) or r_Q,
// another for the Gapsys r_LJ, the Abramowitz-Stegun erfc's reciprocal and
// exp, and the reciprocals of R6). The roofline probes (gather_only,
// distance_only, noocc) measure the parts on the card (PERF.md).
//
// Design: one warp per cluster pair (tile); the j-cluster's rows and both
// clusters' pair parameters sit in the warp's shared memory; lane t owns
// i-atom t and meets j = (t + k) & 31 at rotation step k, so each step
// tests 32 distinct slots. Two tile loops share that slot test:
// - compacted (instances under the Ewald screen and on the lambda path,
//   whose pair terms cost several times the slot test): phase A tests the
//   32 steps, and __ballot_sync / __popc append the live slots (dx, dy, dz
//   and a code of i lane, j lane and the 1-4 flag) to a per-warp ring queue
//   in order; phase B drains 32 queued slots at a time with every lane
//   busy, so the pair terms run only on live slots, not on every lane of a
//   step with one live lane (which pays them ~3.4x over in liquid water at
//   a 1.15 nm list). Forces go into per-warp i and j accumulators in shared
//   memory by integer atomics on fixed-point sums (native; an f32 atomicAdd
//   on shared memory compiles to a compare-and-swap loop on sm_90, which
//   cost more than the compaction saved); a pair force with a component
//   too large for the fixed point or not finite goes to global memory;
//   one global atomicAdd per atom and component flushes them at the end of
//   the tile, and a tile with no live slot skips phase B and the flush. The
//   self tile (I == J) keeps each pair once (j lane above i lane) and adds
//   both forces to the one cluster.
// - in place (the others: plain, reaction-field or no Coulomb without
//   lambda, whose pair terms cost about what a queue entry does): the pair
//   terms run on the live lanes of each step; i-forces stay in registers,
//   and a j-force accumulator moves one lane down per step (a warp
//   shuffle), so after 32 steps lane t holds the j-side force of J's atom t;
//   the self tile evaluates both orderings at weight 0.5 and emits no
//   j-forces.
// Energy and virial are summed per lane in f32 and across the block's
// warps in double: 7 double atomics per block. On the lambda path the
// (lambda, role) rows of both clusters sit in shared memory, the lambda
// block and the soft-core terms run in phase B, and switched-off soft-cored
// terms (lambda_s or lambda_e 0) are skipped by a branch; the LJ kind, the
// soft-core Coulomb kind and the scheduler are warp-uniform runtime
// parameters. What is left: phase A, the slot test of every listed slot,
// now costs more than the pair terms under Ewald. A walk over the 8 x 8
// sub-tiles that come within the list radius (57% of them in liquid water)
// tested fewer slots but ran no faster: the test is bound by the latency of
// its shared-memory loads, ballot and queue store more than by issue. The
// LJ branch still diverges inside a batch, and each tile reloads its rows
// (row runs of one I cluster would keep them).
//
// Roofline probes (LaunchSpec.probe; instances for forces-only Ewald,
// orthorhombic, with and without lambda): gather_only loads and touches the
// rows and computes nothing, distance_only sets coef = r^2 * 1e-12 on live
// slots (no pair terms), noocc adds no j-forces of cross tiles.
//
// Instances: templated on what changes the inner loop, the lambda path,
// the Coulomb mode, the box shape and the energy output (2 x 4 x 2 x 2),
// and the probe (3 x 2 more). The LJ mode, the LJ and Coulomb soft-core
// kinds, the scheduler and every constant are warp-uniform runtime
// parameters. Without the lambda path no (lambda, role) row is loaded.
//
// Conventions (as the TPU kernel): coef = (dU/dr)/r, f_i += coef (x_j - x_i),
// f_j -= coef (x_j - x_i), virial -= coef dx (x) dx. Forces land by atomicAdd
// in the ORIGINAL atom order (ids[slot] is the atom id, n_atoms for padding).
// Minimum image: back-substitution over the lower-triangular box rows a =
// (h11, 0, 0), b = (h21, h22, 0), c = (h31, h32, h33): round out the c
// image, then b, then a; an orthorhombic box rounds each axis on its own,
// and an open axis has side and inverse 0. The box's 9 floats come from the
// caller's device buffer (the call's box, built on the device): the
// launcher copies them into constant memory on the launch's stream right
// before the kernel, so a barostat's move reaches the kernel without a host
// read, a captured launch would take the buffer's pointer, and the kernel
// reads them as constant operands, as it read the launch parameters
// (loading them into registers instead cost K1a 5-8 registers and made
// three lambda/energy instances spill). Stream order gives every launch its
// own box; as all streams share the one buffer, ops/pair_kernel.py's
// launch_args makes a launch on another stream wait for the work queued on
// the stream of the last launch.
// Roles ride as floats (0 core, 1 insert, 2 delete), as in the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
// rotation steps tested between two drains of the queue, and the queue's
// ring size: at most 31 + 32 * group entries wait at once. The lambda
// path's larger register set leaves fewer warps per SM, which a smaller
// ring (less shared memory) buys back; the others gain more from testing
// more steps between drains.
template <bool LAM>
constexpr int kGroup = LAM ? 2 : 4;
template <bool LAM>
constexpr int kQueue = LAM ? 128 : 256;

// the roofline probes (LaunchSpec.probe), wrong physics on purpose
constexpr int kGatherOnly = 1;    // load the tile rows, compute nothing
constexpr int kDistanceOnly = 2;  // coef = r^2 * 1e-12 on live slots
constexpr int kNoOcc = 3;         // no j-side reduction of cross tiles

// fixed-point force sums of the compacted loop, two 32-bit words per
// component: a force f adds h = rint(f * S) units of 1/S to the high word
// and rint((f - h / S) * S * 2^24) units of 2^-24 / S to the low one, with
// S = 2^8 per kJ/mol/nm (2^40 for the distance_only probe, whose forces
// are ~1e-12). A warp's tile adds at most 32 pair forces into one sum,
// each component at most fixed_max = 2^25 units of the high word (the
// residual at most 2^23 units of the low one), so both stay below 2^30
// units; a component rounds to 2^-25 / S.
__host__ __device__ constexpr float fixed_scale(int probe) {
  return probe == kDistanceOnly ? 0x1p40f : 0x1p8f;
}
__host__ __device__ constexpr float fixed_max(int probe) {
  return 0x1p25f / fixed_scale(probe);
}

}  // namespace

// The launcher's spec; mirrored by ops/pair_kernel.py::_Launch.
struct LaunchSpec {
  int n_pairs;
  int n_atoms;
  int lj_mode;         // 0 none, 1 distance, 2 shifted potential,
                       // 3 shifted force, 4 no cutoff
  int coul_mode;       // 0 none, 1 plain, 2 reaction field, 3 Ewald real
  int triclinic;       // 0: per-axis minimum image
  int compute_energy;
  float cut2;          // cut_max^2: every pair beyond it is skipped
  float lj_rc2;        // LJ's own cutoff^2 (inf when it is cut_max or none)
  float coul_rc2;      // Coulomb's own cutoff^2 (inf likewise)
  float lj_rc;         // shifted LJ: rc, 1/rc, 1/rc^2
  float inv_lj_rc;
  float inv_lj_rc2;
  float lj_w;          // LJ weight of 1-4 pairs
  float coul_w;        // Coulomb weight of 1-4 pairs
  float ke;            // Coulomb constant
  float alpha;         // Ewald splitting parameter
  float krf;           // reaction field constants
  float crf;
  int use_lam;         // the alchemical (K1c) instances
  int lj_kind;         // 0 plain, 1 Beutler, 2 Gapsys soft-core LJ
  int coul_sc;         // 0 plain, 1 Beutler, 2 Gapsys soft-core Coulomb
  int scheduler;       // 0 Default, 1 NAMD, 2 Quarters, 3 EleScaled
  float lj_alpha;      // soft-core LJ alpha
  float coul_alpha_sc; // soft-core Coulomb alpha
  float coul_sigma_q;  // Gapsys Coulomb sigma_Q
  int probe;           // 0, or a roofline probe (forces-only K1a / K1c)
};

namespace {

// The schedulers of mollytpu/free_energy/alchemy.py: the scale at the pair
// lambda l for the pair role (1 insert, 2 delete, else l itself).
__device__ __forceinline__ float scale_sterics(int sched, float l,
                                               float role) {
  if (role == 1.f) {
    if (sched == 1) return l < 2.f / 3.f ? 1.5f * l : 1.f;
    if (sched == 2) return l < 0.5f ? 0.f : (l > 0.75f ? 1.f : 4.f * (l - 0.5f));
    return l < 0.5f ? 2.f * l : 1.f;
  }
  if (role == 2.f) {
    if (sched == 1) return l < 1.f / 3.f ? 0.f : (l - 1.f / 3.f) * 1.5f;
    if (sched == 2) return l < 0.25f ? 0.f : (l > 0.5f ? 1.f : 4.f * (l - 0.25f));
    return l < 0.5f ? 0.f : 2.f * (l - 0.5f);
  }
  return l;
}

__device__ __forceinline__ float scale_elec(int sched, float l, float role) {
  if (role == 1.f) {
    if (sched == 2) return l < 0.75f ? 0.f : 4.f * (l - 0.75f);
    if (sched == 3) return l < 0.5f ? 0.f : sqrtf(fmaxf(2.f * (l - 0.5f), 0.f));
    return l < 0.5f ? 0.f : 2.f * (l - 0.5f);
  }
  if (role == 2.f) {
    if (sched == 2) return l < 0.25f ? 4.f * l : 1.f;
    if (sched == 3) return l < 0.5f ? (2.f * l) * (2.f * l) : 1.f;
    return l < 0.5f ? 2.f * l : 1.f;
  }
  return l;
}

// Soft-core LJ at squared distance rr2 (pallas_pairwise.py:332-378):
// Beutler R6 = a(1-l)s^6 + r^6 floored at 1e-12, or Gapsys, the plain
// potential beyond r_lj and its quadratic expansion about r_lj inside.
__device__ __forceinline__ void soft_lj(int lj_kind, float rr2, float c6,
                                        float c12, float shift, float r_lj,
                                        float lam_s, float& e, float& c) {
  if (lj_kind == 1) {
    const float r6 = fmaxf(shift + rr2 * rr2 * rr2, 1e-12f);
    const float inv6 = 1.0f / r6;
    e = lam_s * (c12 * inv6 - c6) * inv6;
    c = 6.0f * lam_s * rr2 * rr2 * (c6 - 2.0f * c12 * inv6) * inv6 * inv6;
    return;
  }
  const float rr2s = fmaxf(rr2, 1e-12f);
  const float rr = sqrtf(rr2s);
  if (rr >= r_lj) {
    const float inv2 = 1.0f / rr2s;
    const float inv6 = inv2 * inv2 * inv2;
    const float inv12 = inv6 * inv6;
    e = lam_s * (c12 * inv12 - c6 * inv6);
    c = -lam_s * (12.0f * c12 * inv12 - 6.0f * c6 * inv6) * inv2;
  } else {
    const float rs = fmaxf(r_lj, 1e-6f);
    const float inv_rs = 1.0f / rs;
    const float inv_rs2 = 1.0f / (rs * rs);
    const float inv_rs6 = inv_rs2 * inv_rs2 * inv_rs2;
    const float inv_rs12 = inv_rs6 * inv_rs6;
    const float a = 78.0f * c12 * inv_rs12 * inv_rs2 -
                    21.0f * c6 * inv_rs6 * inv_rs2;
    const float b = 168.0f * c12 * inv_rs12 * inv_rs -
                    48.0f * c6 * inv_rs6 * inv_rs;
    const float cc = 91.0f * c12 * inv_rs12 - 28.0f * c6 * inv_rs6;
    e = lam_s * ((a * rr2s - b * rr) + cc);
    c = lam_s * (2.0f * a - b / rr);
  }
}

// The pair terms of one live pair at squared distance r2 (every mode):
// e, and coef = (dU/dr)/r. li / ljj: sigma, sqrt(eps); qi / qj: charges;
// lri / lrj: (lambda, role) rows of the lambda path.
template <int COUL_MODE, bool LAM>
__device__ __forceinline__ void pair_terms(const LaunchSpec& p, float r2,
                                           bool special, float2 li,
                                           float qi, float2 ljj, float qj,
                                           float2 lri, float2 lrj,
                                           float& e, float& coef) {
  const float two_a_rsqrtpi = 2.0f * p.alpha * 0.56418958354775628f;
  e = 0.f;
  coef = 0.f;
  const float inv_r = 1.0f / sqrtf(r2);
  const float inv_r2 = inv_r * inv_r;
  // the lambda block (pallas_pairwise.py:814-840): the smaller lambda
  // through the scheduler at the pair role, fully on inside one
  // perturbed group, no LJ where either atom's lambda is exactly 0
  float lam_s = 1.f, lam_e = 1.f;
  if constexpr (LAM) {
    const float lam_mix = fminf(lri.x, lrj.x);
    const bool same_noncore = lri.y == lrj.y && lri.y != 0.f;
    const float role = (lri.y == 1.f || lrj.y == 1.f) ? 1.f
                       : ((lri.y == 2.f || lrj.y == 2.f) ? 2.f : 0.f);
    lam_s = same_noncore ? 1.f : scale_sterics(p.scheduler, lam_mix, role);
    lam_e = same_noncore ? 1.f : scale_elec(p.scheduler, lam_mix, role);
    if (lri.x == 0.f || lrj.x == 0.f) lam_s = 0.f;
  }
  // LJ: hydrogens carry eps = 0; skipping the term (rather than
  // multiplying by 0) keeps a huge (sigma/r)^12 from making 0 * inf
  const float eps = li.y * ljj.y;
  if (LAM && p.lj_kind != 0) {
    if (p.lj_mode != 0 && lam_s > 0.f && eps != 0.f && r2 < p.lj_rc2) {
      const float sig = 0.5f * (li.x + ljj.x);
      const float sig2 = sig * sig;
      const float sig6 = sig2 * sig2 * sig2;
      const float c6 = 4.0f * eps * sig6;
      const float c12 = c6 * sig6;
      float shift = 0.f, r_lj = 0.f;
      if (p.lj_kind == 1) {
        shift = p.lj_alpha * (1.0f - lam_s) * sig6;
      } else {
        const float ratio = c6 > 0.f ? 26.0f * c12 * (1.0f - lam_s) /
                                           (7.0f * fmaxf(c6, 1e-30f))
                                     : 0.f;
        r_lj = p.lj_alpha *
               (ratio > 0.f ? expf(logf(fmaxf(ratio, 1e-30f)) / 6.0f)
                            : 0.f);
      }
      float e_lj, c_lj;
      soft_lj(p.lj_kind, r2, c6, c12, shift, r_lj, lam_s, e_lj, c_lj);
      if (p.lj_mode == 2 || p.lj_mode == 3) {
        // the shifts: the same soft-core terms at rc, same lambda_s
        float e_rc, c_rc;
        soft_lj(p.lj_kind, p.lj_rc * p.lj_rc, c6, c12, shift, r_lj, lam_s,
                e_rc, c_rc);
        e_lj -= e_rc;
        if (p.lj_mode == 3) {
          const float dudr_rc = c_rc * p.lj_rc;
          e_lj -= (r2 * inv_r - p.lj_rc) * dudr_rc;
          c_lj -= dudr_rc * inv_r;
        }
      }
      const float wl = special ? p.lj_w : 1.0f;
      e = e_lj * wl;
      coef = c_lj * wl;
    }
  } else if (p.lj_mode != 0 && eps != 0.f && r2 < p.lj_rc2) {
    const float sig = 0.5f * (li.x + ljj.x);
    const float s2 = sig * sig * inv_r2;
    const float six = s2 * s2 * s2;
    const float twelve = six * six;
    float e_lj = 4.0f * eps * (twelve - six);
    float c_lj = -24.0f * eps * (2.0f * twelve - six) * inv_r2;
    if (p.lj_mode == 2 || p.lj_mode == 3) {
      const float s2c = sig * sig * p.inv_lj_rc2;
      const float sixc = s2c * s2c * s2c;
      const float twelvec = sixc * sixc;
      e_lj -= 4.0f * eps * (twelvec - sixc);
      if (p.lj_mode == 3) {
        const float dudr_rc =
            -24.0f * eps * (2.0f * twelvec - sixc) * p.inv_lj_rc;
        e_lj -= (r2 * inv_r - p.lj_rc) * dudr_rc;
        c_lj -= dudr_rc * inv_r;
      }
    }
    const float wl = special ? p.lj_w : 1.0f;
    e = e_lj * wl;
    coef = c_lj * wl;
  }
  if (COUL_MODE != 0 && r2 < p.coul_rc2) {
    const float keqq = p.ke * qi * qj;
    if (LAM && COUL_MODE != 2 && p.coul_sc != 0) {
      // soft-core Coulomb (pallas_pairwise.py:401-454); off at
      // lambda_e = 0
      if (lam_e > 0.f) {
        const float r = r2 * inv_r;
        float base_e, base_c;
        if (p.coul_sc == 1) {
          // Beutler: rQ = a(1-l)s^6 + r^6, the base ~ rQ^(-1/6)
          const float sig = 0.5f * (li.x + ljj.x);
          const float sig2 = sig * sig;
          const float sig6 = sig2 * sig2 * sig2;
          const float shift = p.coul_alpha_sc * (1.0f - lam_e) * sig6;
          const float rq = fmaxf(shift + r2 * r2 * r2, 1e-18f);
          const float pw = expf(-logf(rq) / 6.0f);
          base_e = lam_e * keqq * pw;
          base_c = -lam_e * keqq * r2 * r2 * pw / rq;
        } else {
          // Gapsys: quadratic inside r_Q = a (1-l)^(1/6) (1 + sQ|qq|)
          float rq = p.coul_alpha_sc *
                     expf(logf(fmaxf(1.0f - lam_e, 1e-30f)) / 6.0f) *
                     (1.0f + p.coul_sigma_q * fabsf(qi * qj));
          if (!(lam_e < 1.0f)) rq = 0.f;
          if (r >= rq) {
            base_e = lam_e * (keqq * inv_r);
            base_c = lam_e * (-keqq * inv_r * inv_r * inv_r);
          } else {
            const float inv_rq = 1.0f / fmaxf(rq, 1e-9f);
            const float inv_rq2 = inv_rq * inv_rq;
            const float inv_rq3 = inv_rq2 * inv_rq;
            base_e = lam_e * (keqq * (inv_rq3 * r2 - 3.0f * inv_rq2 * r +
                                      3.0f * inv_rq));
            base_c = lam_e * (keqq * (2.0f * inv_rq3 -
                                      3.0f * inv_rq2 * inv_r));
          }
        }
        if (COUL_MODE == 3 && !special) {
          // the Ewald screen on the soft-cored base: Abramowitz-Stegun
          // erfc times exp(-(a r)^2) on the true r, as the TPU kernel
          const float ar = p.alpha * r;
          const float t = 1.0f / (1.0f + 0.3275911f * ar);
          const float poly =
              (0.254829592f +
               (-0.284496736f +
                (1.421413741f + (-1.453152027f + 1.061405429f * t) * t) *
                    t) *
                   t) *
              t;
          const float exp_m = expf(-ar * ar);
          const float erfc_ar = poly * exp_m;
          e += base_e * erfc_ar;
          coef += base_c * erfc_ar - base_e * two_a_rsqrtpi * exp_m * inv_r;
        } else {
          // bare, or a 1-4 pair: times the 1-4 weight, unscreened
          const float wc = special ? p.coul_w : 1.0f;
          e += base_e * wc;
          coef += base_c * wc;
        }
      }
    } else if (COUL_MODE == 1) {
      const float wc = special ? p.coul_w : 1.0f;
      e += keqq * inv_r * wc;
      coef -= keqq * inv_r2 * inv_r * wc;
    } else if (special) {
      // 1-4 pairs: plain Coulomb times the 1-4 weight (under Ewald
      // their reciprocal part is removed by the exclusion correction)
      e += keqq * inv_r * p.coul_w;
      coef -= keqq * inv_r2 * inv_r * p.coul_w;
    } else if (COUL_MODE == 2) {
      e += keqq * (inv_r + p.krf * r2 - p.crf);
      coef += keqq * (2.0f * p.krf - inv_r2 * inv_r);
    } else {
      const float ar = p.alpha * r2 * inv_r;
      const float erfc_ar = erfcf(ar);
      const float ex = expf(-ar * ar);
      e += keqq * erfc_ar * inv_r;
      coef -= keqq * inv_r2 * (erfc_ar * inv_r + two_a_rsqrtpi * ex);
    }
  }
}

// The box of the launch: h11 h21 h22 h31 h32 h33 1/h11 1/h22 1/h33.
__constant__ float c_mic[9];

// The minimum image of x_j - x_i (back-substitution) and r^2.
template <bool TRICLINIC>
__device__ __forceinline__ float min_image(float4 pi, float4 pj, float& dx,
                                           float& dy, float& dz) {
  dx = pj.x - pi.x;
  dy = pj.y - pi.y;
  dz = pj.z - pi.z;
  if (TRICLINIC) {
    const float s3 = rintf(dz * c_mic[8]);
    dx -= s3 * c_mic[3];
    dy -= s3 * c_mic[4];
    dz -= s3 * c_mic[5];
    const float s2 = rintf(dy * c_mic[7]);
    dx -= s2 * c_mic[1];
    dy -= s2 * c_mic[2];
    dx -= rintf(dx * c_mic[6]) * c_mic[0];
  } else {
    dx -= c_mic[0] * rintf(dx * c_mic[6]);
    dy -= c_mic[2] * rintf(dy * c_mic[7]);
    dz -= c_mic[5] * rintf(dz * c_mic[8]);
  }
  return dx * dx + dy * dy + dz * dz;
}

// The slot test: live (both atoms real, not the same atom, inside cut_max,
// not excluded) and the 1-4 flag. Exclusion bits live in atom-id space:
// offset d = id_j - id_i + 32 indexes the i-atom's two 32-bit words.
__device__ __forceinline__ bool slot_live(const LaunchSpec& p, int idi,
                                          int idj, int4 bi, float r2,
                                          bool& special) {
  const int d = idj - idi + 32;
  const bool in_win = static_cast<unsigned>(d) < 64u;
  const int sh = d & 31;
  const int ew = d < 32 ? bi.x : bi.y;
  const int sw = d < 32 ? bi.z : bi.w;
  special = in_win && ((sw >> sh) & 1);
  return idi < p.n_atoms && idj < p.n_atoms && idi != idj && r2 < p.cut2 &&
         !(in_win && ((ew >> sh) & 1));
}

// Per-lane energy and virial sums (f32) of a thread's pairs.
struct EnergyVirial {
  float e = 0.f, xx = 0.f, xy = 0.f, xz = 0.f, yy = 0.f, yz = 0.f, zz = 0.f;
  __device__ __forceinline__ void add(float en, float coef, float dx,
                                      float dy, float dz) {
    e += en;
    xx -= coef * dx * dx;
    xy -= coef * dx * dy;
    xz -= coef * dx * dz;
    yy -= coef * dy * dy;
    yz -= coef * dy * dz;
    zz -= coef * dz * dz;
  }
};

// One warp's shared memory: the tile's rows (j side for the slot test and
// both sides' parameters for the pair terms), and for the compacted loop
// (QUEUE) the queue of live slots and the i- and j-force accumulators.
template <bool LAM, bool QUEUE>
struct WarpTile {
  float4 jpos[kWarp];          // x, y, z, q of cluster J
  float2 jlj[kWarp];           // sigma, sqrt(eps) of cluster J
  float2 ilj[kWarp];           // and of cluster I
  float iq[kWarp];             // charges of cluster I
  int jid[kWarp];              // atom ids of cluster J
  float2 ilr[LAM ? kWarp : 1]; // (lambda, role) rows of I and J (K1c)
  float2 jlr[LAM ? kWarp : 1];
  // dx, dy, dz, code (i lane, j lane, 1-4)
  float4 queue[QUEUE ? kQueue<LAM> : 1];
  int iid[QUEUE ? kWarp : 1];      // atom ids of cluster I
  int qi[3][QUEUE ? kWarp : 1];    // fixed-point force sums of I and J:
  int qj[3][QUEUE ? kWarp : 1];    // high words
  int ri[3][QUEUE ? kWarp : 1];    // and low words
  int rj[3][QUEUE ? kWarp : 1];
};

// The pair terms of one slot: the probe's stand-in or the real terms.
template <int COUL_MODE, bool LAM, int PROBE>
__device__ __forceinline__ void slot_terms(const LaunchSpec& p, float r2,
                                           bool special, float2 li,
                                           float qi, float2 ljj, float qj,
                                           float2 lri, float2 lrj,
                                           float& e, float& coef) {
  if constexpr (PROBE == kDistanceOnly) {
    e = 0.f;
    coef = r2 * 1e-12f;
  } else {
    pair_terms<COUL_MODE, LAM>(p, r2, special, li, qi, ljj, qj, lri, lrj, e,
                               coef);
  }
}

// The in-place tile loop, for instances whose pair terms are cheap beside
// the bookkeeping of a queue: lane t owns i-atom t and meets
// j = (t + k) & 31 at rotation step k; the pair terms run on the live lanes
// of each step; the j-force accumulator moves one lane down per step (a
// warp shuffle), so after 32 steps lane t holds the j-side force of J's
// atom t. A self tile evaluates both orderings of every pair at weight 0.5
// for energy and virial and emits no j-forces. No probe instance runs it.
template <int COUL_MODE, bool TRICLINIC, bool COMPUTE_ENERGY, bool LAM>
__device__ __forceinline__ void rotate_tile(
    const LaunchSpec& p, WarpTile<LAM, false>& t, int lane, bool self_tile,
    float4 pi, int idi, int4 bi, float* __restrict__ forces,
    EnergyVirial& ev) {
  float fix = 0.f, fiy = 0.f, fiz = 0.f;
  float fjx = 0.f, fjy = 0.f, fjz = 0.f;
  EnergyVirial tile_ev;
  const float2 li = t.ilj[lane];
  float2 lri = make_float2(1.f, 0.f);
  if constexpr (LAM) lri = t.ilr[lane];
#pragma unroll 4
  for (int k = 0; k < kWarp; ++k) {
    const int jl = (lane + k) & (kWarp - 1);
    const float4 pj = t.jpos[jl];
    float dx, dy, dz;
    const float r2 = min_image<TRICLINIC>(pi, pj, dx, dy, dz);
    bool special;
    const bool live = slot_live(p, idi, t.jid[jl], bi, r2, special);
    float coef = 0.f, e = 0.f;
    if (live) {
      float2 lrj = lri;
      if constexpr (LAM) lrj = t.jlr[jl];
      pair_terms<COUL_MODE, LAM>(p, r2, special, li, pi.w, t.jlj[jl], pj.w,
                                 lri, lrj, e, coef);
    }
    fix += coef * dx;
    fiy += coef * dy;
    fiz += coef * dz;
    if (!self_tile) {
      fjx -= coef * dx;
      fjy -= coef * dy;
      fjz -= coef * dz;
    }
    if (COMPUTE_ENERGY) tile_ev.add(e, coef, dx, dy, dz);
    // hand the j accumulator to the lane that meets this j next step
    const int src = (lane + 1) & (kWarp - 1);
    fjx = __shfl_sync(kFull, fjx, src);
    fjy = __shfl_sync(kFull, fjy, src);
    fjz = __shfl_sync(kFull, fjz, src);
  }
  if (idi < p.n_atoms) {
    atomicAdd(forces + 3 * idi + 0, fix);
    atomicAdd(forces + 3 * idi + 1, fiy);
    atomicAdd(forces + 3 * idi + 2, fiz);
  }
  const int idj_own = t.jid[lane];  // after 32 hand-offs: j = lane
  if (!self_tile && idj_own < p.n_atoms) {
    atomicAdd(forces + 3 * idj_own + 0, fjx);
    atomicAdd(forces + 3 * idj_own + 1, fjy);
    atomicAdd(forces + 3 * idj_own + 2, fjz);
  }
  if (COMPUTE_ENERGY) {
    const float w = self_tile ? 0.5f : 1.0f;
    ev.e += w * tile_ev.e;
    ev.xx += w * tile_ev.xx;
    ev.xy += w * tile_ev.xy;
    ev.xz += w * tile_ev.xz;
    ev.yy += w * tile_ev.yy;
    ev.yz += w * tile_ev.yz;
    ev.zz += w * tile_ev.zz;
  }
}

// Phase B of the compacted loop: queue entries head .. head + count - 1
// (count <= 32), one per lane; their forces go into the warp's fixed-point
// accumulators by shared-memory integer atomics (native; an f32 atomicAdd
// on shared memory is a compare-and-swap loop), or, for a pair force with
// a component above fixed_max or not finite, straight to global memory.
// noocc's cross tiles add no j side at all: neither to the shared j
// accumulators nor, at the flush, to global memory.
template <int COUL_MODE, bool COMPUTE_ENERGY, bool LAM, int PROBE>
__device__ __forceinline__ void drain(const LaunchSpec& p,
                                      WarpTile<LAM, true>& t, int lane,
                                      unsigned head, unsigned count,
                                      bool self_tile,
                                      float* __restrict__ forces,
                                      EnergyVirial& ev) {
  if (static_cast<unsigned>(lane) >= count) return;
  const float4 q = t.queue[(head + lane) & (kQueue<LAM> - 1)];
  const int code = __float_as_int(q.w);
  const int a = code & (kWarp - 1);
  const int b = (code >> 5) & (kWarp - 1);
  const float r2 = q.x * q.x + q.y * q.y + q.z * q.z;
  float2 lri = make_float2(1.f, 0.f), lrj = lri;
  if constexpr (LAM) {
    lri = t.ilr[a];
    lrj = t.jlr[b];
  }
  float e, coef;
  slot_terms<COUL_MODE, LAM, PROBE>(p, r2, (code >> 10) & 1, t.ilj[a],
                                    t.iq[a], t.jlj[b], t.jpos[b].w, lri, lrj,
                                    e, coef);
  const float fx = coef * q.x, fy = coef * q.y, fz = coef * q.z;
  if (COMPUTE_ENERGY) ev.add(e, coef, q.x, q.y, q.z);
  constexpr float kMax = fixed_max(PROBE), kScale = fixed_scale(PROBE);
  if (fabsf(fx) <= kMax && fabsf(fy) <= kMax && fabsf(fz) <= kMax) {
    const float f[3] = {fx, fy, fz};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // f - h / S is exact (Sterbenz), so the two words lose only the low
      // word's rounding
      const float h = rintf(f[c] * kScale);
      const int hi = static_cast<int>(h);
      const int lo = __float2int_rn((f[c] - h / kScale) * kScale * 0x1p24f);
      atomicAdd(&t.qi[c][a], hi);
      atomicAdd(&t.ri[c][a], lo);
      if (PROBE != kNoOcc || self_tile) {
        atomicAdd(&t.qj[c][b], -hi);
        atomicAdd(&t.rj[c][b], -lo);
      }
    }
  } else {
    float* fi = forces + 3 * t.iid[a];
    atomicAdd(fi + 0, fx);
    atomicAdd(fi + 1, fy);
    atomicAdd(fi + 2, fz);
    if (PROBE != kNoOcc || self_tile) {
      float* fj = forces + 3 * t.jid[b];
      atomicAdd(fj + 0, -fx);
      atomicAdd(fj + 1, -fy);
      atomicAdd(fj + 2, -fz);
    }
  }
}

// The compacted tile loop, for instances whose pair terms are expensive.
// Phase A: the slot test over the 32 rotation steps (lane t meets
// j = (t + k) & 31 at step k); live slots join the queue in order, and
// every 32 of them are drained at once (phase B). A self tile keeps each
// pair once (j lane above i lane) and adds both forces to the one cluster.
template <int COUL_MODE, bool TRICLINIC, bool COMPUTE_ENERGY, bool LAM,
          int PROBE>
__device__ __forceinline__ void compact_tile(
    const LaunchSpec& p, WarpTile<LAM, true>& t, int lane, bool self_tile,
    float4 pi, int idi, int4 bi, float* __restrict__ forces,
    EnergyVirial& ev) {
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    t.qi[c][lane] = 0;
    t.qj[c][lane] = 0;
    t.ri[c][lane] = 0;
    t.rj[c][lane] = 0;
  }
  t.iid[lane] = idi;
  unsigned head = 0, tail = 0;  // warp-uniform ring positions
  for (int k0 = 0; k0 < kWarp; k0 += kGroup<LAM>) {
#pragma unroll
    for (int k = k0; k < k0 + kGroup<LAM>; ++k) {
      const int jl = (lane + k) & (kWarp - 1);
      float dx, dy, dz;
      const float r2 = min_image<TRICLINIC>(pi, t.jpos[jl], dx, dy, dz);
      bool special;
      const bool live = slot_live(p, idi, t.jid[jl], bi, r2, special) &&
                        (!self_tile || jl > lane);
      const unsigned m = __ballot_sync(kFull, live);
      const unsigned slot =
          (tail + __popc(m & lanes_below)) & (kQueue<LAM> - 1);
      const int code = lane | (jl << 5) | (special ? 1 << 10 : 0);
      const float4 entry = make_float4(dx, dy, dz, __int_as_float(code));
      if (live) t.queue[slot] = entry;
      tail += __popc(m);
    }
    if (tail - head >= kWarp) {
      __syncwarp();  // the queue entries are visible to every lane
      do {
        drain<COUL_MODE, COMPUTE_ENERGY, LAM, PROBE>(
            p, t, lane, head, kWarp, self_tile, forces, ev);
        head += kWarp;
      } while (tail - head >= kWarp);
      __syncwarp();  // drained slots are read before they are reused
    }
  }
  if (tail == 0) return;  // no live slot: nothing to add
  __syncwarp();
  drain<COUL_MODE, COMPUTE_ENERGY, LAM, PROBE>(p, t, lane, head,
                                               tail - head, self_tile, forces,
                                               ev);
  __syncwarp();

  // one global atomic per atom and component; a self tile's j side is its
  // own i side
  constexpr float kUnit = 1.f / fixed_scale(PROBE);
  constexpr float kLowUnit = kUnit * 0x1p-24f;
  float f[3], g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f[c] = static_cast<float>(t.qi[c][lane]) * kUnit +
           static_cast<float>(t.ri[c][lane]) * kLowUnit;
    g[c] = static_cast<float>(t.qj[c][lane]) * kUnit +
           static_cast<float>(t.rj[c][lane]) * kLowUnit;
    if (self_tile) f[c] += g[c];
  }
  if (idi < p.n_atoms && (f[0] != 0.f || f[1] != 0.f || f[2] != 0.f)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(forces + 3 * idi + c, f[c]);
  }
  const int idj_own = t.jid[lane];
  if (PROBE != kNoOcc && !self_tile && idj_own < p.n_atoms &&
      (g[0] != 0.f || g[1] != 0.f || g[2] != 0.f)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(forces + 3 * idj_own + c, g[c]);
  }
}

template <int COUL_MODE, bool TRICLINIC, bool COMPUTE_ENERGY, bool LAM,
          int PROBE>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pair_nonbonded_kernel(const float4* __restrict__ pos,   // x, y, z, q
                      const float2* __restrict__ lj,    // sigma, sqrt(eps)
                      const int* __restrict__ ids,      // atom id or n_atoms
                      const int4* __restrict__ bits,    // excl w0/w1, spec w0/w1
                      const int2* __restrict__ pairs,   // cluster I, J
                      const float2* __restrict__ lam_role,  // K1c only
                      const __grid_constant__ LaunchSpec p,
                      float* __restrict__ forces,
                      double* __restrict__ energy_virial) {
  // the compacted loop pays off where the pair terms cost more than the
  // queue: under the Ewald screen and on the lambda path
  constexpr bool kCompact = LAM || COUL_MODE == 3;
  __shared__ WarpTile<LAM, kCompact> s_tiles[kWarpsPerBlock];
  __shared__ float s_ev[kWarpsPerBlock][7];

  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  WarpTile<LAM, kCompact>& t = s_tiles[w];
  EnergyVirial ev;
  const int pair = blockIdx.x * kWarpsPerBlock + w;
  if (pair < p.n_pairs) {  // uniform across the warp
    const int2 ij = pairs[pair];
    const bool self_tile = ij.x == ij.y;
    const int si = ij.x * kWarp + lane;
    const int sj = ij.y * kWarp + lane;
    const float4 pi = pos[si];
    const int idi = ids[si];
    const int4 bi = bits[si];
    t.jpos[lane] = pos[sj];
    t.jlj[lane] = lj[sj];
    t.jid[lane] = ids[sj];
    t.ilj[lane] = lj[si];
    t.iq[lane] = pi.w;
    if constexpr (LAM) {
      t.ilr[lane] = lam_role[si];
      t.jlr[lane] = lam_role[sj];
    }
    __syncwarp();
    if constexpr (PROBE == kGatherOnly) {
      // touch every row so no load is dead; positions are never NaN
      const float4 pj = t.jpos[lane];
      float u = pi.x + pi.y + pi.z + pj.x + pj.y + pj.z + pj.w +
                t.jlj[lane].x + t.jlj[lane].y + t.ilj[lane].x +
                t.ilj[lane].y + t.iq[lane] +
                static_cast<float>(idi + t.jid[lane] + bi.x + bi.y + bi.z +
                                   bi.w);
      if constexpr (LAM) u += t.ilr[lane].x + t.jlr[lane].y;
      if (u != u) atomicAdd(forces, 0.f);
    } else if constexpr (kCompact) {
      compact_tile<COUL_MODE, TRICLINIC, COMPUTE_ENERGY, LAM, PROBE>(
          p, t, lane, self_tile, pi, idi, bi, forces, ev);
    } else {
      static_assert(PROBE == 0, "the probes run the compacted loop");
      rotate_tile<COUL_MODE, TRICLINIC, COMPUTE_ENERGY, LAM>(
          p, t, lane, self_tile, pi, idi, bi, forces, ev);
    }
  }

  if (COMPUTE_ENERGY) {
    // f32 within a warp, double across the block's warps: 7 double
    // atomics per block
    float acc[7] = {ev.e, ev.xx, ev.xy, ev.xz, ev.yy, ev.yz, ev.zz};
#pragma unroll
    for (int c = 0; c < 7; ++c) {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        acc[c] += __shfl_down_sync(kFull, acc[c], off);
      if (lane == 0) s_ev[w][c] = acc[c];
    }
    __syncthreads();
    if (threadIdx.x < 7) {
      double sum = 0.0;
#pragma unroll
      for (int v = 0; v < kWarpsPerBlock; ++v) sum += s_ev[v][threadIdx.x];
      atomicAdd(energy_virial + threadIdx.x, sum);
    }
  }
}

struct Args {
  const float4* pos;
  const float2* lj;
  const int* ids;
  const int4* bits;
  const int2* pairs;
  const float2* lam_role;
  float* forces;
  double* ev;
  cudaStream_t stream;
};

template <int COUL_MODE, bool TRICLINIC, bool COMPUTE_ENERGY, bool LAM,
          int PROBE = 0>
void launch(const Args& a, const LaunchSpec& p) {
  const dim3 grid((p.n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  pair_nonbonded_kernel<COUL_MODE, TRICLINIC, COMPUTE_ENERGY, LAM, PROBE>
      <<<grid, kWarp * kWarpsPerBlock, 0, a.stream>>>(
          a.pos, a.lj, a.ids, a.bits, a.pairs, a.lam_role, p, a.forces,
          a.ev);
}

template <int COUL_MODE, bool LAM>
void launch_coul(const Args& a, const LaunchSpec& p) {
  if (p.triclinic) {
    if (p.compute_energy) launch<COUL_MODE, true, true, LAM>(a, p);
    else launch<COUL_MODE, true, false, LAM>(a, p);
  } else {
    if (p.compute_energy) launch<COUL_MODE, false, true, LAM>(a, p);
    else launch<COUL_MODE, false, false, LAM>(a, p);
  }
}

template <bool LAM>
void launch_lam(const Args& a, const LaunchSpec& p) {
  // the probes: forces-only Ewald, orthorhombic (checked by the caller)
  switch (p.probe) {
    case kGatherOnly: return launch<3, false, false, LAM, kGatherOnly>(a, p);
    case kDistanceOnly:
      return launch<3, false, false, LAM, kDistanceOnly>(a, p);
    case kNoOcc: return launch<3, false, false, LAM, kNoOcc>(a, p);
    default: break;
  }
  switch (p.coul_mode) {
    case 0: launch_coul<0, LAM>(a, p); break;
    case 1: launch_coul<1, LAM>(a, p); break;
    case 2: launch_coul<2, LAM>(a, p); break;
    default: launch_coul<3, LAM>(a, p); break;
  }
}

}  // namespace

// Launch on `stream`. forces (n_atoms, 3) f32 and energy_virial (7) f64 must
// be zeroed by the caller; energy_virial may be null when compute_energy is
// 0, lam_role (one (lambda, role) float2 per slot) when use_lam is 0. mic
// is the box's 9 floats in device memory, copied to the kernel's constant
// memory on `stream` before the launch. `spec` is read on the host before
// the launch. Returns the copy's error, cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a mode outside the table.
extern "C" int pair_nonbonded_launch(const void* pos, const void* lj,
                                     const void* ids, const void* bits,
                                     const void* pairs, const void* lam_role,
                                     const void* mic, const void* spec,
                                     void* forces, void* energy_virial,
                                     void* stream) {
  const LaunchSpec p = *static_cast<const LaunchSpec*>(spec);
  if (p.lj_mode < 0 || p.lj_mode > 4 || p.coul_mode < 0 || p.coul_mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.use_lam &&
      (lam_role == nullptr || p.lj_kind < 0 || p.lj_kind > 2 ||
       p.coul_sc < 0 || p.coul_sc > 2 || p.scheduler < 0 ||
       p.scheduler > 3 || (p.coul_sc != 0 && p.coul_mode % 2 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.probe < 0 || p.probe > kNoOcc ||
      (p.probe && (p.coul_mode != 3 || p.triclinic || p.compute_energy)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mic == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_pairs <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t copied = cudaMemcpyToSymbolAsync(
      c_mic, mic, sizeof(c_mic), 0, cudaMemcpyDeviceToDevice,
      static_cast<cudaStream_t>(stream));
  if (copied != cudaSuccess) return static_cast<int>(copied);
  const Args a{static_cast<const float4*>(pos),
               static_cast<const float2*>(lj),
               static_cast<const int*>(ids),
               static_cast<const int4*>(bits),
               static_cast<const int2*>(pairs),
               static_cast<const float2*>(lam_role),
               static_cast<float*>(forces),
               static_cast<double*>(energy_virial),
               static_cast<cudaStream_t>(stream)};
  if (p.use_lam) launch_lam<true>(a, p);
  else launch_lam<false>(a, p);
  return static_cast<int>(cudaGetLastError());
}
