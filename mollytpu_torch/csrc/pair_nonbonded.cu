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
// What bounds it on an H100: FP32 arithmetic and the special-function unit
// (sqrt and reciprocal for every live pair; erfc and exp under Ewald) on the
// listed slots, about 10% of which lie inside the cutoff, plus the force
// atomics. The bytes it must move (~1 MB at 16k atoms) take well under a
// microsecond. The soft-core terms of K1c add FP32 work and special
// functions per live pair: a log/exp pair for rQ^(-1/6) (Beutler Coulomb) or
// r_Q (Gapsys Coulomb), another for the Gapsys LJ radius r_LJ, the
// Abramowitz-Stegun erfc's reciprocal and exp, and the reciprocals of R6.
// Design: one warp per cluster pair, so the cutoff test and the
// exclusion bits cost a few integer and FP32 operations per slot while the
// pair terms run only for live slots (divergent lanes idle). Lane t owns
// i-atom t of cluster I; the 32 j-atoms of cluster J sit in shared memory
// and are visited in rotation (lane t meets j = (t + k) & 31 at step k), so
// every step pairs 32 distinct (i, j). Each lane also carries one j-force
// accumulator that moves one lane down per step (a warp shuffle), so after
// 32 steps lane t holds the whole j-side force of atom J*32 + t: each
// j-force costs one atomic per tile. The self tile (I == J) evaluates both
// orderings of every pair at weight 0.5 for energy and virial and emits no
// j-forces. Energy and virial are summed per warp in f32 and across warps
// in double. K1c keeps that loop: the j-atoms' (lambda, role) rows sit in
// shared memory beside their LJ rows, the lambda block and the soft-core
// terms run only for live slots, and soft-cored terms that are switched off
// (lambda_s or lambda_e 0) are skipped by a branch, not computed and masked;
// the LJ kind, the soft-core Coulomb kind and the scheduler are
// warp-uniform runtime parameters. Culling dead tiles, staging j-clusters
// across tiles and fewer atomics are later work; so is trimming K1c's
// special functions.
//
// Instances: templated on what changes the inner loop, the lambda path,
// the Coulomb mode, the box shape and the energy output (2 x 4 x 2 x 2).
// The LJ mode, the LJ and Coulomb soft-core kinds, the scheduler and every
// constant are warp-uniform runtime parameters. Without the lambda path an
// instance compiles to the code it had before K1c existed.
//
// Conventions (as the TPU kernel): coef = (dU/dr)/r, f_i += coef (x_j - x_i),
// f_j -= coef (x_j - x_i), virial -= coef dx (x) dx. Forces land by atomicAdd
// in the ORIGINAL atom order (ids[slot] is the atom id, n_atoms for padding).
// Minimum image: back-substitution over the lower-triangular box rows a =
// (h11, 0, 0), b = (h21, h22, 0), c = (h31, h32, h33): round out the c
// image, then b, then a; an orthorhombic box rounds each axis on its own,
// and an open axis has side and inverse 0. Roles ride as floats (0 core,
// 1 insert, 2 delete), as in the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

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
  float mic[9];        // h11 h21 h22 h31 h32 h33 1/h11 1/h22 1/h33
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

template <int COUL_MODE, bool TRICLINIC, bool COMPUTE_ENERGY, bool LAM>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pair_nonbonded_kernel(const float4* __restrict__ pos,   // x, y, z, q
                      const float2* __restrict__ lj,    // sigma, sqrt(eps)
                      const int* __restrict__ ids,      // atom id or n_atoms
                      const int4* __restrict__ bits,    // excl w0/w1, spec w0/w1
                      const int2* __restrict__ pairs,   // cluster I, J
                      const float2* __restrict__ lam_role,  // K1c only
                      const LaunchSpec p, float* __restrict__ forces,
                      double* __restrict__ energy_virial) {
  __shared__ float4 s_pos[kWarpsPerBlock][kWarp];
  __shared__ float2 s_lj[kWarpsPerBlock][kWarp];
  __shared__ int s_id[kWarpsPerBlock][kWarp];
  __shared__ float2 s_lr[kWarpsPerBlock][LAM ? kWarp : 1];

  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const int pair = blockIdx.x * kWarpsPerBlock + w;
  if (pair >= p.n_pairs) return;  // uniform across the warp

  const int2 ij = pairs[pair];
  const bool self_tile = ij.x == ij.y;
  const int si = ij.x * kWarp + lane;
  const int sj = ij.y * kWarp + lane;

  const float4 pi = pos[si];
  const float2 li = lj[si];
  const int idi = ids[si];
  const int4 bi = bits[si];
  s_pos[w][lane] = pos[sj];
  s_lj[w][lane] = lj[sj];
  s_id[w][lane] = ids[sj];
  float2 lri = make_float2(1.f, 0.f);
  if constexpr (LAM) {
    lri = lam_role[si];
    s_lr[w][lane] = lam_role[sj];
  }
  __syncwarp();

  const bool i_real = idi < p.n_atoms;
  const float two_a_rsqrtpi = 2.0f * p.alpha * 0.56418958354775628f;
  float fix = 0.f, fiy = 0.f, fiz = 0.f;
  float fjx = 0.f, fjy = 0.f, fjz = 0.f;
  float e_acc = 0.f;
  float vxx = 0.f, vxy = 0.f, vxz = 0.f, vyy = 0.f, vyz = 0.f, vzz = 0.f;

#pragma unroll 4
  for (int k = 0; k < kWarp; ++k) {
    const int jl = (lane + k) & (kWarp - 1);
    const float4 pj = s_pos[w][jl];
    const float2 ljj = s_lj[w][jl];
    const int idj = s_id[w][jl];

    float dx = pj.x - pi.x;
    float dy = pj.y - pi.y;
    float dz = pj.z - pi.z;
    if (TRICLINIC) {
      const float s3 = rintf(dz * p.mic[8]);
      dx -= s3 * p.mic[3];
      dy -= s3 * p.mic[4];
      dz -= s3 * p.mic[5];
      const float s2 = rintf(dy * p.mic[7]);
      dx -= s2 * p.mic[1];
      dy -= s2 * p.mic[2];
      dx -= rintf(dx * p.mic[6]) * p.mic[0];
    } else {
      dx -= p.mic[0] * rintf(dx * p.mic[6]);
      dy -= p.mic[2] * rintf(dy * p.mic[7]);
      dz -= p.mic[5] * rintf(dz * p.mic[8]);
    }
    const float r2 = dx * dx + dy * dy + dz * dz;

    // exclusion bits live in atom-id space: offset d = id_j - id_i + 32
    const int d = idj - idi + 32;
    const bool in_win = static_cast<unsigned>(d) < 64u;
    const int sh = d & 31;
    const int ew = d < 32 ? bi.x : bi.y;
    const int sw = d < 32 ? bi.z : bi.w;
    const bool excl = in_win && ((ew >> sh) & 1);
    const bool special = in_win && ((sw >> sh) & 1);
    const bool live = i_real && idj < p.n_atoms && idi != idj &&
                      r2 < p.cut2 && !excl;

    float coef = 0.f;
    float e = 0.f;
    if (live) {
      const float inv_r = 1.0f / sqrtf(r2);
      const float inv_r2 = inv_r * inv_r;
      // the lambda block (pallas_pairwise.py:814-840): the smaller lambda
      // through the scheduler at the pair role, fully on inside one
      // perturbed group, no LJ where either atom's lambda is exactly 0
      float lam_s = 1.f, lam_e = 1.f;
      if constexpr (LAM) {
        const float2 lrj = s_lr[w][jl];
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
        const float keqq = p.ke * pi.w * pj.w;
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
                         (1.0f + p.coul_sigma_q * fabsf(pi.w * pj.w));
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
    fix += coef * dx;
    fiy += coef * dy;
    fiz += coef * dz;
    if (!self_tile) {
      fjx -= coef * dx;
      fjy -= coef * dy;
      fjz -= coef * dz;
    }
    if (COMPUTE_ENERGY) {
      e_acc += e;
      vxx -= coef * dx * dx;
      vxy -= coef * dx * dy;
      vxz -= coef * dx * dz;
      vyy -= coef * dy * dy;
      vyz -= coef * dy * dz;
      vzz -= coef * dz * dz;
    }
    // hand the j accumulator to the lane that meets this j next step
    const int src = (lane + 1) & (kWarp - 1);
    fjx = __shfl_sync(kFull, fjx, src);
    fjy = __shfl_sync(kFull, fjy, src);
    fjz = __shfl_sync(kFull, fjz, src);
  }

  if (i_real) {
    atomicAdd(forces + 3 * idi + 0, fix);
    atomicAdd(forces + 3 * idi + 1, fiy);
    atomicAdd(forces + 3 * idi + 2, fiz);
  }
  const int idj_own = s_id[w][lane];  // after 32 hand-offs: j = lane
  if (!self_tile && idj_own < p.n_atoms) {
    atomicAdd(forces + 3 * idj_own + 0, fjx);
    atomicAdd(forces + 3 * idj_own + 1, fjy);
    atomicAdd(forces + 3 * idj_own + 2, fjz);
  }
  if (COMPUTE_ENERGY) {
    float acc[7] = {e_acc, vxx, vxy, vxz, vyy, vyz, vzz};
#pragma unroll
    for (int c = 0; c < 7; ++c) {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        acc[c] += __shfl_down_sync(kFull, acc[c], off);
    }
    if (lane == 0) {
      const double wgt = self_tile ? 0.5 : 1.0;
#pragma unroll
      for (int c = 0; c < 7; ++c)
        atomicAdd(energy_virial + c, wgt * static_cast<double>(acc[c]));
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

template <int COUL_MODE, bool TRICLINIC, bool COMPUTE_ENERGY, bool LAM>
void launch(const Args& a, const LaunchSpec& p) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((p.n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  pair_nonbonded_kernel<COUL_MODE, TRICLINIC, COMPUTE_ENERGY, LAM>
      <<<grid, block, 0, a.stream>>>(a.pos, a.lj, a.ids, a.bits, a.pairs,
                                     a.lam_role, p, a.forces, a.ev);
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
// 0, lam_role (one (lambda, role) float2 per slot) when use_lam is 0.
// `spec` is read on the host before the launch. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a mode outside the table.
extern "C" int pair_nonbonded_launch(const void* pos, const void* lj,
                                     const void* ids, const void* bits,
                                     const void* pairs, const void* lam_role,
                                     const void* spec, void* forces,
                                     void* energy_virial, void* stream) {
  const LaunchSpec p = *static_cast<const LaunchSpec*>(spec);
  if (p.lj_mode < 0 || p.lj_mode > 4 || p.coul_mode < 0 || p.coul_mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.use_lam &&
      (lam_role == nullptr || p.lj_kind < 0 || p.lj_kind > 2 ||
       p.coul_sc < 0 || p.coul_sc > 2 || p.scheduler < 0 ||
       p.scheduler > 3 || (p.coul_sc != 0 && p.coul_mode % 2 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_pairs <= 0) return static_cast<int>(cudaSuccess);
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
