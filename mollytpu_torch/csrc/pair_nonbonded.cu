// Nonbonded pair kernel K1a: Lennard-Jones (1.0 nm distance cutoff,
// Lorentz-Berthelot mixing) plus Ewald real-space Coulomb, with windowed
// exclusion / 1-4 bitmaps, over a list of 32 x 32 atom-cluster pairs.
//
// Replaces mollytpu/ops/pallas_pairwise.py::_kernel (launched by
// pallas_block_nonbonded) for lj_mode=1, coul_mode=3, orthorhombic boxes and
// no alchemical lambda. The plain PyTorch twin is
// mollytpu_torch/ops/pair_kernel.py::pair_nonbonded_plain.
//
// What bounds it on an H100: per-pair FP32 arithmetic and the special
// functions (sqrt, erfc, exp) of the ~1024 slots of every listed cluster
// pair, most of which lie outside the cutoff, plus the force atomics.
// Design: one warp per cluster pair. Lane t owns i-atom t of cluster I; the
// 32 j-atoms of cluster J sit in shared memory and are visited in rotation
// (lane t meets j = (t + k) & 31 at step k), so every step pairs 32 distinct
// (i, j). Each lane also carries one j-force accumulator that moves one lane
// down per step (a warp shuffle), so after 32 steps lane t holds the whole
// j-side force of atom J*32 + t: each j-force costs one atomic per tile.
// The self tile (I == J) evaluates both orderings of every pair at weight
// 0.5 for energy and virial and emits no j-forces.
//
// Conventions (as the TPU kernel): coef = (dU/dr)/r, f_i += coef (x_j - x_i),
// f_j -= coef (x_j - x_i), virial -= coef dx (x) dx. Forces land by atomicAdd
// in the ORIGINAL atom order (ids[slot] is the atom id, n_atoms for padding).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int n_pairs;
  int n_atoms;
  float bx, by, bz;     // periodic side lengths, 0 for an open axis
  float ibx, iby, ibz;  // their inverses, 0 for an open axis
  float cut2;           // interaction cutoff squared
  float ke;             // Coulomb constant
  float alpha;          // Ewald splitting parameter
  float lj_w;           // LJ weight of 1-4 pairs
  float coul_w;         // Coulomb weight of 1-4 pairs
};

template <bool COMPUTE_ENERGY>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pair_nonbonded_kernel(const float4* __restrict__ pos,   // x, y, z, q
                      const float2* __restrict__ lj,    // sigma, sqrt(eps)
                      const int* __restrict__ ids,      // atom id or n_atoms
                      const int4* __restrict__ bits,    // excl w0/w1, spec w0/w1
                      const int2* __restrict__ pairs,   // cluster I, J
                      Params p, float* __restrict__ forces,
                      double* __restrict__ energy_virial) {
  __shared__ float4 s_pos[kWarpsPerBlock][kWarp];
  __shared__ float2 s_lj[kWarpsPerBlock][kWarp];
  __shared__ int s_id[kWarpsPerBlock][kWarp];

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
    dx -= p.bx * rintf(dx * p.ibx);
    dy -= p.by * rintf(dy * p.iby);
    dz -= p.bz * rintf(dz * p.ibz);
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
      // LJ: hydrogens carry eps = 0; skipping the term (rather than
      // multiplying by 0) keeps a huge (sigma/r)^12 from making 0 * inf
      const float eps = li.y * ljj.y;
      if (eps != 0.f) {
        const float sig = 0.5f * (li.x + ljj.x);
        const float s2 = sig * sig * inv_r2;
        const float six = s2 * s2 * s2;
        const float twelve = six * six;
        const float wl = special ? p.lj_w : 1.0f;
        e = 4.0f * eps * (twelve - six) * wl;
        coef = -24.0f * eps * (2.0f * twelve - six) * inv_r2 * wl;
      }
      const float keqq = p.ke * pi.w * pj.w;
      if (special) {
        // 1-4 pairs: plain Coulomb times the 1-4 weight; their reciprocal
        // part is removed by the Ewald exclusion correction
        e += keqq * inv_r * p.coul_w;
        coef -= keqq * inv_r2 * inv_r * p.coul_w;
      } else {
        const float ar = p.alpha * r2 * inv_r;
        const float erfc_ar = erfcf(ar);
        const float ex = expf(-ar * ar);
        e += keqq * erfc_ar * inv_r;
        coef -= keqq * inv_r2 * (erfc_ar * inv_r + two_a_rsqrtpi * ex);
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

}  // namespace

// Launch on `stream`. forces (n_atoms, 3) f32 and energy_virial (7) f64 must
// be zeroed by the caller; energy_virial may be null when compute_energy is
// 0. Returns cudaGetLastError() after the launch.
extern "C" int pair_nonbonded_launch(
    const void* pos, const void* lj, const void* ids, const void* bits,
    const void* pairs, int n_pairs, int n_atoms, float bx, float by,
    float bz, float ibx, float iby, float ibz, float cut2, float ke,
    float alpha, float lj_w, float coul_w, void* forces,
    void* energy_virial, int compute_energy, void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaSuccess);
  Params p{n_pairs, n_atoms, bx, by, bz, ibx, iby, ibz, cut2, ke, alpha,
           lj_w, coul_w};
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pos4 = static_cast<const float4*>(pos);
  const auto* lj2 = static_cast<const float2*>(lj);
  const auto* id = static_cast<const int*>(ids);
  const auto* bit4 = static_cast<const int4*>(bits);
  const auto* pr = static_cast<const int2*>(pairs);
  auto* f = static_cast<float*>(forces);
  auto* ev = static_cast<double*>(energy_virial);
  if (compute_energy) {
    pair_nonbonded_kernel<true><<<grid, block, 0, s>>>(pos4, lj2, id, bit4,
                                                       pr, p, f, ev);
  } else {
    pair_nonbonded_kernel<false><<<grid, block, 0, s>>>(pos4, lj2, id, bit4,
                                                        pr, p, f, ev);
  }
  return static_cast<int>(cudaGetLastError());
}
