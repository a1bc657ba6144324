// SHAKE and RATTLE of rigid triangles, the TRIANGLE bucket of
// SHAKERattle (mollytpu_torch/ops/constraints.py): three atoms held at
// three distances, a rigid water. One thread per triangle runs the bucket's
// PyTorch solve on registers:
//
// - triangle_shake_kernel: the Newton iterations of the position solve
//   along the pre-step bond directions (rref_s = x0_i - x0_j of the
//   constraint s = (i, j), by the minimum image), each a closed-form 3 x 3
//   solve of A delta = res with A_st = 2 c_st (d_s . rref_t), then the
//   moves -sum_t sign(a, t) lambda_t / m_a rref_t onto the atoms (the
//   caller adds the implied velocity change (out - x1) / dt);
// - triangle_rattle_kernel: the one closed-form solve of the velocity
//   projection, C_st = (d_s . d_t) c_st against r_s = (v_i - v_j) . d_s.
//
// Replaces no Pallas kernel: the JAX package solves constraints in XLA. In
// PyTorch the bucket's solve is ~520 elementwise launches a call over
// (triangles,) tensors (a rigid water box's two calls a step are 1,040
// launches, ~30 ms of host time at 512,000 waters against ~4 ms of device
// work); here it is one launch a call. What bounds it on an H100: the
// bytes, 18 coordinates in and 9 out per triangle for SHAKE (9 and 9
// velocities for RATTLE), ~0.05 ms at 512,000 waters at 3.35 TB/s.
//
// Rounding: the same operations as the PyTorch solve in the same order
// where it is written term by term (the cofactor solve, the Newton
// update); dot products and the moves' sums are accumulated in the order
// the PyTorch code adds them. The minimum image is mic.cuh's, the box's
// mic_parts over its mic_tensors: in an orthorhombic box it is the
// displacement's to the bit; in a triclinic one the displacement sums the
// fractional products by matrix products, so the last bits may differ. It
// is the shortest image for a triangle's sides, far shorter than half the
// box's smallest width (so also where the box searches the 27 images,
// approx_images=False).

#include <cuda_runtime.h>

#include <cstdint>

#include "mic.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> load3(const T* __restrict__ p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

template <typename T>
__device__ __forceinline__ T dot(const V3<T>& a, const V3<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// x_i - x_j by the minimum image over the box as load_box lays it out
template <typename T, bool kTri>
__device__ __forceinline__ V3<T> image(const V3<T>& xi, const V3<T>& xj,
                                       const T* box) {
  V3<T> d{sub(xi.x, xj.x), sub(xi.y, xj.y), sub(xi.z, xj.z)};
  mic<T, kTri>(d.x, d.y, d.z, box);
  return d;
}

template <typename T>
__device__ __forceinline__ T guard(T x, T tiny) {
  return fabs(x) > tiny ? x : tiny;
}

// C k = r by cofactors, as constraints._solve_small for three constraints
template <typename T>
__device__ __forceinline__ void solve3(const T C[3][3], const T r[3],
                                       T k[3]) {
  const T a = C[0][0], bb = C[0][1], c = C[0][2];
  const T d = C[1][0], e = C[1][1], f = C[1][2];
  const T g = C[2][0], h = C[2][1], i = C[2][2];
  const T co00 = e * i - f * h, co01 = c * h - bb * i, co02 = bb * f - c * e;
  const T co10 = f * g - d * i, co11 = a * i - c * g, co12 = c * d - a * f;
  const T co20 = d * h - e * g, co21 = bb * g - a * h, co22 = a * e - bb * d;
  const T det = guard(a * co00 + bb * co10 + c * co20, T(1e-20));
  k[0] = (r[0] * co00 + r[1] * co01 + r[2] * co02) / det;
  k[1] = (r[0] * co10 + r[1] * co11 + r[2] * co12) / det;
  k[2] = (r[0] * co20 + r[1] * co21 + r[2] * co22) / det;
}

// the TRIANGLE pattern: constraint s joins slots (pi(s), pj(s)), (0, 1),
// (0, 2) and (1, 2); every loop over slots and constraints is unrolled, so
// these fold to constants and the per-triangle arrays stay in registers
__device__ __forceinline__ constexpr int pi(int s) { return s == 2 ? 1 : 0; }
__device__ __forceinline__ constexpr int pj(int s) { return s == 0 ? 1 : 2; }

// +1 if slot a is the i end of constraint t, -1 for the j end, else 0
__device__ __forceinline__ constexpr int sgn(int a, int t) {
  return a == pi(t) ? 1 : (a == pj(t) ? -1 : 0);
}

template <typename T>
__device__ __forceinline__ T inv_mass(const T* __restrict__ m, int64_t i) {
  const T mi = m[i];
  return mi > T(0) ? T(1) / mi : T(0);
}

template <typename T, bool kTri>
__global__ void triangle_shake_kernel(
    const T* __restrict__ x0, const T* __restrict__ x1, T* __restrict__ out,
    const int64_t* __restrict__ atoms, const T* __restrict__ dists,
    const T* __restrict__ masses, const T* __restrict__ box_a,
    const T* __restrict__ box_b, int64_t n_tri, int iters) {
  const int64_t c = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (c >= n_tri) return;
  int64_t at[3];
  V3<T> p0[3], p1[3];
  T im[3], d0[3];
  #pragma unroll
  for (int s = 0; s < 3; ++s) {
    at[s] = atoms[3 * c + s];
    p0[s] = load3(x0, at[s]);
    p1[s] = load3(x1, at[s]);
    im[s] = inv_mass(masses, at[s]);
    d0[s] = dists[3 * c + s];
  }
  T box[18];
  load_box<T, kTri>(box, box_a, box_b);
  V3<T> rref[3], drs[3];
  T cst[3][3];
  #pragma unroll
  for (int s = 0; s < 3; ++s) {
    rref[s] = image<T, kTri>(p0[pi(s)], p0[pj(s)], box);
    drs[s] = image<T, kTri>(p1[pi(s)], p1[pj(s)], box);
  }
  #pragma unroll
  for (int s = 0; s < 3; ++s)
    #pragma unroll
    for (int t = 0; t < 3; ++t)
      cst[s][t] = sgn(pi(s), t) * im[pi(s)] - sgn(pj(s), t) * im[pj(s)];
  T lam[3] = {T(0), T(0), T(0)};
  for (int it = 0; it < iters; ++it) {
    T res[3], A[3][3], delta[3];
    #pragma unroll
    for (int s = 0; s < 3; ++s) {
      res[s] = dot(drs[s], drs[s]) - d0[s] * d0[s];
      #pragma unroll
      for (int t = 0; t < 3; ++t)
        A[s][t] = T(2) * cst[s][t] * dot(drs[s], rref[t]);
    }
    solve3(A, res, delta);
    #pragma unroll
    for (int s = 0; s < 3; ++s) lam[s] += delta[s];
    #pragma unroll
    for (int s = 0; s < 3; ++s) {
      V3<T> sum{T(0), T(0), T(0)};
      #pragma unroll
      for (int t = 0; t < 3; ++t) {
        const T w = delta[t] * cst[s][t];
        sum.x += w * rref[t].x;
        sum.y += w * rref[t].y;
        sum.z += w * rref[t].z;
      }
      drs[s].x -= sum.x;
      drs[s].y -= sum.y;
      drs[s].z -= sum.z;
    }
  }
  #pragma unroll
  for (int a = 0; a < 3; ++a) {
    V3<T> acc{T(0), T(0), T(0)};
    #pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int w = sgn(a, t);
      if (w) {
        const T f = w * lam[t] * im[a];
        acc.x -= f * rref[t].x;
        acc.y -= f * rref[t].y;
        acc.z -= f * rref[t].z;
      }
    }
    const int64_t i = at[a];
    out[3 * i] = p1[a].x + acc.x;
    out[3 * i + 1] = p1[a].y + acc.y;
    out[3 * i + 2] = p1[a].z + acc.z;
  }
}

template <typename T, bool kTri>
__global__ void triangle_rattle_kernel(
    const T* __restrict__ x, const T* __restrict__ v_in,
    T* __restrict__ v_out, const int64_t* __restrict__ atoms,
    const T* __restrict__ masses, const T* __restrict__ box_a,
    const T* __restrict__ box_b, int64_t n_tri) {
  const int64_t c = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (c >= n_tri) return;
  int64_t at[3];
  V3<T> p[3], v[3];
  T im[3];
  #pragma unroll
  for (int s = 0; s < 3; ++s) {
    at[s] = atoms[3 * c + s];
    p[s] = load3(x, at[s]);
    v[s] = load3(v_in, at[s]);
    im[s] = inv_mass(masses, at[s]);
  }
  T box[18];
  load_box<T, kTri>(box, box_a, box_b);
  V3<T> drs[3];
  T r[3], C[3][3], ks[3];
  #pragma unroll
  for (int s = 0; s < 3; ++s) {
    drs[s] = image<T, kTri>(p[pi(s)], p[pj(s)], box);
    const V3<T> dv{v[pi(s)].x - v[pj(s)].x, v[pi(s)].y - v[pj(s)].y,
                   v[pi(s)].z - v[pj(s)].z};
    r[s] = dot(dv, drs[s]);
  }
  #pragma unroll
  for (int s = 0; s < 3; ++s)
    #pragma unroll
    for (int t = 0; t < 3; ++t)
      C[s][t] = dot(drs[s], drs[t])
                * (sgn(pi(s), t) * im[pi(s)] - sgn(pj(s), t) * im[pj(s)]);
  solve3(C, r, ks);
  #pragma unroll
  for (int a = 0; a < 3; ++a) {
    V3<T> acc{T(0), T(0), T(0)};
    #pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int sign = a == pi(s) ? -1 : (a == pj(s) ? 1 : 0);
      if (sign) {
        const T f = sign * ks[s] * im[a];
        acc.x += f * drs[s].x;
        acc.y += f * drs[s].y;
        acc.z += f * drs[s].z;
      }
    }
    const int64_t i = at[a];
    v_out[3 * i] = v[a].x + acc.x;
    v_out[3 * i + 1] = v[a].y + acc.y;
    v_out[3 * i + 2] = v[a].z + acc.z;
  }
}

template <typename T, bool kTri>
int shake(const void* x0, const void* x1, void* out, const void* atoms,
          const void* dists, const void* masses, const void* box_a,
          const void* box_b, int64_t n_tri, int iters, cudaStream_t s) {
  const int64_t blocks = (n_tri + kThreads - 1) / kThreads;
  triangle_shake_kernel<T, kTri>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const T*>(x0), static_cast<const T*>(x1),
          static_cast<T*>(out), static_cast<const int64_t*>(atoms),
          static_cast<const T*>(dists), static_cast<const T*>(masses),
          static_cast<const T*>(box_a), static_cast<const T*>(box_b), n_tri,
          iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTri>
int rattle(const void* x, const void* v_in, void* v_out, const void* atoms,
           const void* masses, const void* box_a, const void* box_b,
           int64_t n_tri, cudaStream_t s) {
  const int64_t blocks = (n_tri + kThreads - 1) / kThreads;
  triangle_rattle_kernel<T, kTri>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(v_in),
          static_cast<T*>(v_out), static_cast<const int64_t*>(atoms),
          static_cast<const T*>(masses), static_cast<const T*>(box_a),
          static_cast<const T*>(box_b), n_tri);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0, x1, out (N, 3), atoms (n_tri, 3) int64, dists (n_tri, 3), masses
// (N,), box_a and box_b (3,) of an orthorhombic box or (3, 3) of a
// triclinic one (tri != 0), all of one float type (f64 != 0: double); out
// holds x1 on entry. Returns a cudaError_t.
extern "C" int triangle_shake_launch(const void* x0, const void* x1,
                                     void* out, const void* atoms,
                                     const void* dists, const void* masses,
                                     const void* box_a, const void* box_b,
                                     int64_t n_tri, int iters, int tri,
                                     int f64, void* stream) {
  if (n_tri <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return tri ? shake<double, true>(x0, x1, out, atoms, dists, masses, box_a,
                                     box_b, n_tri, iters, s)
               : shake<double, false>(x0, x1, out, atoms, dists, masses,
                                      box_a, box_b, n_tri, iters, s);
  return tri ? shake<float, true>(x0, x1, out, atoms, dists, masses, box_a,
                                  box_b, n_tri, iters, s)
             : shake<float, false>(x0, x1, out, atoms, dists, masses, box_a,
                                   box_b, n_tri, iters, s);
}

// x, v_in, v_out (N, 3), the rest as triangle_shake_launch; v_out holds
// v_in on entry.
extern "C" int triangle_rattle_launch(const void* x, const void* v_in,
                                      void* v_out, const void* atoms,
                                      const void* masses, const void* box_a,
                                      const void* box_b, int64_t n_tri,
                                      int tri, int f64, void* stream) {
  if (n_tri <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return tri ? rattle<double, true>(x, v_in, v_out, atoms, masses, box_a,
                                      box_b, n_tri, s)
               : rattle<double, false>(x, v_in, v_out, atoms, masses, box_a,
                                       box_b, n_tri, s);
  return tri ? rattle<float, true>(x, v_in, v_out, atoms, masses, box_a,
                                   box_b, n_tri, s)
             : rattle<float, false>(x, v_in, v_out, atoms, masses, box_a,
                                    box_b, n_tri, s);
}
