// The exact minimum image of the port's kernels over a neighbor table and
// of its rigid triangles (cell_neighbors.cu, lj_table.cu,
// rigid_triangles.cu): the box's mic_parts (mollytpu_torch/boundary.py),
// operation for operation, over the device buffers of its mic_tensors.
// In an Orthorhombic box d - rint(d / safe) * mult per axis, an open axis
// having safe 1 and mult 0; in a Triclinic one the fractional rounding
// f = d inv, f - rint(f), (f - rint(f)) basis, with inv and basis
// row-major 3 x 3. Each operation is rounded on its own, as PyTorch's
// elementwise ops round (the _rn intrinsics: no FMA contraction), so that
// a distance, and a cutoff test on it, are the PyTorch twin's to the bit.
//
// The pair kernel K1 (pair_nonbonded.cu) keeps its own back-substitution
// image over a __constant__ row, the JAX kernel's convention.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rnd(float a) { return rintf(a); }
__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double rnd(double a) { return rint(a); }
__device__ __forceinline__ double root(double a) { return sqrt(a); }

// d - rint(d / safe) * mult; where |d| < safe / 4 (``quarter``) the
// quotient rounds below 1/2, so rint gives 0 and the result is d: the
// division runs only for the pairs that may cross the box
template <typename T>
__device__ __forceinline__ T mic_axis(T d, T safe, T mult, T quarter) {
  if (fabs(d) < quarter) return d;
  return sub(d, mul(rnd(div(d, safe)), mult));
}

// the box in registers: (safe, mult, safe / 4) of an orthorhombic box,
// (inv, basis) of a triclinic one (row-major 3 x 3), from its mic_tensors
template <typename T, bool kTri>
__device__ __forceinline__ void load_box(T* box, const T* __restrict__ a,
                                         const T* __restrict__ b) {
  if (!kTri) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      box[k] = __ldg(a + k);
      box[3 + k] = __ldg(b + k);
      box[6 + k] = mul(box[k], T(0.25));  // exact: a power of 2
    }
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      box[k] = __ldg(a + k);
      box[9 + k] = __ldg(b + k);
    }
  }
}

// minimum image of (dx, dy, dz) as the box's mic_parts computes it, over
// a box laid out as load_box lays it out
template <typename T, bool kTri>
__device__ __forceinline__ void mic(T& dx, T& dy, T& dz, const T* box) {
  if (!kTri) {
    dx = mic_axis(dx, box[0], box[3], box[6]);
    dy = mic_axis(dy, box[1], box[4], box[7]);
    dz = mic_axis(dz, box[2], box[5], box[8]);
    return;
  }
  const T* a = box;
  const T* b = box + 9;
  T f[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f[k] = add(add(mul(dx, a[k]), mul(dy, a[3 + k])), mul(dz, a[6 + k]));
    f[k] = sub(f[k], rnd(f[k]));
  }
  T d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d[k] = add(add(mul(f[0], b[k]), mul(f[1], b[3 + k])), mul(f[2], b[6 + k]));
  dx = d[0];
  dy = d[1];
  dz = d[2];
}

}  // namespace
