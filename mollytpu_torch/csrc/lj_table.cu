// Lennard-Jones forces over a Neighbors table (mollytpu_torch/ops/
// nonbonded.py, neighbor_forces on a CUDA card): for every listed pair
// {i, j} inside DistanceCutoff, U = 4 eps ((s/r)^12 - (s/r)^6) with
// Lorentz sigma and geometric epsilon mixed from the per-atom parameters,
// the force on the row atom i and its reaction on j, and on request the
// virial -sum (dU/dr / r) dr (x) dr.
//
// Replaces no Pallas kernel: the JAX package's neighbor-table engine is
// XLA (mollytpu/ops/nonbonded.py, neighbor_forces). Its PyTorch form, which
// the port keeps as the plain twin (neighbor_forces_plain), is an eager
// chain of ~108 launches a call: the c[js] gathers over the (N, K) table,
// torch.autograd.grad through LennardJones.energy and DistanceCutoff for
// dU/dr, torch.stack and an index_add scatter, every intermediate an
// (N, K) tensor in device memory. On in.lj at 256,000 atoms (K = 85,
// 21.8 M slots, ~39 live a row, ~28 inside the cutoff) it took 8.74 of the
// 10.50 ms step of an H100 (pairs_ms.lj in PERF_LEDGER.jsonl).
//
// What bounds it on an H100: bytes. The live table slots (~40 MB of int32
// at in.lj's 256,000 atoms), the per-atom inputs read once and the forces
// written once (~8 MB) need ~15 us at 3.35 TB/s; the arithmetic (~50 FP32
// operations a pair) needs ~7 us at 67 TFLOP/s. In practice the reaction
// on j, an atomic add per pair inside the cutoff (~7 M a call), sets the
// pace: atomics go to L2, not to device memory. With three scalar float
// atomic adds a pair the kernel took ~0.29 ms there on an H100, ~0.10 ms
// with them cut out, and 0.13 ms with one float4 atomic add (PERF.md).
//
// Design:
// - A group of kLanes = 16 lanes takes one row at a time, reads the row's
//   slots 16 at a time (coalesced int32 loads) and stops after the first
//   chunk that holds a sentinel: rows are compacted in candidate order, so
//   padding trails and most of the ~46 padding slots of a row are never
//   read. Groups of 8 lanes ran as fast at in.lj's 256,000 atoms, groups
//   of 32 ~12-15% slower (PERF.md).
// - The coordinates and parameters of j are read-only loads (__ldg): the
//   per-atom arrays (3 MB of coordinates at 256,000 atoms) stay in L2.
//   Where the atoms' order follows space (a lattice, or atoms sorted by
//   cell), a block's rows are neighbours in space, their j sets overlap in
//   L1 and a chunk's j atomics fall in few 128-byte lines. The kernel's
//   time follows that order, not the bytes: on an H100 at in.lj's 256,000
//   atoms 0.13 ms in lattice order, ~0.2 ms after the 10,000 steps of
//   diffusion a benchmark run makes, 0.42 ms in a random order (PERF.md).
// - The row atom's force sums in registers, is reduced over the group by
//   shuffles and added once; the reaction on j goes out by atomic adds. In
//   float32 the force rows are padded to 4 floats, so that each add is one
//   float4 atomic (Hopper's vector atomics on global memory) and not three;
//   the wrapper hands back the (N, 3) view. float64 takes three.
// - The virial (a template flag) sums per thread in double, is reduced over
//   the block and added by one set of atomics per block. Blocks are
//   persistent (as many as fit on the card at once, each walking rows with
//   a stride), so a call makes ~1,000 such sets and not one per row group.
// - The arithmetic is the closed form from r^2: with s^2 = sigma^2 / r^2,
//   s^6 = (s^2)^3, dU/dr / r = -24 eps (2 s^12 - s^6) / r^2. The cutoff
//   test is sqrt(r^2) <= rc in the working type, as DistanceCutoff tests r,
//   on an r^2 rounded as the engine rounds it, so that a pair at the
//   cutoff falls on the engine's side of the force's jump; a pair at r ==
//   rc takes half its force there, as the engine's derivative of
//   minimum(r, rc) does (at in.lj's 256,000 atoms ~1.5 pairs a frame lie
//   in that float32 bin).
//   A zero sigma, epsilon or lambda on either atom means no interaction
//   (pairwise._lj_shortcut); weight_special scales the 1-4 pairs' force.
// - The box reaches the kernel as the device buffers of its mic_tensors,
//   and the minimum image is its mic_parts, operation for operation
//   (mic.cuh; a Triclinic box is a template flag). Nothing is copied from
//   the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kLanes = 16;   // lanes that read one row together
constexpr int kGroups = kThreads / kLanes;

// field for field ops/nonbonded.py's _TableSpec
struct TableSpec {
  double cutoff;          // DistanceCutoff.dist_cutoff (nm)
  double weight_special;  // LennardJones.weight_special
  int n_atoms;
  int k_max;              // row width K
  int f64;                // float64 inputs (else float32)
  int virial;             // add the virial to virial[9]
  int triclinic;          // box_a, box_b are (inv, basis), else (safe, mult)
};

// a force added to row j of the accumulator: float32 rows are padded to 4
// floats and take one vector atomic add (float4, sm_90), float64 rows three
// scalar ones
__device__ __forceinline__ void add_row(float* f, int64_t j, float x, float y,
                                        float z) {
  atomicAdd(reinterpret_cast<float4*>(f) + j, make_float4(x, y, z, 0.0f));
}
__device__ __forceinline__ void add_row(double* f, int64_t j, double x,
                                        double y, double z) {
  double* p = f + 3 * j;
  atomicAdd(p, x);
  atomicAdd(p + 1, y);
  atomicAdd(p + 2, z);
}

template <typename T, bool kTri, bool kVirial>
__global__ void __launch_bounds__(kThreads)
lj_table_kernel(const TableSpec p, const T* __restrict__ coords,
                const T* __restrict__ box_a, const T* __restrict__ box_b,
                const T* __restrict__ sigma, const T* __restrict__ epsilon,
                const T* __restrict__ lam, const int* __restrict__ idx,
                const uint8_t* __restrict__ special, T* __restrict__ forces,
                T* __restrict__ virial) {
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const unsigned gmask = ((1u << kLanes) - 1u) << (threadIdx.x % kWarp - lane);
  const int n = p.n_atoms;
  const int k_max = p.k_max;
  const T rc = static_cast<T>(p.cutoff);
  const T w = static_cast<T>(p.weight_special);
  T box[18];
  load_box<T, kTri>(box, box_a, box_b);
  double v[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};

  for (int i = blockIdx.x * kGroups + group; i < n;
       i += gridDim.x * kGroups) {
    // i is the same on every lane of the group, so each branch on it and
    // each chunk loop below is uniform over the group
    const T si = __ldg(sigma + i), ei = __ldg(epsilon + i);
    const T li = lam ? __ldg(lam + i) : T(1);
    if (si == T(0) || ei == T(0) || li == T(0)) continue;
    const T xi = __ldg(coords + 3 * static_cast<int64_t>(i));
    const T yi = __ldg(coords + 3 * static_cast<int64_t>(i) + 1);
    const T zi = __ldg(coords + 3 * static_cast<int64_t>(i) + 2);
    const int* row = idx + static_cast<int64_t>(i) * k_max;
    const uint8_t* srow =
        special ? special + static_cast<int64_t>(i) * k_max : nullptr;
    T fx = T(0), fy = T(0), fz = T(0);
    for (int base = 0; base < k_max; base += kLanes) {
      const int k = base + lane;
      const int j = k < k_max ? __ldg(row + k) : n;
      const bool live = static_cast<unsigned>(j) < static_cast<unsigned>(n);
      if (live) {
        const T sj = __ldg(sigma + j), ej = __ldg(epsilon + j);
        const T lj = lam ? __ldg(lam + j) : T(1);
        T dx = sub(__ldg(coords + 3 * static_cast<int64_t>(j)), xi);
        T dy = sub(__ldg(coords + 3 * static_cast<int64_t>(j) + 1), yi);
        T dz = sub(__ldg(coords + 3 * static_cast<int64_t>(j) + 2), zi);
        const bool flag = srow && __ldg(srow + k);
        mic<T, kTri>(dx, dy, dz, box);
        const T r2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
        const T r = root(r2);
        if (sj != T(0) && ej != T(0) && lj != T(0) && r <= rc) {
          const T sig = (si + sj) * T(0.5);
          const T eps = root(ei * ej);
          const T s2 = sig * sig / r2;
          const T s6 = s2 * s2 * s2;
          T coef = T(-24) * eps * (T(2) * s6 * s6 - s6) / r2;
          if (flag) coef *= w;
          // DistanceCutoff evaluates u(minimum(r, rc)), whose derivative
          // autograd (as jax.grad) splits in half where r == rc
          if (r == rc) coef *= T(0.5);
          const T gx = coef * dx, gy = coef * dy, gz = coef * dz;
          fx += gx;
          fy += gy;
          fz += gz;
          add_row(forces, j, -gx, -gy, -gz);
          if (kVirial) {
            const double c = coef;
            v[0] += c * dx * dx;
            v[1] += c * dx * dy;
            v[2] += c * dx * dz;
            v[3] += c * dy * dy;
            v[4] += c * dy * dz;
            v[5] += c * dz * dz;
          }
        }
      }
      if (__ballot_sync(gmask, !live) & gmask) break;
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      fx += __shfl_xor_sync(gmask, fx, off);
      fy += __shfl_xor_sync(gmask, fy, off);
      fz += __shfl_xor_sync(gmask, fz, off);
    }
    if (lane == 0) {
      add_row(forces, i, fx, fy, fz);
    }
  }

  if (kVirial) {
    __shared__ double part[kThreads / kWarp][6];
    const int wl = threadIdx.x % kWarp;
    const int wid = threadIdx.x / kWarp;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      double s = v[c];
      for (int off = kWarp / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (wl == 0) part[wid][c] = s;
    }
    __syncthreads();
    if (threadIdx.x < 9) {
      // row-major (a, b) -> v's index of the symmetric component
      const int a = threadIdx.x / 3, b = threadIdx.x % 3;
      const int lo = min(a, b), hi = max(a, b);
      const int c = 3 * lo - lo * (lo - 1) / 2 + hi - lo;
      double s = 0.0;
      for (int wp = 0; wp < kThreads / kWarp; ++wp) s += part[wp][c];
      atomicAdd(virial + threadIdx.x, static_cast<T>(-s));
    }
  }
}

template <typename T, bool kTri, bool kVirial>
cudaError_t launch_rows(const TableSpec& p, const void* coords,
                        const void* box_a, const void* box_b,
                        const void* sigma, const void* epsilon,
                        const void* lam, const void* idx, const void* special,
                        void* forces, void* virial, cudaStream_t stream) {
  auto kernel = lj_table_kernel<T, kTri, kVirial>;
  // persistent blocks: as many as are resident on the card at once (the
  // occupancy query is made once per instance; every card of a host is
  // of one kind)
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (p.n_atoms + kGroups - 1) / kGroups;
  const int blocks = needed < resident ? needed : resident;
  kernel<<<blocks, kThreads, 0, stream>>>(
      p, static_cast<const T*>(coords), static_cast<const T*>(box_a),
      static_cast<const T*>(box_b), static_cast<const T*>(sigma),
      static_cast<const T*>(epsilon), static_cast<const T*>(lam),
      static_cast<const int*>(idx), static_cast<const uint8_t*>(special),
      static_cast<T*>(forces), static_cast<T*>(virial));
  return cudaGetLastError();
}

// the instance of the spec's box and virial flag
template <typename T>
cudaError_t launch_type(const TableSpec& p, const void* coords,
                        const void* box_a, const void* box_b,
                        const void* sigma, const void* epsilon,
                        const void* lam, const void* idx, const void* special,
                        void* forces, void* virial, cudaStream_t stream) {
  auto launch = p.triclinic
                    ? (p.virial ? launch_rows<T, true, true>
                                : launch_rows<T, true, false>)
                    : (p.virial ? launch_rows<T, false, true>
                                : launch_rows<T, false, false>);
  return launch(p, coords, box_a, box_b, sigma, epsilon, lam, idx, special,
                forces, virial, stream);
}

bool valid(const TableSpec& p) { return p.n_atoms > 0 && p.k_max > 0; }

}  // namespace

// Adds the pair forces to forces, (N, 4) rows (x, y, z, 0) in float32 and
// (N, 3) in float64 (16-byte aligned), and, with spec.virial, the virial
// to virial (3, 3), both of the working type and zeroed by the caller.
// coords (N, 3), the box's mic_tensors box_a and box_b ((3,) each of an
// orthorhombic box, (3, 3) of a triclinic one, spec.triclinic), sigma,
// epsilon and lam (N,) are of the working type, lam may be null (every
// lambda 1); idx (N, K) int32 is padded with N; special (N, K) uint8 may be
// null (weight_special 1).
extern "C" int lj_table_launch(const void* spec_p, const void* coords,
                               const void* box_a, const void* box_b,
                               const void* sigma, const void* epsilon,
                               const void* lam, const void* idx,
                               const void* special, void* forces,
                               void* virial, void* stream) {
  const TableSpec p = *static_cast<const TableSpec*>(spec_p);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.f64 ? launch_type<double>(p, coords, box_a, box_b, sigma, epsilon,
                                  lam, idx, special, forces, virial, s)
            : launch_type<float>(p, coords, box_a, box_b, sigma, epsilon, lam,
                                 idx, special, forces, virial, s);
  return static_cast<int>(err);
}
