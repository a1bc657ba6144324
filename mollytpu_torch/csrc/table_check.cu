// The exact stale-list check of a neighbor table (missing_min_distance in
// mollytpu_torch/sim/simulate.py, on a CUDA card): the least distance r
// over the slots of the table ``new`` (N, K_new), built at the coordinates
// of the last force evaluation made with the table ``old`` (N, K_old),
// where the atom j < N is missing from row i of ``old`` and r < cutoff;
// inf where there is no such slot. Both tables place a pair in the same
// row (the balanced ownership of ops/neighbors.py), so the test never
// looks outside the row.
//
// Replaces no Pallas kernel: the JAX package's check is XLA
// (mollytpu/sim/simulate.py). Its PyTorch form, which the port keeps as
// the plain twin (missing_min_distance_plain), sorts N x K_old int64 keys
// row * (N + 1) + j globally, looks each of the N x K_new keys of ``new``
// up by searchsorted, and computes the distance of every slot of ``new``:
// 56 launches a check, and at in.lj's 2,048,000 atoms (K = 85, 174 M
// slots) 48.3 ms of an H100, 79% of the step (PERF_LEDGER.jsonl).
//
// What bounds it on an H100: the bytes of the two int32 tables, read once
// (2 x 2,048,000 x 85 x 4 B = 1.39 GB, 0.42 ms at 3.35 TB/s). The
// coordinates (24.6 MB in float32) would stay in the 50 MB L2, but on a
// sound run the kernel reads almost none of them (below). The tables are
// read with streaming loads (__ldcs).
//
// Design:
// - A warp per row, and in shared memory a hash set per warp: open
//   addressing with linear probing over 2^b int slots, 2^b the least power
//   of 2 (64 at least) that is twice K_old, so that the set is at most half
//   full even where every slot of the old row is live (256 slots, 1 KB, at
//   in.lj's K = 85). The warp reads the first 96 slots of both rows at
//   once (3 a lane, coalesced), clears its set, and inserts every atom
//   j < N of the old row by atomicCAS; the padding N is left out. The
//   width sets the block: 8 warps while their sets fit the 227 KB a block
//   can hold, fewer above K_old = 2,048, up to K_old = 16,384 with one.
// - Membership first. Each live slot of the new row is looked up in the
//   set (~1.1 probes expected at in.lj's fill of ~37 in 256); no lane
//   waits for another's probes. Only a slot missing from the old row is
//   measured, so a sound check gathers no coordinates. Measuring every
//   live slot first and looking up only those inside the cutoff took
//   1.03 ms a check at 2,048,000 atoms on an H100; this order takes 0.70
//   (PERF.md).
// - A missing slot's r is the twin's pair_geometry, rounded as it rounds:
//   x_j - x_i, the box's mic_parts (mic.cuh), then (dx dx + dy dy) +
//   dz dz, each operation rounded on its own, then the correctly rounded
//   square root; r < cutoff is tested against the cutoff rounded to the
//   working type, as PyTorch compares a tensor with a Python float.
// - The minimum: a warp minimum of the missing slots' r, a block minimum
//   over its warps, then one atomicMin on the bits of the non-negative
//   float (or double) into a scalar that the caller set to inf, and only
//   where the block found a missing pair: a check that finds none, as on a
//   sound run, makes no atomic at all. Blocks are persistent.
// - Nothing is read on the host and nothing is allocated here: the caller
//   fills the output with inf and launches on its stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mic.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;   // warps (rows in flight) per block
constexpr int kAhead = 3;      // row slots a lane loads at once, 32 apart
constexpr int kMinSlotsLog2 = 6;
constexpr int kEmpty = -1;
// a block's dynamic shared memory on an H100, less the static part
constexpr size_t kSetBytes = 232448 - 1024;

// field for field sim/simulate.py's _CheckSpec
struct CheckSpec {
  double cutoff;   // the list cutoff (nm), as a Python float
  int n_atoms;
  int k_old;       // width of the old table
  int k_new;       // width of the new table
  int f64;         // coordinates in float64 (else float32)
  int triclinic;   // box_a, box_b are (inv, basis), else (safe, mult)
};

__device__ __forceinline__ float infinity(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double infinity(double) {
  return __longlong_as_double(0x7ff0000000000000ll);
}

// the least of the non-negative values (bits of a non-negative float sort
// as the floats do)
__device__ __forceinline__ void atomic_min(float* out, float v) {
  atomicMin(reinterpret_cast<unsigned*>(out), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_min(double* out, double v) {
  atomicMin(reinterpret_cast<unsigned long long*>(out),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

// a set's first probe for atom j (Fibonacci hashing: the top bits of
// j times 2^32 / golden ratio, so that nearby indices spread)
__device__ __forceinline__ unsigned first_slot(int j, int shift) {
  return (static_cast<unsigned>(j) * 2654435769u) >> shift;
}

__device__ __forceinline__ void insert(int* set, int j, int shift,
                                       unsigned mask) {
  for (unsigned s = first_slot(j, shift);; s = (s + 1) & mask) {
    const int prev = atomicCAS(set + s, kEmpty, j);
    if (prev == kEmpty || prev == j) return;
  }
}

__device__ __forceinline__ bool contains(const int* set, int j, int shift,
                                         unsigned mask) {
  for (unsigned s = first_slot(j, shift);; s = (s + 1) & mask) {
    const int v = set[s];
    if (v == j) return true;
    if (v == kEmpty) return false;
  }
}

// slots [base, base + 32 x kAhead) of a row of width k, the lane's every
// 32nd, the padding n past the row's end; the loads are issued together
__device__ __forceinline__ void ahead(int* v, const int* __restrict__ row,
                                      int base, int k, int n, int lane) {
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    const int at = base + c * kWarp + lane;
    v[c] = at < k ? __ldcs(row + at) : n;
  }
}

template <typename T, bool kTri>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
table_check_kernel(const CheckSpec p, int slots_log2,
                   const T* __restrict__ coords, const T* __restrict__ box_a,
                   const T* __restrict__ box_b,
                   const int* __restrict__ old_idx,
                   const int* __restrict__ new_idx, T* __restrict__ out) {
  extern __shared__ __align__(16) int sets[];
  __shared__ T part[kMaxWarps];
  const int warps = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n = p.n_atoms;
  const int k_old = p.k_old, k_new = p.k_new;
  const int shift = 32 - slots_log2;
  const unsigned mask = (1u << slots_log2) - 1u;
  int* set = sets + (static_cast<size_t>(warp) << slots_log2);
  int4* set4 = reinterpret_cast<int4*>(set);
  const T cut = static_cast<T>(p.cutoff);
  const T none = infinity(T());
  T box[18];
  load_box<T, kTri>(box, box_a, box_b);
  T best = none;

  // i is the same on every lane of the warp; the __syncwarp calls order
  // the set's clearing, inserts and lookups across the warp's lanes
  for (int i = blockIdx.x * warps + warp; i < n; i += gridDim.x * warps) {
    const int* orow = old_idx + static_cast<int64_t>(i) * k_old;
    const int* nrow = new_idx + static_cast<int64_t>(i) * k_new;
    // the first 32 x kAhead slots of both rows, in flight together
    int o[kAhead], js[kAhead];
    ahead(o, orow, 0, k_old, n, lane);
    ahead(js, nrow, 0, k_new, n, lane);
    for (int s = lane; s < (1 << slots_log2) / 4; s += kWarp)
      set4[s] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    __syncwarp();
    for (int base = 0; base < k_old; base += kAhead * kWarp) {
      if (base) ahead(o, orow, base, k_old, n, lane);
#pragma unroll
      for (int c = 0; c < kAhead; ++c)
        if (static_cast<unsigned>(o[c]) < static_cast<unsigned>(n))
          insert(set, o[c], shift, mask);
    }
    __syncwarp();
    for (int base = 0; base < k_new; base += kAhead * kWarp) {
      if (base) ahead(js, nrow, base, k_new, n, lane);
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        const int j = js[c];
        if (static_cast<unsigned>(j) >= static_cast<unsigned>(n) ||
            contains(set, j, shift, mask))
          continue;
        const int64_t a = 3 * static_cast<int64_t>(i);
        const int64_t b = 3 * static_cast<int64_t>(j);
        T dx = sub(__ldg(coords + b), __ldg(coords + a));
        T dy = sub(__ldg(coords + b + 1), __ldg(coords + a + 1));
        T dz = sub(__ldg(coords + b + 2), __ldg(coords + a + 2));
        mic<T, kTri>(dx, dy, dz, box);
        const T r = root(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
        if (r < cut && r < best) best = r;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const T other = __shfl_xor_sync(0xffffffffu, best, off);
    if (other < best) best = other;
  }
  if (lane == 0) part[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    T m = part[0];
    for (int w = 1; w < warps; ++w)
      if (part[w] < m) m = part[w];
    if (m < none) atomic_min(out, m);
  }
}

template <typename T, bool kTri>
cudaError_t launch_rows(const CheckSpec& p, const void* coords,
                        const void* box_a, const void* box_b,
                        const void* old_idx, const void* new_idx, void* out,
                        cudaStream_t stream) {
  auto kernel = table_check_kernel<T, kTri>;
  int slots_log2 = kMinSlotsLog2;
  while ((1ll << slots_log2) < 2ll * p.k_old) ++slots_log2;
  const size_t set_bytes = sizeof(int) << slots_log2;
  if (set_bytes > kSetBytes) return cudaErrorInvalidValue;
  int warps = kMaxWarps;
  while (warps * set_bytes > kSetBytes) warps /= 2;
  const size_t smem = warps * set_bytes;
  const int threads = warps * kWarp;
  // persistent blocks: as many as are resident on the card at once (the
  // queries are made again only for another block shape; every card of a
  // host is of one kind)
  static size_t shaped = 0;
  static int resident = 0;
  if (smem != shaped) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    shaped = smem;
  }
  const int needed = (p.n_atoms + warps - 1) / warps;
  const int blocks = needed < resident ? needed : resident;
  kernel<<<blocks, threads, smem, stream>>>(
      p, slots_log2, static_cast<const T*>(coords),
      static_cast<const T*>(box_a), static_cast<const T*>(box_b),
      static_cast<const int*>(old_idx), static_cast<const int*>(new_idx),
      static_cast<T*>(out));
  return cudaGetLastError();
}

bool valid(const CheckSpec& p) {
  return p.n_atoms > 0 && p.k_old >= 0 && p.k_new >= 0;
}

}  // namespace

// Lowers out, a scalar of the working type that the caller set to inf, to
// the least r < spec.cutoff of a slot of new_idx (N, K_new) whose atom
// j < N is not in the same row of old_idx (N, K_old); both int32, padded
// with N. coords (N, 3) and the box's mic_tensors box_a, box_b ((3,) each
// of an orthorhombic box, (3, 3) of a triclinic one, spec.triclinic) are
// of the working type.
extern "C" int table_check_launch(const void* spec_p, const void* coords,
                                  const void* box_a, const void* box_b,
                                  const void* old_idx, const void* new_idx,
                                  void* out, void* stream) {
  const CheckSpec p = *static_cast<const CheckSpec*>(spec_p);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = p.f64 ? (p.triclinic ? launch_rows<double, true>
                                     : launch_rows<double, false>)
                      : (p.triclinic ? launch_rows<float, true>
                                     : launch_rows<float, false>);
  return static_cast<int>(
      launch(p, coords, box_a, box_b, old_idx, new_idx, out, s));
}
