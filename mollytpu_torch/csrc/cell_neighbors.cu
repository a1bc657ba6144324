// The cell-list neighbor table of CellListNeighborFinder.find
// (mollytpu_torch/ops/neighbors.py): per atom i, the atoms j of the 27
// cells around its own that lie inside the list radius and that i owns
// (the balanced ownership: j > i when i + j is even, j < i otherwise),
// less the excluded pairs, with the 1-4 flag of each, compacted in
// candidate order into an (N, K) table padded with N.
//
// Replaces no Pallas kernel: the JAX package's cell finder is XLA
// (mollytpu/ops/neighbors.py, CellListNeighborFinder.find). Its PyTorch
// form, which the port keeps as the plain twin (find_plain), materialises
// the stencil's candidates as dense (N, 27 x capacity) tensors several
// times over (indices, three gathers, the minimum image, the mask, a
// cumulative-sum rank and a scatter index): at in.lj's 256,000 atoms, 366 M
// slots, 60% of them padding, and 69 ms of an H100 per rebuild.
//
// What bounds it on an H100: the bytes of the (N, K) output, an int32
// index and a bool flag per slot (110 MB at 256,000 atoms and K = 85,
// ~0.035 ms at 3.35 TB/s). The inputs (coordinates, the sorted atom order,
// the cell starts) are a few MB. The candidate tests, ~567 per row at
// in.lj's density, are a few hundred FP32 operations per row.
//
// Design: nothing of size N x 27 x capacity reaches device memory.
// - The caller bins the atoms in PyTorch with the twin's own code
//   (_cells in ops/neighbors.py), sorts the cell ids stably and finds
//   each cell's run of atoms with searchsorted. A cell's first `cap`
//   atoms in that order are the twin's (n_cells, cap) table row, so no
//   table is built.
// - cell_neighbors_kernel: one block per cell. The block stages the
//   occupied entries of its stencil's cells in shared memory once, in
//   candidate order (stencil offset, then slot) and compacted (atom index
//   and coordinates: ~567 live entries at in.lj's density, not 27 x 53
//   slots). A warp per row atom (every atom of the cell's run, those past
//   the capacity too) walks them 32 at a time; __ballot_sync and a __popc
//   prefix place the hits at the row's running count, which is the twin's
//   cumulative-sum rank, so idx and special are written in order with
//   coalesced stores; the warp pads its row with N itself. The row's
//   excess over K goes to an atomicMax, the cell's excess over its capacity
//   to an atomicAdd.
// - Rounding follows the twin's PyTorch ops one by one: x_j - x_i, then
//   the box's mic_parts (mic.cuh), then (dx dx + dy dy) + dz dz, each
//   operation rounded on its own (the _rn intrinsics: no FMA contraction),
//   against the squared cutoff rounded to the working type. So a pair at
//   the cutoff lands on the twin's side, and the tables agree element for
//   element. The one shortcut gives the same bits: an axis with |d| below
//   a quarter of the side skips its division, whose quotient would round
//   to 0 (most pairs in a box many cells wide).
// - The grid, the capacity, K and the stencil reach the kernel by value
//   in FindSpec; the box's constants from device buffers. Nothing is
//   copied from the host, so a find never blocks the host.
// - Shared memory: m x cap entries of an int and three coordinates (22.9
//   KB at cap 53 in float32). The wrapper refuses a capacity whose stage
//   does not fit the 227 KB a block can have.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mic.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxStencil = 27;
constexpr unsigned kFull = 0xffffffffu;

// field for field ops/neighbors.py's _FindSpec
struct FindSpec {
  double cut2;   // the list radius squared, as a Python float
  int n_atoms;
  int n_cells;
  int cap;       // cell capacity
  int k_max;     // row width K
  int dims[3];
  int m;         // stencil offsets used (duplicates removed)
  int off[kMaxStencil][3];
  int f64;       // coordinates in float64 (else float32)
  int triclinic;
  int excl_w;    // exclusion table width, 0: no exclusion test
  int spec_w;    // 1-4 table width, 0: no 1-4 test
};

__device__ __forceinline__ bool member(const int* __restrict__ row, int w,
                                       int j) {
  for (int k = 0; k < w; ++k)
    if (__ldg(row + k) == j) return true;
  return false;
}

template <typename T, bool kTri>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
cell_neighbors_kernel(const FindSpec p, const T* __restrict__ coords,
                      const T* __restrict__ box_a,
                      const T* __restrict__ box_b,
                      const int64_t* __restrict__ order,
                      const int* __restrict__ start,
                      const int* __restrict__ excl,
                      const int* __restrict__ spec, int* __restrict__ idx,
                      uint8_t* __restrict__ special, int* __restrict__ over) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ int s_lo[kMaxStencil], s_cnt[kMaxStencil], s_off[kMaxStencil + 1];
  __shared__ T s_box[18];
  const int cell = blockIdx.x;
  const int row0 = start[cell];
  const int n_rows = start[cell + 1] - row0;
  if (n_rows == 0) return;  // block-uniform: an empty cell has no rows
  const int tid = threadIdx.x;
  const int e_max = p.m * p.cap;
  T* sx = reinterpret_cast<T*>(stage);
  T* sy = sx + e_max;
  T* sz = sy + e_max;
  int* sj = reinterpret_cast<int*>(sz + e_max);

  if (tid < p.m) {
    const int c2 = cell % p.dims[2];
    const int c1 = (cell / p.dims[2]) % p.dims[1];
    const int c0 = cell / (p.dims[2] * p.dims[1]);
    const int a = (c0 + p.off[tid][0] + p.dims[0]) % p.dims[0];
    const int b = (c1 + p.off[tid][1] + p.dims[1]) % p.dims[1];
    const int c = (c2 + p.off[tid][2] + p.dims[2]) % p.dims[2];
    const int ncid = (a * p.dims[1] + b) * p.dims[2] + c;
    const int lo = start[ncid];
    s_lo[tid] = lo;
    s_cnt[tid] = min(start[ncid + 1] - lo, p.cap);
  } else if (tid >= kWarp && tid < kWarp + (kTri ? 9 : 3)) {
    const int k = tid - kWarp;
    if (kTri) {
      s_box[k] = box_a[k];
      s_box[9 + k] = box_b[k];
    } else {
      s_box[k] = box_a[k];
      s_box[3 + k] = box_b[k];
      s_box[6 + k] = mul(box_a[k], T(0.25));  // exact: a power of 2
    }
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int s = 0; s < p.m; ++s) {
      s_off[s] = acc;
      acc += s_cnt[s];
    }
    s_off[p.m] = acc;
    if (n_rows > p.cap) atomicAdd(over + 1, n_rows - p.cap);
  }
  __syncthreads();
  const int n_cand = s_off[p.m];
  for (int t = tid; t < n_cand; t += blockDim.x) {
    int s = 0;
    while (t >= s_off[s + 1]) ++s;
    const int j = static_cast<int>(order[s_lo[s] + (t - s_off[s])]);
    const T* xj = coords + 3 * static_cast<int64_t>(j);
    sj[t] = j;
    sx[t] = xj[0];
    sy[t] = xj[1];
    sz[t] = xj[2];
  }
  __syncthreads();

  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const unsigned below = (1u << lane) - 1u;
  const T cut2 = static_cast<T>(p.cut2);
  for (int r = warp; r < n_rows; r += kWarpsPerBlock) {
    const int i = static_cast<int>(order[row0 + r]);
    const T* xi = coords + 3 * static_cast<int64_t>(i);
    const T x = xi[0], y = xi[1], z = xi[2];
    const int* erow = excl + static_cast<int64_t>(i) * p.excl_w;
    const int* srow = spec + static_cast<int64_t>(i) * p.spec_w;
    int* irow = idx + static_cast<int64_t>(i) * p.k_max;
    uint8_t* frow = special + static_cast<int64_t>(i) * p.k_max;
    int count = 0;
    for (int base = 0; base < n_cand; base += kWarp) {
      const int t = base + lane;
      bool hit = false, flag = false;
      int j = 0;
      if (t < n_cand) {
        j = sj[t];
        if (((i + j) & 1) == 0 ? j > i : j < i) {
          T dx = sub(sx[t], x), dy = sub(sy[t], y), dz = sub(sz[t], z);
          mic<T, kTri>(dx, dy, dz, s_box);
          const T d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
          hit = d2 < cut2 && !member(erow, p.excl_w, j);
          flag = hit && member(srow, p.spec_w, j);
        }
      }
      const unsigned hits = __ballot_sync(kFull, hit);
      const int pos = count + __popc(hits & below);
      if (hit && pos < p.k_max) {
        irow[pos] = j;
        frow[pos] = flag;
      }
      count += __popc(hits);
    }
    for (int k = count + lane; k < p.k_max; k += kWarp) {
      irow[k] = p.n_atoms;
      frow[k] = 0;
    }
    if (lane == 0 && count > p.k_max) atomicMax(over, count - p.k_max);
  }
}

template <typename T, bool kTri>
cudaError_t launch_table(const FindSpec& p, const void* coords,
                         const void* box_a, const void* box_b,
                         const void* order, const void* start,
                         const void* excl, const void* spec, void* idx,
                         void* special, void* over, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.m) * p.cap * (3 * sizeof(T) + sizeof(int));
  auto kernel = cell_neighbors_kernel<T, kTri>;
  if (smem > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (set != cudaSuccess) return set;
  }
  kernel<<<p.n_cells, kWarp * kWarpsPerBlock, smem, stream>>>(
      p, static_cast<const T*>(coords), static_cast<const T*>(box_a),
      static_cast<const T*>(box_b), static_cast<const int64_t*>(order),
      static_cast<const int*>(start), static_cast<const int*>(excl),
      static_cast<const int*>(spec), static_cast<int*>(idx),
      static_cast<uint8_t*>(special), static_cast<int*>(over));
  return cudaGetLastError();
}

bool valid(const FindSpec& p) {
  if (p.n_atoms <= 0 || p.cap <= 0 || p.k_max <= 0 || p.m <= 0 ||
      p.m > kMaxStencil || p.excl_w < 0 || p.spec_w < 0)
    return false;
  long long cells = 1;
  for (int k = 0; k < 3; ++k) {
    if (p.dims[k] <= 0) return false;
    cells *= p.dims[k];
  }
  return cells == p.n_cells;
}

}  // namespace

// The (N, K) table: idx int32 and special uint8 (written whole), and in
// over[0] the largest row excess over K, in over[1] the atoms past their
// cell's capacity (both zeroed by the caller). order (int64) holds the
// atoms sorted stably by cell id, start (int32, n_cells + 1) each cell's
// first position in it; excl and spec the (N, width) partner tables.
extern "C" int cell_neighbors_launch(const void* spec_p, const void* coords,
                                     const void* box_a, const void* box_b,
                                     const void* order, const void* start,
                                     const void* excl, const void* spec,
                                     void* idx, void* special, void* over,
                                     void* stream) {
  const FindSpec p = *static_cast<const FindSpec*>(spec_p);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.f64)
    err = p.triclinic
              ? launch_table<double, true>(p, coords, box_a, box_b, order,
                                           start, excl, spec, idx, special,
                                           over, s)
              : launch_table<double, false>(p, coords, box_a, box_b, order,
                                            start, excl, spec, idx, special,
                                            over, s);
  else
    err = p.triclinic
              ? launch_table<float, true>(p, coords, box_a, box_b, order,
                                          start, excl, spec, idx, special,
                                          over, s)
              : launch_table<float, false>(p, coords, box_a, box_b, order,
                                           start, excl, spec, idx, special,
                                           over, s);
  return static_cast<int>(err);
}
