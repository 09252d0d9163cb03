// Cascaded RLE expansion: both run-length passes of a chunk, one block per
// chunk.
//
// Replaces the TPU kernel tpucomp/ops/pallas/cascaded_expand.py::_kernel
// (:48, called by _call at :128 through expand_batch :92).  That kernel walks
// the runs serially and stores 128 lanes at a time; the reference's own note
// (cascaded_fast.py:591-603) records that form as catastrophic on run-dense
// columns.  This one computes the reference's vector form instead
// (cascaded_fast.py::_expand_pass / _expand_chunk), which gives the same
// values on [0, n) and defined values on every element of the row:
//
//   r[j]     = clip(runs[j], 0, cap_el) for j < n_runs, else none
//   start[j] = exclusive prefix sum of r, in int32 (it wraps as the
//              reference's does); a negative start counts from the row's end
//              and one outside [0, cap_el) is dropped (JAX's scatter rules)
//   ind[i]   = number of starts at i
//   ridx[i]  = clip(inclusive prefix sum of ind - 1, 0, cap_el - 1)
//   out[i]   = values[ridx[i]]
//
// nr == 2 runs the pass of runs2 first and the pass of runs1 over its
// result; nr == 1 the pass of runs1; nr <= 0 copies the values.  The first
// of two passes keeps only its indices (ridx2), and the second reads
// values[ridx2[ridx1[i]]], so the values are gathered once.
//
// Per block (1024 threads, one chunk): zero ind (global scratch: 64 Ki
// counts do not fit shared memory), scan the run lengths tile by tile (each
// thread 8 consecutive runs, a warp-shuffle scan of the thread sums, the
// carry between tiles in a register) and add each start into ind with an
// atomic, then scan ind the same way into ridx (in place for the first
// pass).  __syncthreads orders the phases; a block's global writes are
// visible to its own threads after it.
//
// Bound: bytes.  The function reads runs1[:n1], runs2[:n2] and the values
// [:n2] and writes 8 bytes an element of the output row; it needs no
// intermediate row.  The scratch counts and indices (8 bytes an element a
// pass) are the extra traffic of this design and are not in the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (see
// tpucomp_torch/ops/cuda/_build.py); plain C interface, bound with ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Exclusive block-wide scan of one unsigned value a thread (sums mod 2^32);
// *total gets the block's sum.  Every thread of the block must call it.
__device__ unsigned block_exclusive_scan(unsigned x, unsigned* smem, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = smem[lane];  // WARPS == 32
    unsigned wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      unsigned y = __shfl_up_sync(FULL, wi, d);
      if (lane >= d) wi += y;
    }
    smem[lane] = wi - w;
    if (lane == 31) smem[WARPS] = wi;
  }
  __syncthreads();
  unsigned res = smem[warp] + incl - x;
  *total = smem[WARPS];
  __syncthreads();  // smem is reused by the next call
  return res;
}

// ind[0, cap) = the number of run starts at each position.
__device__ void mark_starts(const int* __restrict__ runs, int count, int cap, int* ind,
                            unsigned* smem) {
  for (int i = threadIdx.x; i < cap; i += THREADS) ind[i] = 0;
  __syncthreads();
  unsigned carry = 0;
  for (int base = 0; base < count; base += TILE) {
    const int j0 = base + threadIdx.x * ITEMS;
    unsigned r[ITEMS];
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = j0 + q;
      int v = j < count ? runs[j] : 0;
      v = v < 0 ? 0 : (v > cap ? cap : v);
      r[q] = static_cast<unsigned>(v);
      sum += r[q];
    }
    unsigned tile_total;
    unsigned s = carry + block_exclusive_scan(sum, smem, &tile_total);
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (j0 + q < count) {
        int st = static_cast<int>(s);  // the reference's int32 start
        if (st < 0) st += cap;         // negative: from the end
        if (st >= 0 && st < cap) atomicAdd(&ind[st], 1);
      }
      s += r[q];
    }
    carry += tile_total;
  }
  __syncthreads();
}

// ridx from ind, tile by tile; MODE 0 writes ridx over ind, MODE 1 writes
// out = values[ridx], MODE 2 writes out = values[idx2[ridx]].
template <int MODE>
__device__ void scan_and_gather(int* ind, int cap, const int* __restrict__ idx2,
                                const int* __restrict__ vlo, const int* __restrict__ vhi,
                                int* __restrict__ olo, int* __restrict__ ohi, unsigned* smem) {
  unsigned carry = 0;
  for (int base = 0; base < cap; base += TILE) {
    const int i0 = base + threadIdx.x * ITEMS;
    unsigned c[ITEMS];
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      c[q] = i0 + q < cap ? static_cast<unsigned>(ind[i0 + q]) : 0u;
      sum += c[q];
    }
    unsigned tile_total;
    unsigned s = carry + block_exclusive_scan(sum, smem, &tile_total);
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = i0 + q;
      s += c[q];
      if (i < cap) {
        int r = static_cast<int>(s) - 1;
        r = r < 0 ? 0 : (r > cap - 1 ? cap - 1 : r);
        if (MODE == 0) {
          ind[i] = r;
        } else {
          const int src = MODE == 2 ? idx2[r] : r;
          olo[i] = vlo[src];
          ohi[i] = vhi[src];
        }
      }
    }
    carry += tile_total;
  }
}

__global__ void __launch_bounds__(THREADS)
    expand_kernel(const int* __restrict__ vlo, const int* __restrict__ vhi,
                  const int* __restrict__ runs1, const int* __restrict__ runs2,
                  const int* __restrict__ scalars, int cap, int* __restrict__ olo,
                  int* __restrict__ ohi, int* __restrict__ scratch_a,
                  int* __restrict__ scratch_b) {
  __shared__ unsigned smem[WARPS + 1];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * cap;
  vlo += row;
  vhi += row;
  runs1 += row;
  runs2 += row;
  olo += row;
  ohi += row;
  scratch_a += row;
  scratch_b += row;
  const int n1 = scalars[4 * blockIdx.x + 1];
  const int n2 = scalars[4 * blockIdx.x + 2];
  const int nr = scalars[4 * blockIdx.x + 3];
  auto clamp_count = [cap](int n) { return n < 0 ? 0 : (n > cap ? cap : n); };

  if (nr <= 0) {
    for (int i = threadIdx.x; i < cap; i += THREADS) {
      olo[i] = vlo[i];
      ohi[i] = vhi[i];
    }
    return;
  }
  if (nr >= 2) {
    mark_starts(runs2, clamp_count(n2), cap, scratch_a, smem);
    scan_and_gather<0>(scratch_a, cap, nullptr, nullptr, nullptr, nullptr, nullptr, smem);
    __syncthreads();
    mark_starts(runs1, clamp_count(n1), cap, scratch_b, smem);
    scan_and_gather<2>(scratch_b, cap, scratch_a, vlo, vhi, olo, ohi, smem);
  } else {
    mark_starts(runs1, clamp_count(n1), cap, scratch_a, smem);
    scan_and_gather<1>(scratch_a, cap, nullptr, vlo, vhi, olo, ohi, smem);
  }
}

}  // namespace

extern "C" int tpucomp_cascaded_expand(const void* vlo, const void* vhi, const void* runs1,
                                       const void* runs2, const void* scalars, int B, int cap,
                                       void* olo, void* ohi, void* scratch_a, void* scratch_b,
                                       void* stream) {
  if (B > 0 && cap > 0) {
    expand_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vlo), static_cast<const int*>(vhi),
        static_cast<const int*>(runs1), static_cast<const int*>(runs2),
        static_cast<const int*>(scalars), cap, static_cast<int*>(olo), static_cast<int*>(ohi),
        static_cast<int*>(scratch_a), static_cast<int*>(scratch_b));
  }
  return static_cast<int>(cudaGetLastError());
}
