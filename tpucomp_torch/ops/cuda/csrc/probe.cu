// The lowering probes: eleven one-block kernels, each doing on Hopper what
// its probe tests on the TPU.
//
// Replaces the TPU kernels tpucomp/ops/pallas/_probe.py::p1-p11 (the kernel
// bodies at :33, :47, :61, :81, :96, :112, :143, :163, :176, :219, :239; run
// by main() and main2() at :198-216 and :252-257).  None lies on a data path:
// the reference runs them from their own entry point to learn which
// dynamic-indexing forms its compiler takes.  Their TPU memory spaces map so:
//
//   VMEM block (vector memory)  -> global memory, read by the block's threads
//   SMEM block or scratch       -> shared memory (p3, p6, p9, p10) or, for an
//                                  SMEM *input* block (p11), the read-only
//                                  data path (__ldg)
//   make_async_copy + semaphore -> cp.async.cg 16-byte copies, committed and
//                                  waited for as one group, then a barrier
//   pltpu.roll on lanes         -> a rotation among a warp's lanes (shuffles)
//   a masked store              -> a guarded store
//
// The places the TPU leaves undefined are settled as the reference's
// interpret mode settles them: an output element the probe does not write
// holds INT32_MIN, which the interpreter gives (each kernel writes it
// there itself: p4's other rows, p5's lanes below `off`, p9's lanes from
// `n` on, since p9's scratch starts at it), and out-of-range scalars take JAX's dynamic
// indexing rules: a scalar index counts from the end when negative and is
// clamped into the row (p1, p3, p10, p11: 600 reads lane 511, -1 lane 511);
// a dynamic 2-row slice start likewise, clamped to [0, rows - 2] (p4, p7:
// 15 and -1 start at row 14); loop reads and writes past the row clamp to its
// last element (p6, p9).  p7 reads its two source rows before it writes them
// (the interpreter's copy behaves as a snapshot: at s = 1 rows 1-2 take the
// old rows 0-1).
//
// Bound: launch.  Each probe moves at most 64 KiB (p10, p11 read one 16384-
// int32 row) and does a few thousand operations; its time on the card is the
// launch and one round trip to memory.  So a call is one launch and nothing
// else: every kernel writes every element of its output (the wrapper
// allocates it uninitialised), and the host side of an entry point is the
// launch alone.
//
// p10's 64 KiB stage is above the 48 KB of static shared memory: it is
// dynamic shared memory, raised with cudaFuncSetAttribute once a device (at
// the first launch there).  Every entry point returns the CUDA error code of
// its launch (0 on success).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (see
// tpucomp_torch/ops/cuda/_build.py); plain C interface, bound with ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INT32_MIN_V = -2147483647 - 1;

// JAX's dynamic index into n elements: negative counts from the end, then
// clamped into [0, n - 1].
__device__ __forceinline__ int jax_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// JAX's dynamic slice start of `len` of n elements.
__device__ __forceinline__ int jax_start(int s, int len, int n) {
  if (s < 0) s += n;
  return s < 0 ? 0 : (s > n - len ? n - len : s);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Stage n int32 (a multiple of 4, 16-byte aligned) into shared memory with
// cp.async: the counterpart of make_async_copy(...).start(); .wait().
__device__ void stage_row(int* smem, const int* x, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) cp_async16(smem + i, x + i);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// p1: o[0] = x[0, idx] from a (1, 512) row in global memory.
__global__ void p1_kernel(const int* __restrict__ x, const int* __restrict__ idx, int* out) {
  if (threadIdx.x == 0) out[0] = x[jax_index(idx[0], 512)];
}

// p2: each (8, 128) row rotated by `shift` lanes (jnp.roll's direction:
// out[r, j] = x[r, (j - shift) mod 128]).  One warp a row; lane l holds the
// row's elements l, l + 32, l + 64, l + 96, and each output element is
// shuffled in from the lane and register that hold its source.
__global__ void p2_kernel(const int* __restrict__ x, const int* __restrict__ shift, int* out) {
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int* xr = x + row * 128;
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = xr[lane + 32 * k];
  const int s = ((shift[0] % 128) + 128) % 128;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = (lane + 32 * k - s + 128) & 127;  // this output's source element
    int got = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int w = __shfl_sync(FULL, v[q], m & 31);
      if ((m >> 5) == q) got = w;
    }
    out[row * 128 + lane + 32 * k] = got;
  }
}

// p3: the (1, 512) row staged into shared memory, then o[0] = smem[idx].
__global__ void p3_kernel(const int* __restrict__ x, const int* __restrict__ idx, int* out) {
  __shared__ __align__(16) int smem[512];
  stage_row(smem, x, 512);
  if (threadIdx.x == 0) out[0] = smem[jax_index(idx[0], 512)];
}

// p4: rows [r, r + 2) of a (16, 128) block, plus one, stored at the same
// rows; the other rows are unwritten (INT32_MIN).
__global__ void p4_kernel(const int* __restrict__ x, const int* __restrict__ r, int* out) {
  const int lo = jax_start(r[0], 2, 16) * 128;
  for (int i = threadIdx.x; i < 16 * 128; i += blockDim.x)   // 256 threads, 8 elements each
    out[i] = i - lo >= 0 && i - lo < 256 ? x[i] + 1 : INT32_MIN_V;
}

// p5: row 0 stored where lane >= off (a front-masked store); lanes below
// `off` are unwritten (INT32_MIN).
__global__ void p5_kernel(const int* __restrict__ x, const int* __restrict__ off, int* out) {
  const int l = threadIdx.x;
  out[l] = l >= off[0] ? x[l] : INT32_MIN_V;
}

// p6: the (1, 512) row staged into shared memory, then sum(x[0, :n]) in a
// scalar while loop (reads past the row clamp to its last element).
__global__ void p6_kernel(const int* __restrict__ x, const int* __restrict__ n, int* out) {
  __shared__ __align__(16) int smem[512];
  stage_row(smem, x, 512);
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < n[0]; ++i) acc += smem[i < 511 ? i : 511];
    out[0] = acc;
  }
}

// p7: o = x, then o's rows [0, 2) copied onto its rows [s, s + 2), within
// the one buffer: the source rows are read before any is written.
__global__ void p7_kernel(const int* __restrict__ x, const int* __restrict__ s, int* out) {
  for (int i = threadIdx.x; i < 16 * 128; i += blockDim.x) out[i] = x[i];
  __syncthreads();
  const int v = out[threadIdx.x];                              // 256 threads: rows 0-1
  __syncthreads();
  out[jax_start(s[0], 2, 16) * 128 + threadIdx.x] = v;
}

// p8: int32(x) * 2 of a uint8 (8, 128) block.
__global__ void p8_kernel(const uint8_t* __restrict__ x, int* out) {
  for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) out[i] = 2 * static_cast<int>(x[i]);
}

// p9: smem[i] = 3 * i for i < n by one scalar thread (writes past the row
// clamp to its last lane), then the whole 128-lane scratch copied out; lanes
// not written keep the scratch's fill, INT32_MIN.
__global__ void p9_kernel(const int* __restrict__ n, int* out) {
  __shared__ int smem[128];
  smem[threadIdx.x] = INT32_MIN_V;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < n[0]; ++i) smem[i < 127 ? i : 127] = 3 * i;
  __syncthreads();
  out[threadIdx.x] = smem[threadIdx.x];
}

// p10: a (1, 16384) row, 64 KiB, staged into dynamic shared memory, then
// o[0] = smem[idx].
__global__ void p10_kernel(const int* __restrict__ x, const int* __restrict__ idx, int* out) {
  extern __shared__ __align__(16) int big[];
  stage_row(big, x, 16384);
  if (threadIdx.x == 0) out[0] = big[jax_index(idx[0], 16384)];
}

// p11: o[0] = x[0, idx] with the (1, 16384) row as a scalar input block:
// one thread's read through the read-only data path.
__global__ void p11_kernel(const int* __restrict__ x, const int* __restrict__ idx, int* out) {
  if (threadIdx.x == 0) out[0] = __ldg(x + jax_index(__ldg(idx), 16384));
}

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

#define S(p) static_cast<cudaStream_t>(p)
#define I(p) static_cast<const int*>(p)
#define O(p) static_cast<int*>(p)

extern "C" {

int tpucomp_probe_p1(const void* x, const void* idx, void* out, void* stream) {
  p1_kernel<<<1, 32, 0, S(stream)>>>(I(x), I(idx), O(out));
  return done();
}

int tpucomp_probe_p2(const void* x, const void* shift, void* out, void* stream) {
  p2_kernel<<<1, 8 * 32, 0, S(stream)>>>(I(x), I(shift), O(out));
  return done();
}

int tpucomp_probe_p3(const void* x, const void* idx, void* out, void* stream) {
  p3_kernel<<<1, 32, 0, S(stream)>>>(I(x), I(idx), O(out));
  return done();
}

int tpucomp_probe_p4(const void* x, const void* r, void* out, void* stream) {
  p4_kernel<<<1, 256, 0, S(stream)>>>(I(x), I(r), O(out));
  return done();
}

int tpucomp_probe_p5(const void* x, const void* off, void* out, void* stream) {
  p5_kernel<<<1, 128, 0, S(stream)>>>(I(x), I(off), O(out));
  return done();
}

int tpucomp_probe_p6(const void* x, const void* n, void* out, void* stream) {
  p6_kernel<<<1, 32, 0, S(stream)>>>(I(x), I(n), O(out));
  return done();
}

int tpucomp_probe_p7(const void* x, const void* s, void* out, void* stream) {
  p7_kernel<<<1, 256, 0, S(stream)>>>(I(x), I(s), O(out));
  return done();
}

int tpucomp_probe_p8(const void* x, void* out, void* stream) {
  p8_kernel<<<1, 256, 0, S(stream)>>>(static_cast<const uint8_t*>(x), O(out));
  return done();
}

int tpucomp_probe_p9(const void* n, void* out, void* stream) {
  p9_kernel<<<1, 128, 0, S(stream)>>>(I(n), O(out));
  return done();
}

int tpucomp_probe_p10(const void* x, const void* idx, void* out, void* stream) {
  constexpr int kBytes = 16384 * 4;
  static unsigned long long raised = 0;   // devices whose limit is raised (one bit each)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !((raised >> dev) & 1)) {
    e = cudaFuncSetAttribute(p10_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) raised |= 1ull << dev;
  }
  p10_kernel<<<1, 256, kBytes, S(stream)>>>(I(x), I(idx), O(out));
  return done();
}

int tpucomp_probe_p11(const void* x, const void* idx, void* out, void* stream) {
  p11_kernel<<<1, 32, 0, S(stream)>>>(I(x), I(idx), O(out));
  return done();
}

}  // extern "C"
