// Batched LZ4 block decode, one warp per chunk, behind three entry points.
//
// Replaces three TPU kernels that compute one function:
//  * tpucomp/ops/pallas/lz4_decode2.py::_kernel (called by decompress_batch
//    at lz4_decode2.py:312; kernel row 1): tpucomp_lz4_decode, four warps a
//    block;
//  * tpucomp/ops/pallas/lz4_decode.py::_kernel (called by _pallas_decode at
//    lz4_decode.py:302; row 3), one chunk a grid step:
//    tpucomp_lz4_decode_single, one warp a block;
//  * tpucomp/ops/pallas/lz4_decodek.py::_kernel (called at lz4_decodek.py:296;
//    row 4), K chunks a grid step with their token walks interleaved:
//    tpucomp_lz4_decode_k, min(K, 32) warps a block, K chunks a block.
// The TPU kernels interleave two or K chunks so that the in-order scalar
// core overlaps their load chains, and lz4_decode2 picks a fast, medium or
// slow path per token.  Those are latency tricks of the scalar core; all
// three give the slow path's result (lz4_decode2.py:186-238) plus the
// epilogue (:274-285), and that is what decode_chunk below computes for
// every entry point.  Here the warp scheduler overlaps the chunks' chains.
//
// Bound: bytes.  A call must read each compressed byte once and write each
// output byte once (B x out_cap, the zero tail included); there is no
// arithmetic to speak of.  Design: chunks are independent and their token
// walks serial, so each chunk gets a warp and the batch fills the card.  All
// 32 lanes parse the same token (uniform control flow, broadcast loads: no
// shuffles); literal and match copies are spread over the lanes, 32
// neighbouring bytes per store, straight into the output row in device
// memory.  The kernel writes every byte of the output row (decoded bytes,
// then zeros), so the caller's buffer needs no clearing.
//
// Semantics kept exactly (statuses included) from the reference:
//  * a literal or match that would pass out_cap is not copied, but op still
//    advances and parsing continues, so a later parse error still turns
//    OUTPUT_BUFFER_TOO_SMALL into CANNOT_DECOMPRESS (err wins over too_big);
//  * a length extension stops at csize without error; the caller's
//    ip + ll > csize check catches the truncation;
//  * a stream that ends on a match (no final literal token) is an error;
//  * a negative size is an error from the start, size 0 is SUCCESS/0 bytes.
// Bytes at and past comp_cap read as 0; sizes above comp_cap are outside the
// contract (the reference reads its own padding there).

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
constexpr int kWarpsPerBlock = 4;

// Compressed row with reads past the buffer returning 0.
struct Row {
  const uint8_t* p;
  long long n;
  __device__ __forceinline__ int operator[](long long i) const {
    return (i >= 0 && i < n) ? p[i] : 0;
  }
};

// LZ4 length extension, byte-serial: add bytes until one is not 255 or the
// stream ends (lz4_decode2.py:64-96 reads a word at a time; same result).
__device__ __forceinline__ void read_ext(const Row& src, long long csize,
                                         long long& ip, long long& ln) {
  while (ip < csize) {
    int b = src[ip++];
    ln += b;
    if (b != 255) break;
  }
}

// One chunk, walked by the calling warp (all 32 lanes, converged).
__device__ __forceinline__ void decode_chunk(const uint8_t* __restrict__ comp,
                                             const int32_t* __restrict__ comp_sizes,
                                             int comp_cap, uint8_t* __restrict__ out,
                                             int out_cap, int32_t* __restrict__ out_sizes,
                                             int32_t* __restrict__ statuses, int chunk) {
  const int lane = threadIdx.x & 31;
  const Row src{comp + static_cast<size_t>(chunk) * comp_cap, comp_cap};
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const long long csize = comp_sizes[chunk];

  long long ip = 0, op = 0;
  bool err = csize < 0;
  bool done = err;
  while (!(err || done) && ip < csize) {
    const int token = src[ip++];
    long long ll = token >> 4;
    if (ll == 15) read_ext(src, csize, ip, ll);
    err = ip + ll > csize;
    if (!err && op + ll <= out_cap)
      tpucomp::warp_copy_bounded(dst + op, src.p, ip, src.n, ll, lane);
    ip += ll;
    op += ll;
    done = ip == csize;
    if (done || err) break;

    err = ip + 2 > csize;
    const int off = src[ip] | (src[ip + 1] << 8);
    ip += 2;
    long long ml = token & 15;
    if (ml == 15) read_ext(src, csize, ip, ml);
    ml += 4;
    err = err || ip > csize || off == 0 || off > op;
    if (!err && op + ml <= out_cap)
      tpucomp::warp_match_copy(dst, op, off, ml, lane);
    op += ml;
  }
  err = err || (csize > 0 && !done);
  const bool too_big = !err && op > out_cap;
  const long long osz = (err || too_big) ? 0 : op;
  tpucomp::warp_fill(dst, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = static_cast<int32_t>(osz);
    statuses[chunk] = err ? kCannotDecompress
                          : (too_big ? kOutputTooSmall : kSuccess);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lz4_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ comp_sizes, int batch,
                  int comp_cap, uint8_t* __restrict__ out, int out_cap,
                  int32_t* __restrict__ out_sizes,
                  int32_t* __restrict__ statuses) {
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (chunk >= batch) return;  // the whole warp leaves together
  decode_chunk(comp, comp_sizes, comp_cap, out, out_cap, out_sizes, statuses, chunk);
}

// Row 3: one warp a block, one chunk a block.
__global__ void __launch_bounds__(32)
lz4_decode_single_kernel(const uint8_t* __restrict__ comp,
                         const int32_t* __restrict__ comp_sizes, int comp_cap,
                         uint8_t* __restrict__ out, int out_cap,
                         int32_t* __restrict__ out_sizes,
                         int32_t* __restrict__ statuses) {
  decode_chunk(comp, comp_sizes, comp_cap, out, out_cap, out_sizes, statuses, blockIdx.x);
}

// Row 4: a block takes chunks [k * blockIdx.x, k * blockIdx.x + k), its
// blockDim.x / 32 = min(k, 32) warps striding over them.
__global__ void __launch_bounds__(1024)
lz4_decode_k_kernel(const uint8_t* __restrict__ comp,
                    const int32_t* __restrict__ comp_sizes, int batch,
                    int comp_cap, uint8_t* __restrict__ out, int out_cap,
                    int32_t* __restrict__ out_sizes,
                    int32_t* __restrict__ statuses, int k) {
  const long long first = static_cast<long long>(blockIdx.x) * k;
  const int warps = blockDim.x / 32;
  for (int j = threadIdx.x / 32; j < k; j += warps) {
    const long long chunk = first + j;
    if (chunk >= batch) return;  // the whole warp leaves together
    decode_chunk(comp, comp_sizes, comp_cap, out, out_cap, out_sizes, statuses,
                 static_cast<int>(chunk));
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int tpucomp_lz4_decode(const uint8_t* comp, const int32_t* comp_sizes,
                                  int batch, int comp_cap, uint8_t* out,
                                  int out_cap, int32_t* out_sizes,
                                  int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lz4_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, batch, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpucomp_lz4_decode_single(const uint8_t* comp, const int32_t* comp_sizes,
                                         int batch, int comp_cap, uint8_t* out,
                                         int out_cap, int32_t* out_sizes,
                                         int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  lz4_decode_single_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpucomp_lz4_decode_k(const uint8_t* comp, const int32_t* comp_sizes,
                                    int batch, int comp_cap, uint8_t* out,
                                    int out_cap, int32_t* out_sizes,
                                    int32_t* statuses, int k, void* stream) {
  if (batch <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((static_cast<long long>(batch) + k - 1) / k);
  lz4_decode_k_kernel<<<blocks, 32 * (k < 32 ? k : 32), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, batch, comp_cap, out, out_cap, out_sizes, statuses, k);
  return static_cast<int>(cudaGetLastError());
}
