// Batched Snappy block encode: the element emitter, one warp per chunk.
//
// Replaces the TPU kernel tpucomp/ops/pallas/snappy_encode2.py::_kernel
// (called by compress_batch at snappy_encode2.py:327), the Snappy twin of the
// LZ4 emitter in lz4_encode.cu.  Match finding is not in here: the caller
// first runs the sort-based candidate pass (tpucomp_torch/ops/match.py
// ::candidates2, torch ops), which gives for every position the nearest
// previous 4-byte match `cand`, an 8-byte-prefix sort neighbour `cand8`, and
// `nxt`, the next position that has either.  The walk is then at token rate:
//
//   varint32 preamble of the chunk's size
//   nm = nxt[scan]                   jump the whole literal run
//   extend cand and cand8 forward    capped at size - (nm + 4); keep the
//                                    longer, a tie goes to cand
//   back-extend into the literals    bounded by the anchor and src > 0
//   literal element                  tag of 1, 2, 3 or 4 bytes at
//                                    ll <= 60 / <= 256 / <= 65536 / else
//   copy elements                    64-byte copy-2s while ml >= 68, then 60
//                                    if ml > 64, then the rest; copy-1 only
//                                    for off < 2048 and 4 <= ml <= 11
//
// Matches start below mflimit = size - 3, there is no last-literals rule, and
// the final literals are written only when some remain.  The TPU kernel
// streams the candidate arrays through SMEM in 4096-position slabs over a
// second grid dimension and composes short sequences into one wild store;
// both are TPU artifacts that write the same bytes, so here the walk is one
// loop over the chunk.  Frames are byte-identical to the reference's.
//
// Bound: bytes.  The emitter must read each input byte once and write each
// output byte once (B x out_cap, the zero tail included); it reads the
// candidate arrays only at the positions the walk visits.  Design: a warp per
// chunk, all lanes carrying the same walk state (broadcast loads, uniform
// branches).  Forward extension compares 32 bytes per step and finds the
// first mismatch with __ballot_sync/__ffs; literal copies are spread over the
// lanes; tags and offsets are lane 0's single-byte stores.  Output goes
// straight to the output row (csrc/bytecopy.cuh OutRow): bytes at and past
// out_cap are dropped, and a frame longer than out_cap ends as
// OUTPUT_BUFFER_TOO_SMALL with size 0 (snappy_encode2.py:287-291).  The
// kernel writes every byte of the output row, so the caller's buffer needs no
// clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kOutputTooSmall = 15;
constexpr int kMinMatch = 4;
constexpr int kWarpsPerBlock = 4;

// Literal element: tag (and 1-3 length bytes), then ll bytes from `lit`.
__device__ __forceinline__ int emit_literals(const tpucomp::OutRow& w, int op,
                                             const uint8_t* lit, int ll) {
  const int n = ll - 1;
  if (ll <= 60) {
    w.put(op++, n << 2);
  } else if (ll <= 256) {
    w.put(op++, 60 << 2);
    w.put(op++, n);
  } else if (ll <= 65536) {
    w.put(op++, 61 << 2);
    w.put(op++, n & 0xFF);
    w.put(op++, n >> 8);
  } else {
    w.put(op++, 62 << 2);
    w.put(op++, n & 0xFF);
    w.put(op++, (n >> 8) & 0xFF);
    w.put(op++, (n >> 16) & 0xFF);
  }
  w.copy(op, lit, ll);
  return op + ll;
}

// One copy element of ml <= 64 bytes: copy-1 where it fits, else copy-2.
__device__ __forceinline__ int emit_copy2(const tpucomp::OutRow& w, int op,
                                          int off, int ml) {
  if (off < 2048 && ml >= 4 && ml <= 11) {
    w.put(op, 1 | ((ml - 4) << 2) | ((off >> 8) << 5));
    w.put(op + 1, off & 0xFF);
    return op + 2;
  }
  w.put(op, 2 | ((ml - 1) << 2));
  w.put(op + 1, off & 0xFF);
  w.put(op + 2, off >> 8);
  return op + 3;
}

// A match of any length: the reference encoder's 64/60-byte split.
__device__ __forceinline__ int emit_copy(const tpucomp::OutRow& w, int op,
                                         int off, int ml) {
  while (ml >= 68) {
    op = emit_copy2(w, op, off, 64);
    ml -= 64;
  }
  if (ml > 64) {
    op = emit_copy2(w, op, off, 60);
    ml -= 60;
  }
  return emit_copy2(w, op, off, ml);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
snappy_encode_kernel(const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ sizes,
                     const int32_t* __restrict__ cand,
                     const int32_t* __restrict__ cand8,
                     const int32_t* __restrict__ nxt, int batch, int cap,
                     uint8_t* __restrict__ out, int out_cap,
                     int32_t* __restrict__ out_sizes,
                     int32_t* __restrict__ statuses) {
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  const int32_t* c4 = cand + row;
  const int32_t* c8 = cand8 + row;
  const int32_t* nx = nxt + row;
  const tpucomp::OutRow w{out + static_cast<size_t>(chunk) * out_cap, out_cap,
                          lane};
  const int size = min(max(sizes[chunk], 0), cap);
  const int mflimit = size - kMinMatch + 1;

  int op = 0;
  unsigned rem = static_cast<unsigned>(size);  // varint32 preamble
  while (rem >= 0x80) {
    w.put(op++, (rem & 0x7F) | 0x80);
    rem >>= 7;
  }
  w.put(op++, rem);

  int anchor = 0, scan = 0;
  while (scan < mflimit) {
    const int nm = nx[scan];
    if (nm >= mflimit) break;  // no usable match left: the rest is literal
    const int c4p = c4[nm], c8p = c8[nm];
    const int p4 = c4p >= 0 ? c4p : c8p;
    const int p8 = c8p >= 0 ? c8p : p4;
    const int fcap = size - (nm + kMinMatch);
    const int l4 =
        tpucomp::warp_match_len(in, nm + kMinMatch, p4 + kMinMatch, fcap, lane);
    const int l8 = p8 != p4 ? tpucomp::warp_match_len(in, nm + kMinMatch,
                                                      p8 + kMinMatch, fcap, lane)
                            : l4;
    const int src = l8 > l4 ? p8 : p4;
    int nm2 = nm, src2 = src;
    while (nm2 > anchor && src2 > 0 && in[nm2 - 1] == in[src2 - 1]) {
      --nm2;
      --src2;
    }
    const int ml = (nm - nm2) + kMinMatch + max(l4, l8);
    if (nm2 > anchor) op = emit_literals(w, op, in + anchor, nm2 - anchor);
    op = emit_copy(w, op, nm - src, ml);
    anchor = scan = nm2 + ml;
  }
  if (size > anchor) op = emit_literals(w, op, in + anchor, size - anchor);
  const bool too_big = op > out_cap;
  const int osz = too_big ? 0 : op;
  __syncwarp();  // order lane 0's single-byte stores before the zero fill
  tpucomp::warp_fill(w.p, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = osz;
    statuses[chunk] = too_big ? kOutputTooSmall : kSuccess;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int tpucomp_snappy_encode(const uint8_t* data, const int32_t* sizes,
                                     const int32_t* cand, const int32_t* cand8,
                                     const int32_t* nxt, int batch, int cap,
                                     uint8_t* out, int out_cap,
                                     int32_t* out_sizes, int32_t* statuses,
                                     void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  snappy_encode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, batch, cap, out, out_cap, out_sizes,
      statuses);
  return static_cast<int>(cudaGetLastError());
}
