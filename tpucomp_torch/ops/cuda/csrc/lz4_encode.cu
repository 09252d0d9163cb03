// Batched LZ4 block encode: the token emitter, one warp per chunk.
//
// Replaces the TPU kernel tpucomp/ops/pallas/lz4_encode2.py::_kernel (called
// by compress_batch at lz4_encode2.py:295).  Match finding is not in here: the
// caller first runs the sort-based candidate pass (tpucomp_torch/ops/match.py
// ::candidates2, torch ops), which gives for every position the nearest
// previous 4-byte match `cand`, an 8-byte-prefix sort neighbour `cand8`, and
// `nxt`, the next position that has either.  The walk is then at token rate:
//
//   nm = nxt[scan]                   jump the whole literal run
//   extend cand and cand8 forward    keep the longer (cand8 only if longer)
//   back-extend into the literals    bounded by the anchor and src > 0
//   emit token, literals, offset     standard LZ4 block format
//
// with the end-of-block rules MF_LIMIT 12 (no match starts in the last 12
// bytes) and LAST_LITERALS 5, and a final literal-only sequence that is
// always written, even when empty.  The TPU kernel streams the candidate
// arrays through SMEM in 4096-position slabs over a second grid dimension;
// that is a pipelining artifact, and here the walk is one loop over the
// chunk (a jump past the slab of the TPU kernel is never usable there either,
// since such a target is >= mflimit).  Frames are byte-identical to the
// reference's.
//
// Bound: bytes.  The emitter must read each input byte once and write each
// output byte once (B x out_cap, the zero tail included); it reads the
// candidate arrays only at the positions the walk visits.  Design: a warp per
// chunk, all lanes carrying the same walk state (broadcast loads, uniform
// branches).  Forward extension compares 32 bytes per step and finds the
// first mismatch with __ballot_sync/__ffs; literal copies and 255-runs of
// length extensions are spread over the lanes.  Output goes straight to the
// output row; bytes at and past out_cap are dropped, and a frame longer than
// out_cap ends as OUTPUT_BUFFER_TOO_SMALL with size 0 (lz4_encode2.py:253-257).
// The kernel writes every byte of the output row, so the caller's buffer
// needs no clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kOutputTooSmall = 15;
constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kWarpsPerBlock = 4;

// LZ4 length extension: k / 255 bytes of 255, then k % 255.
__device__ __forceinline__ int put_ext(const tpucomp::OutRow& w, int o, int k) {
  const int n255 = k / 255;
  w.fill(o, o + n255, 255);
  w.put(o + n255, k % 255);
  return o + n255 + 1;
}

// One sequence: token, literal-length extension, ll literals from `lit`,
// then (when ml > 0) the 2-byte offset and the match-length extension.
__device__ __forceinline__ int emit_seq(const tpucomp::OutRow& w, int op,
                                        const uint8_t* lit, int ll, int ml,
                                        int off) {
  w.put(op++, (min(ll, 15) << 4) | min(max(ml - kMinMatch, 0), 15));
  if (ll >= 15) op = put_ext(w, op, ll - 15);
  w.copy(op, lit, ll);
  op += ll;
  if (ml > 0) {
    w.put(op, off & 0xFF);
    w.put(op + 1, off >> 8);
    op += 2;
    if (ml - kMinMatch >= 15) op = put_ext(w, op, ml - kMinMatch - 15);
  }
  return op;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lz4_encode_kernel(const uint8_t* __restrict__ data,
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
  const int mflimit = size - kMfLimit;
  const int match_cap_end = size - kLastLiterals;

  int anchor = 0, scan = 0, op = 0;
  while (scan < mflimit) {
    const int nm = nx[scan];
    if (nm >= mflimit) break;  // no usable match left: the rest is literal
    const int c4p = c4[nm], c8p = c8[nm];
    const int p4 = c4p >= 0 ? c4p : c8p;
    const int p8 = c8p >= 0 ? c8p : p4;
    const int fcap = match_cap_end - (nm + kMinMatch);
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
    op = emit_seq(w, op, in + anchor, nm2 - anchor, ml, nm - src);
    anchor = scan = nm2 + ml;
  }
  op = emit_seq(w, op, in + anchor, size - anchor, 0, 0);
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
extern "C" int tpucomp_lz4_encode(const uint8_t* data, const int32_t* sizes,
                                  const int32_t* cand, const int32_t* cand8,
                                  const int32_t* nxt, int batch, int cap,
                                  uint8_t* out, int out_cap, int32_t* out_sizes,
                                  int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lz4_encode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, batch, cap, out, out_cap, out_sizes,
      statuses);
  return static_cast<int>(cudaGetLastError());
}
