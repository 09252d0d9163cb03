// Batched Snappy block decode, one warp per chunk.
//
// Replaces the TPU kernel tpucomp/ops/pallas/snappy_decode.py::_kernel
// (called by decompress_batch at snappy_decode.py:158).  That kernel walks
// one chunk per grid step: the scalar core reads tags out of SMEM words and
// moves literals and copies as 128-byte VPU wild stores.  What it computes,
// and what this kernel computes, is:
//
//   varint32 preamble `expected` (assembled in int32: bits above 31 drop, a
//   negative value or a continuation bit after 5 bytes is an error), then
//   elements until ip reaches csize:
//     literal  tag&3 == 0: length t6+1, or 1-4 extra LE length bytes
//     copy-1   tag&3 == 1: length (t6&7)+4, offset (tag>>5)<<8 | b1
//     copy-2   tag&3 == 2: length t6+1, 2-byte offset
//     copy-4   tag&3 == 3: length t6+1, 4-byte offset (int32)
//
// Semantics kept exactly (statuses included) from the reference:
//  * too_big (expected > out_cap) is fixed by the preamble before the walk
//    and beats any error found during it;
//  * a literal or copy that would pass out_cap is not written, but op still
//    advances and the walk goes on; at the end op must equal
//    clip(expected, 0, out_cap + 1);
//  * an offset <= 0 or > op is an error; the 4-byte length and offset are
//    read as int32, so a value with bit 31 set is an error (here the lengths
//    are summed in 64 bits, which turns every such length into an error too);
//  * tag bytes are read through the reference's int32 words of the row
//    padded to wpad = round_up(max(comp_cap, 8), 4) bytes, with the word
//    index clipped (snappy_decode.py:34-49): a tag in the last word reads
//    the 4 bytes before it.  Literal bytes at and past comp_cap read as 0.
//
// Bound: bytes.  A call must read each compressed byte once and write each
// output byte once (B x out_cap, the zero tail included).  Design: chunks are
// independent and their element walks serial, so each chunk gets a warp and
// the batch fills the card; all 32 lanes parse the same element (uniform
// control flow, broadcast loads); literal and copy bytes are spread over the
// lanes (csrc/bytecopy.cuh), 32 neighbouring bytes per store, straight into
// the output row.  The kernel writes every byte of the output row, so the
// caller's buffer needs no clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
constexpr int kWarpsPerBlock = 4;

// The compressed row as the reference's padded words: bytes at and past
// comp_cap (up to wpad) read as 0.
struct Words {
  const uint8_t* p;
  long long n;     // comp_cap
  long long wpad;  // round_up(max(comp_cap, 8), 4)
  __device__ __forceinline__ uint32_t byte(long long j) const {
    return j < n ? p[j] : 0u;
  }
  // getb(i): word min(max(i, 0), wpad - 1) >> 2, byte i & 3 of it.
  __device__ __forceinline__ uint32_t getb(long long i) const {
    const long long ic = min(max(i, 0LL), wpad - 1);
    return byte((ic & ~3LL) | (i & 3));
  }
  // get4(i): bytes i..i+3 from words min(i >> 2, wpad / 4 - 2) and the next.
  __device__ __forceinline__ uint32_t get4(long long i) const {
    const long long b = 4 * min(i >> 2, wpad / 4 - 2) + (i & 3);
    return byte(b) | (byte(b + 1) << 8) | (byte(b + 2) << 16) | (byte(b + 3) << 24);
  }
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
snappy_decode_kernel(const uint8_t* __restrict__ comp,
                     const int32_t* __restrict__ comp_sizes, int batch,
                     int comp_cap, uint8_t* __restrict__ out, int out_cap,
                     int32_t* __restrict__ out_sizes,
                     int32_t* __restrict__ statuses) {
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint8_t* row = comp + static_cast<size_t>(chunk) * comp_cap;
  const Words src{row, comp_cap, (max(comp_cap, 8) + 3LL) / 4 * 4};
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const long long csize = comp_sizes[chunk];

  // ---- varint32 preamble, in 32 bits as the reference
  uint32_t expected_u = src.byte(0) & 0x7F;
  bool more = (src.byte(0) & 0x80) != 0;
  int pre_len = 1;
  for (int k = 1; k < 5; ++k) {
    const uint32_t bk = src.byte(k);
    if (more) {
      expected_u |= (bk & 0x7F) << (7 * k);
      ++pre_len;
    }
    more = more && (bk & 0x80) != 0;
  }
  const long long expected = static_cast<int32_t>(expected_u);
  bool err = more || csize < pre_len || expected < 0;
  const bool too_big = !err && expected > out_cap;

  // Once op passes out_cap + 1 the end check below must fail, so the status
  // is settled and the walk stops (op only grows): the same statuses as the
  // reference, without walking a csize far beyond the row.
  long long ip = err ? csize : pre_len, op = 0;
  while (!err && ip < csize && op <= out_cap + 1LL) {
    const uint32_t w = src.get4(ip);
    const int tag = w & 0xFF, b1 = (w >> 8) & 0xFF, b2 = (w >> 16) & 0xFF,
              b3 = w >> 24;
    const int t6 = tag >> 2;
    if ((tag & 3) == 0) {  // literal
      const int extra = min(max(t6 - 59, 0), 4);
      long long ll = t6 + 1;
      if (extra > 0) {
        uint32_t acc = b1;
        if (extra > 1) acc |= b2 << 8;
        if (extra > 2) acc |= b3 << 16;
        if (extra > 3) acc |= src.getb(ip + 4) << 24;
        ll = static_cast<long long>(static_cast<int32_t>(acc)) + 1;
      }
      const long long s = ip + 1 + extra;
      err = ll < 1 || s + ll > csize;
      if (!err && op + ll <= out_cap)
        tpucomp::warp_copy_bounded(dst + op, row, s, src.n, ll, lane);
      ip = s + ll;
      op += ll;
      continue;
    }
    long long ml, off;
    int hdr;
    if ((tag & 3) == 1) {         // copy-1
      ml = (t6 & 7) + 4;
      off = ((tag >> 5) << 8) | b1;
      hdr = 2;
    } else if ((tag & 3) == 2) {  // copy-2
      ml = t6 + 1;
      off = b1 | (b2 << 8);
      hdr = 3;
    } else {                      // copy-4
      ml = t6 + 1;
      off = static_cast<int32_t>(b1 | (b2 << 8) | (b3 << 16) |
                                 (src.getb(ip + 4) << 24));
      hdr = 5;
    }
    err = ip + hdr > csize || off <= 0 || off > op;
    if (!err && op + ml <= out_cap)
      tpucomp::warp_match_copy(dst, op, static_cast<int>(off), ml, lane);
    ip += hdr;
    op += ml;
  }
  err = (err || op != min(max(expected, 0LL), out_cap + 1LL)) && !too_big;
  const long long osz = (err || too_big) ? 0 : op;
  tpucomp::warp_fill(dst, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = static_cast<int32_t>(osz);
    statuses[chunk] = too_big ? kOutputTooSmall
                              : (err ? kCannotDecompress : kSuccess);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int tpucomp_snappy_decode(const uint8_t* comp, const int32_t* comp_sizes,
                                     int batch, int comp_cap, uint8_t* out,
                                     int out_cap, int32_t* out_sizes,
                                     int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  snappy_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, batch, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}
