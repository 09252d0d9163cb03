// Batched raw Deflate (RFC 1951) decode, one warp per chunk.
//
// Replaces the TPU kernel tpucomp/ops/pallas/deflate_decode.py::_kernel
// (called by decompress_batch at deflate_decode.py:420).  That kernel walks
// one chunk per grid step on the scalar core: stateless 32-bit peeks at any
// bit position of the SMEM words, two-level canonical tables built per block
// in SMEM scratch (tpucomp/ops/pallas/huffman.py, here csrc/huffman.cuh), and
// literals and copies as 128-byte VPU wild stores.  What it computes, and what
// this kernel computes, is the RFC 1951 block loop over [start, csize):
//
//   stored  (BTYPE 0): byte-align, LEN/NLEN, copy LEN bytes
//   fixed   (BTYPE 1): the fixed code lengths
//   dynamic (BTYPE 2): HLIT/HDIST/HCLEN, code-length code, lengths with
//                      repeat codes 16/17/18
//   BTYPE 3: error
//
// Semantics kept exactly (statuses included) from the reference:
//  * the block loop runs while !err && !done && bp + 3 <= 8 * csize; a start
//    at or past csize, and a stream that ends before a final block, are
//    errors;
//  * stored: an error if src + 4 + LEN > csize or NLEN != ~LEN; the copy
//    happens only if op + LEN <= out_cap, but op advances regardless;
//  * the lengths scratch persists across blocks; a dynamic header rejects
//    HLIT > 286 and HDIST > 30, moves the distance lengths to index 288 and
//    zeroes [HLIT, 288) and [288 + HDIST, 320); the literal/length table is
//    always built over 288 symbols and the distance table over 32, so the
//    fixed code's symbols 286/287 and distances 30/31 decode and then fail;
//  * in the symbol loop an invalid code, bp past 8 * csize, or dist > op is
//    an error; a literal or match past out_cap is not written but op still
//    advances; the status is too_big = !err && op > out_cap, and an error
//    wins over too_big;
//  * bits are read LSB-first from the row; bytes at and past comp_cap read
//    as 0.
// An error settles the status, so the walk stops at the first one (the
// reference walks on without effect).
//
// Bound: bytes.  A call must read each compressed byte once and write each
// output byte once (B x out_cap, the zero tail included).  Design: chunks are
// independent and their symbol walks serial, so each chunk gets a warp and
// the batch fills the card.  Lane 0 parses a block header and builds its
// tables serially in the warp's shared memory (tables 852 + 592 entries,
// lengths, work and counts: 8.5 KB a warp, 34 KB a block of four warps); the
// warp syncs, then all 32 lanes walk the symbols in lockstep, reading the
// tables and the row as broadcasts.  Literals are single stores by lane 0;
// stored runs and matches are spread over the lanes (csrc/bytecopy.cuh,
// warp_copy_bounded and warp_match_copy, which equals the byte-serial copy
// for every distance).  The kernel writes every byte of the output row
// (decoded bytes, then zeros), so the caller's buffer needs no clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "huffman.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
constexpr int kWarpsPerBlock = 4;
constexpr int kLitRoot = 9;
constexpr int kDistRoot = 6;
constexpr int kClRoot = 7;
constexpr int kEnoughLit = 852;   // proven bound for 288 symbols, 9-bit root
constexpr int kEnoughDist = 592;  // proven bound for 32 symbols, 6-bit root
constexpr int kTabDist = kEnoughLit;

__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                  33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                  1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
__constant__ int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                   6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// The compressed row as a bit stream: bytes at and past comp_cap read as 0.
struct Bits {
  const uint8_t* p;
  long long n;  // comp_cap
  __device__ __forceinline__ uint32_t byte(long long j) const { return j < n ? p[j] : 0u; }
  // n <= 16 bits at bit position pos, LSB first.
  __device__ __forceinline__ uint32_t peek(long long pos, int nb) const {
    const long long b = pos >> 3;
    const uint32_t w = byte(b) | (byte(b + 1) << 8) | (byte(b + 2) << 16) | (byte(b + 3) << 24);
    return (w >> (pos & 7)) & ((1u << nb) - 1u);
  }
};

// Lane 0: the code lengths of a fixed (btype 1) or dynamic (btype 2) block
// header at bp, then its literal/length and distance tables.  Advances bp;
// returns true on error.
__device__ bool block_tables(const tpucomp::HuffScratch& s, const Bits& in, int btype,
                             long long& bp, long long nbits) {
  if (btype == 1) {
    for (int i = 0; i < 320; ++i)
      s.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
  } else {
    const int hlit = static_cast<int>(in.peek(bp, 5)) + 257;
    const int hdist = static_cast<int>(in.peek(bp + 5, 5)) + 1;
    const int hclen = static_cast<int>(in.peek(bp + 10, 4)) + 4;
    bp += 14;
    if (hlit > 286 || hdist > 30) return true;
    for (int i = 0; i < 19; ++i) s.lens[i] = 0;
    for (int i = 0; i < hclen; ++i, bp += 3) s.lens[kClOrder[i]] = static_cast<int>(in.peek(bp, 3));
    if (tpucomp::build_table(s, 0, 19, kClRoot, kTabDist, 128)) return true;
    const int n = hlit + hdist;
    int i = 0, prev = 0;
    while (i < n) {
      int sym, nb;
      bool inv;
      const long long at = bp;
      tpucomp::read_code(s.tab, [&](int k) { return in.peek(at, k); }, kTabDist, kClRoot, sym,
                         nb, inv);
      bp += nb;
      if (inv || bp > nbits) return true;
      if (sym < 16) {
        s.lens[i++] = prev = sym;
        continue;
      }
      const int nb2 = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      const int rep = (sym == 18 ? 11 : 3) + static_cast<int>(in.peek(bp, nb2));
      bp += nb2;
      const int val = sym == 16 ? prev : 0;
      if ((sym == 16 && i == 0) || i + rep > n) return true;
      for (int k = 0; k < rep; ++k) s.lens[i + k] = val;
      i += rep;
      prev = val;
    }
    for (int k = hdist - 1; k >= 0; --k) s.lens[288 + k] = s.lens[hlit + k];  // dst >= src
    for (int k = hlit; k < 288; ++k) s.lens[k] = 0;
    for (int k = 288 + hdist; k < 320; ++k) s.lens[k] = 0;
  }
  return tpucomp::build_table(s, 0, 288, kLitRoot, 0, kEnoughLit) ||
         tpucomp::build_table(s, 288, 32, kDistRoot, kTabDist, kEnoughDist);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deflate_decode_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes,
                      const int32_t* __restrict__ starts, int batch, int comp_cap,
                      uint8_t* __restrict__ out, int out_cap, int32_t* __restrict__ out_sizes,
                      int32_t* __restrict__ statuses) {
  __shared__ int32_t s_tab[kWarpsPerBlock][kEnoughLit + kEnoughDist];
  __shared__ int32_t s_lens[kWarpsPerBlock][320];
  __shared__ int32_t s_work[kWarpsPerBlock][320];
  __shared__ int32_t s_cnt[kWarpsPerBlock][16];
  __shared__ int32_t s_ofs[kWarpsPerBlock][16];
  const int w = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + w;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const tpucomp::HuffScratch s{s_tab[w], s_lens[w], s_work[w], s_cnt[w], s_ofs[w]};
  const uint8_t* row = comp + static_cast<size_t>(chunk) * comp_cap;
  const Bits in{row, comp_cap};
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const long long csize = comp_sizes[chunk];
  const long long start = starts[chunk];
  const long long nbits = csize * 8;

  long long bp = start * 8, op = 0;
  bool err = csize <= start, done = false;
  while (!err && !done && bp + 3 <= nbits) {
    done = in.peek(bp, 1) != 0;
    const int btype = static_cast<int>(in.peek(bp + 1, 2));
    bp += 3;
    if (btype == 0) {  // stored
      bp = (bp + 7) & ~7LL;
      const long long src = bp >> 3;
      const long long ln = in.peek(bp, 16);
      err = src + 4 + ln > csize || (ln ^ in.peek(bp + 16, 16)) != 0xFFFF;
      if (!err && op + ln <= out_cap)
        tpucomp::warp_copy_bounded(dst + op, row, src + 4, comp_cap, ln, lane);
      bp += 32 + ln * 8;
      op += ln;
    } else if (btype == 3) {
      err = true;
    } else {
      __syncwarp();  // every lane is done reading the previous block's tables
      if (lane == 0) err = block_tables(s, in, btype, bp, nbits);
      __syncwarp();
      err = __shfl_sync(tpucomp::kFullMask, static_cast<int>(err), 0) != 0;
      bp = __shfl_sync(tpucomp::kFullMask, bp, 0);
      while (!err) {  // symbols, all lanes in lockstep
        int sym, nb;
        bool inv;
        const long long at = bp;
        tpucomp::read_code(s.tab, [&](int k) { return in.peek(at, k); }, 0, kLitRoot, sym, nb,
                           inv);
        bp += nb;
        err = inv || bp > nbits;
        if (err || sym == 256) break;
        if (sym < 256) {
          if (lane == 0 && op < out_cap) dst[op] = static_cast<uint8_t>(sym);
          ++op;
          continue;
        }
        const int li = sym - 257;
        if (li >= 29) {
          err = true;
          break;
        }
        const int mlen = kLenBase[li] + static_cast<int>(in.peek(bp, kLenExtra[li]));
        bp += kLenExtra[li];
        int dsym, dnb;
        bool dinv;
        const long long dat = bp;
        tpucomp::read_code(s.tab, [&](int k) { return in.peek(dat, k); }, kTabDist, kDistRoot,
                           dsym, dnb, dinv);
        bp += dnb;
        if (dinv || dsym >= 30) {
          err = true;
          break;
        }
        const int dist = kDistBase[dsym] + static_cast<int>(in.peek(bp, kDistExtra[dsym]));
        bp += kDistExtra[dsym];
        err = dist > op || bp > nbits;
        if (err) break;
        if (op + mlen <= out_cap) {
          __syncwarp();  // lane 0's literals are visible to every lane
          tpucomp::warp_match_copy(dst, op, dist, mlen, lane);
        }
        op += mlen;
      }
    }
    err = err || bp > nbits;
  }
  err = err || !done;
  const bool too_big = !err && op > out_cap;
  const long long osz = (err || too_big) ? 0 : op;
  __syncwarp();  // order lane 0's literal stores before the zero fill
  tpucomp::warp_fill(dst, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = static_cast<int32_t>(osz);
    statuses[chunk] = err ? kCannotDecompress : (too_big ? kOutputTooSmall : kSuccess);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int tpucomp_deflate_decode(const uint8_t* comp, const int32_t* comp_sizes,
                                      const int32_t* starts, int batch, int comp_cap,
                                      uint8_t* out, int out_cap, int32_t* out_sizes,
                                      int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  deflate_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, starts, batch, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}
