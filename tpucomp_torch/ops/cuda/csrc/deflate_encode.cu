// Batched raw Deflate encode: the token walk, one warp a chunk (mode
// fixed), and the parallel parse, one CTA of 1024 threads a chunk (modes
// hist and emit).
//
// Replaces the TPU kernel tpucomp/ops/pallas/deflate_encode.py::_kernel in
// its three trace-time modes: "fixed" (called by compress_batch at
// deflate_encode.py:541, algo 0), "hist" (compress_batch_dyn at :681) and
// "emit" (compress_batch_dyn at :701, algos 1 and 2).  Match finding is not
// in here: the caller first runs the sort-based candidate pass
// (tpucomp_torch/ops/match.py::candidates2 with the 32 KiB window), which
// gives for every position the nearest previous 4-byte match `cand`, an
// 8-byte-prefix sort neighbour `cand8`, and `nxt`, the next position that has
// either (all three null for entropy-only coding: no matches).  Every mode
// sees the tokens of one walk, so the hist and emit passes agree:
//
//   nm = nxt[scan]; stop at nm >= mflimit = size - 3
//   extend cand and cand8 forward, at most min(size - (nm + 4), 254) bytes;
//   keep the longer (cand8 only if longer)
//   back-extend while nm2 > anchor, src2 > 0 and the bytes before match
//   ml = min(back + 4 + longer, 258): literals [anchor, nm2), the match,
//   anchor = scan = nm2 + ml
//
// then the literals [anchor, size) and the end-of-block code.
//  * fixed (the walk): header bits 011, literals and lengths in the
//    closed-form fixed codes (8/9-bit literals, 7/8-bit length symbols,
//    5-bit distances), length and distance symbols from their bit lengths;
//    EOB is 7 zero bits.
//  * hist (the parse): counts of literal/length symbols (EOB once) and
//    distance symbols into int32[B, 288] and int32[B, 30]; no output bits.
//  * emit (the parse): hdr_bits bits of hdr_words (LSB first) first, then
//    every symbol from tab[sym] = bit-reversed code | length << 16
//    (distances at 288+), EOB from tab[256].
// The stream is LSB first; a 64-bit accumulator writes 4 bytes whenever it
// holds 32 bits and ceil(bits / 8) bytes at the end, the same bytes as the
// TPU kernel's (lo, hi, nbits) triple.  A stream longer than stored blocks
// (size + 5 * max(ceil(size / 65535), 1) < its bytes) is rewritten as stored
// blocks of at most 65535 bytes with headers [last, n & 255, n >> 8, nlen &
// 255, nlen >> 8], nlen = 0xFFFF - n; size 0 gives one empty final block.
// A frame longer than out_cap ends as OUTPUT_BUFFER_TOO_SMALL with size 0:
// the TPU kernel writes into a row of max(out_cap, cap + cap/2 + 64) bytes
// (fixed) or + 3000 (emit) and drops the excess; here the bytes are counted
// and never stored past the row (OutRow, csrc/bytecopy.cuh).  The TPU
// kernel's 4096-position slabs over a second grid dimension only pipeline
// the candidate arrays through SMEM; a jump past a slab is taken up by the
// next one, so here the walk is one loop over the chunk.
//
// Bound: bytes.  A call must read each input byte once and write each output
// byte once (B x out_cap, the zero tail included; hist writes B x 318
// counts); the walk reads the candidate arrays only where it lands (the
// parse reads cand and cand8 in full, which the bound does not count).
// hist and emit: csrc/lz_parse.cuh's parse of the chunk (its first 64 KiB,
// Deflate's largest chunk: every position's next token at once, 32 merged
// chases of next(), the tokens recomputed and numbered at once).  hist then
// runs the counting phase both formats share (lz_parse.cuh's count_symbols:
// the matches' symbols and a coverage bitmask of their bytes, then the
// uncovered bytes a warp word at a time, warp-aggregated increments into 8
// copies of the counts in shared memory); entropy only is the staged bytes'
// histogram, with no parse.  emit then builds the stream from the tokens'
// bit counts: one pass sums them (the header's bits first, the end-of-block
// code last), so the stored rewrite and OUTPUT_BUFFER_TOO_SMALL are decided
// before a bit is placed; a second codes the tokens in super-rounds of 2048,
// a block scan of their bit counts places them, their codes are or-ed into a
// ring of 4096 words in shared memory, and the finished words go to the row.
// Entropy-only coding has every byte a literal token.  Design of the walk: a
// warp per chunk, all lanes carrying the same walk state (broadcast loads,
// uniform branches), lane 0 storing the stream's bytes; forward extension
// compares 32 bytes a step with a ballot (warp_match_len); stored blocks are
// copied by the whole warp.  The fixed and emit kernels write every byte of
// the output row, so the caller's buffer needs no clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "lz_parse.cuh"

namespace {

using lzp::dist_sym;
using lzp::len_sym;
constexpr int kSuccess = 0;
constexpr int kOutputTooSmall = 15;
constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 258;
constexpr int kWarpsPerBlock = 4;
constexpr int kNTab = 288 + 30;
constexpr int kHdrWords = 80;

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int n) {
  return n ? __brev(v) >> (32 - n) : 0u;
}

// The LSB-first bit stream into one output row; every lane holds the same
// state, lane 0 stores.
struct BitOut {
  tpucomp::OutRow w;
  int op;
  uint64_t acc;
  int nb;
  __device__ __forceinline__ void put(uint32_t v, int n) {
    acc |= static_cast<uint64_t>(v) << nb;
    nb += n;
    if (nb >= 32) {
      for (int k = 0; k < 4; ++k) w.put(op + k, static_cast<int>((acc >> (8 * k)) & 0xFF));
      op += 4;
      acc >>= 32;
      nb -= 32;
    }
  }
  __device__ __forceinline__ void flush() {
    for (; nb > 0; nb = max(nb - 8, 0)) {
      w.put(op++, static_cast<int>(acc & 0xFF));
      acc >>= 8;
    }
  }
};

// A literal's and a match's fixed codes.
__device__ __forceinline__ void put_lit(BitOut& bits, int v) {
  bits.put(v < 144 ? rev_bits(0x30 + v, 8) : rev_bits(0x190 + v - 144, 9), v < 144 ? 8 : 9);
}

__device__ __forceinline__ void put_match(BitOut& bits, int ml, int dist) {
  int li, e, ev, di, de, dv;
  len_sym(ml, li, e, ev);
  dist_sym(dist, di, de, dv);
  const int lsym = 257 + li;
  const bool short_code = lsym < 280;
  const int n = short_code ? 7 : 8;
  bits.put(rev_bits(short_code ? lsym - 256 : 0xC0 + lsym - 280, n), n);
  bits.put(ev, e);
  bits.put(rev_bits(di, 5), 5);
  bits.put(dv, de);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deflate_fixed_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                     const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
                     const int32_t* __restrict__ nxt, int batch, int cap,
                     uint8_t* __restrict__ out, int out_cap, int32_t* __restrict__ out_sizes,
                     int32_t* __restrict__ statuses) {
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  const int size = min(max(sizes[chunk], 0), cap);

  BitOut bits{{out + static_cast<size_t>(chunk) * out_cap, out_cap, lane}, 0, 0, 0};
  bits.put(0b011, 3);  // BFINAL = 1, BTYPE = 01

  const int mflimit = size - kMinMatch + 1;
  int anchor = 0, scan = 0;
  if (nxt != nullptr) {
    const int32_t* c4 = cand + row;
    const int32_t* c8 = cand8 + row;
    const int32_t* nx = nxt + row;
    while (scan < mflimit) {
      const int nm = nx[scan];
      if (nm >= mflimit) break;  // no usable match left: the rest is literal
      const int c4p = c4[nm], c8p = c8[nm];
      const int p4 = c4p >= 0 ? c4p : c8p;
      const int p8 = c8p >= 0 ? c8p : p4;
      const int fcap = min(size - (nm + kMinMatch), kMaxMatch - kMinMatch);
      const int l4 = tpucomp::warp_match_len(in, nm + kMinMatch, p4 + kMinMatch, fcap, lane);
      const int l8 = p8 != p4
                         ? tpucomp::warp_match_len(in, nm + kMinMatch, p8 + kMinMatch, fcap, lane)
                         : l4;
      const int src = l8 > l4 ? p8 : p4;
      int nm2 = nm, src2 = src;
      while (nm2 > anchor && src2 > 0 && in[nm2 - 1] == in[src2 - 1]) {
        --nm2;
        --src2;
      }
      const int ml = min(nm - nm2 + kMinMatch + max(l4, l8), kMaxMatch);
      for (int i = anchor; i < nm2; ++i) put_lit(bits, in[i]);
      put_match(bits, ml, nm - src);
      anchor = scan = nm2 + ml;
    }
  }
  for (int i = anchor; i < size; ++i) put_lit(bits, in[i]);
  bits.put(0, 7);  // EOB: symbol 256, code 0
  bits.flush();

  const tpucomp::OutRow& w = bits.w;
  int op = bits.op;
  const int n_blocks = max((size + 65534) / 65535, 1);
  if (size + 5 * n_blocks < op) {  // stored blocks are shorter: rewrite
    __syncwarp();                  // lane 0's stream bytes land before the copies
    int src = 0;
    op = 0;
    do {
      const int n = min(size - src, 65535);
      const int nlen = 0xFFFF - n;
      w.put(op, size - src == n ? 1 : 0);
      w.put(op + 1, n & 0xFF);
      w.put(op + 2, n >> 8);
      w.put(op + 3, nlen & 0xFF);
      w.put(op + 4, nlen >> 8);
      w.copy(op + 5, in + src, n);
      src += n;
      op += 5 + n;
    } while (src < size);
  }
  const bool too_big = op > out_cap;
  const int osz = too_big ? 0 : op;
  __syncwarp();  // order lane 0's stores before the zero fill
  tpucomp::warp_fill(w.p, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = osz;
    statuses[chunk] = too_big ? kOutputTooSmall : kSuccess;
  }
}

// ================================================================== emit ==
// One CTA of 1024 threads a chunk: the parse of csrc/lz_parse.cuh, then the
// stream from the tokens' bit counts.

using lzp::kPThreads;
using lzp::kPWarps;
constexpr int kWarpRounds = 2;                       // rounds a warp codes a super-round
constexpr int kRingWords = 4096;                     // the stream's ring of words
constexpr int kOffRing = lzp::kEndDm;                // u32 [kRingWords] in region A
constexpr int kOffWarpBits = kOffRing + 4 * kRingWords;  // int [kPWarps]
static_assert(kOffWarpBits + 4 * kPWarps <= lzp::kBytesA, "region A overflows");
static_assert(4 * kNTab <= lzp::kTailBytes, "the code table does not fit the tail");
// a super-round's tokens (<= 48 bits each) and the word left over fit the ring
static_assert(kRingWords >= (kPThreads * kWarpRounds * 48 + 31) / 32 + 2, "the ring is short");

// Token t's codes (LSB first) and their bit count: a literal's code, or a
// match's length code, length extra bits, distance code, distance extra bits.
__device__ __forceinline__ void token_code(int t, unsigned mm, int jm, int lane, const uint32_t* pm,
                                           const uint16_t* dm, const uint16_t* tnum,
                                           const uint8_t* bytes, const int32_t* tab,
                                           uint64_t& val, int& nbits) {
  const int below = __popc(mm & ((1u << lane) - 1u));
  if ((mm >> lane) & 1) {
    const int j = jm + below;
    int li, e, ev, di, de, dv;
    len_sym(static_cast<int>(pm[j] >> 16) + 3, li, e, ev);
    dist_sym(dm[j] + 1, di, de, dv);
    const uint32_t c1 = tab[257 + li] & 0xFFFF, c3 = tab[288 + di] & 0xFFFF;
    const int n1 = tab[257 + li] >> 16, n3 = tab[288 + di] >> 16;
    val = c1 | (static_cast<uint64_t>(ev) << n1) | (static_cast<uint64_t>(c3) << (n1 + e)) |
          (static_cast<uint64_t>(dv) << (n1 + e + n3));
    nbits = n1 + e + n3 + de;
  } else {
    const int v = bytes[lzp::literal_pos(pm, tnum, jm + below - 1, t)];
    val = static_cast<uint32_t>(tab[v] & 0xFFFF);
    nbits = tab[v] >> 16;
  }
}

__global__ void __launch_bounds__(kPThreads, 1)
deflate_emit_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                    const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
                    const int32_t* __restrict__ nxt, int cap, const int32_t* __restrict__ tab,
                    const int32_t* __restrict__ hdr_words, const int32_t* __restrict__ hdr_bits,
                    uint8_t* __restrict__ out, int out_cap, int32_t* __restrict__ out_sizes,
                    int32_t* __restrict__ statuses) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t* pm = reinterpret_cast<const uint32_t*>(smem + lzp::kOffPm);
  const uint16_t* dm = reinterpret_cast<const uint16_t*>(smem + lzp::kOffDm);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kOffRing);
  int* wbits = reinterpret_cast<int*>(smem + kOffWarpBits);
  const uint8_t* bytes = smem + lzp::kOffB;
  const uint16_t* tnum = reinterpret_cast<const uint16_t*>(smem + lzp::kOffC);
  int32_t* s_tab = reinterpret_cast<int32_t*>(smem + lzp::kOffTail);
  int* scr = reinterpret_cast<int*>(smem + lzp::kOffScr);
  int* misc = reinterpret_cast<int*>(smem + lzp::kOffMisc);

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  // a row past Deflate's largest chunk is parsed over its first 64 KiB
  // (the caller gives such a chunk ERROR_CHUNK_SIZE_TOO_LARGE)
  const int size = min(max(sizes[chunk], 0), min(cap, lzp::kMaxPos));
  const bool matches = nxt != nullptr;

  // ---- 1-5: stage the bytes and the table, parse
  lzp::stage_bytes(smem + lzp::kOffB, in, size, cap, tid);
  for (int i = tid; i < kNTab; i += kPThreads) s_tab[i] = tab[static_cast<size_t>(chunk) * kNTab + i];
  lzp::deflate_parse(smem, matches ? cand + row : nullptr, matches ? cand8 + row : nullptr,
                     matches ? nxt + row : nullptr, size, matches, tid, lane, wi);
  const int m = misc[lzp::kM];
  const int ntok = misc[lzp::kTokens];
  const int rounds = (ntok + 31) >> 5;
  constexpr int kRows = kPWarps * kWarpRounds;  // rounds a super-round

  // ---- 6a: the stream's length: the header, every token's codes, EOB
  const int hn = hdr_bits[chunk];
  int mine = 0;
  {
    int jm = 0;
    for (int g = 0; g * kRows < rounds; ++g) {
#pragma unroll
      for (int k = 0; k < kWarpRounds; ++k) {
        const int key = (g * kRows + wi * kWarpRounds + k) * 32;
        const unsigned mm = lzp::round_matches(tnum, m, key, jm, lane);
        if (key + lane < ntok) {
          uint64_t v;
          int nb;
          token_code(key + lane, mm, jm, lane, pm, dm, tnum, bytes, s_tab, v, nb);
          mine += nb;
        }
      }
    }
  }
  const int before = lzp::block_scan_excl(mine, 0, [](int a, int b) { return a + b; }, scr, lane,
                                          wi);
  if (tid == kPThreads - 1) misc[lzp::kAux] = before + mine;
  __syncthreads();
  const int total = hn + misc[lzp::kAux] + (s_tab[256] >> 16);
  int op = (total + 7) >> 3;
  const int n_blocks = max((size + 65534) / 65535, 1);
  const bool stored = size + 5 * n_blocks < op;  // stored blocks are shorter
  if (stored) op = size + 5 * n_blocks;
  const bool too_big = op > out_cap;
  uint8_t* orow = out + static_cast<size_t>(chunk) * out_cap;
  const int osz = too_big ? 0 : op;
  if (tid == 0) {
    out_sizes[chunk] = osz;
    statuses[chunk] = too_big ? kOutputTooSmall : kSuccess;
  }
  lzp::zero_bytes(orow, osz, out_cap, tid);
  if (too_big) return;
  if (stored) {  // blocks of at most 65535 bytes, headers [last, n, n >> 8, ~n, ~n >> 8]
    for (int o = tid; o < op; o += kPThreads) {
      const int blk = o / 65540, r = o - blk * 65540;
      const int src = blk * 65535;
      const int n = min(size - src, 65535);
      int v;
      if (r >= 5) {
        v = bytes[src + r - 5];
      } else {
        const int nlen = 0xFFFF - n;
        v = r == 0 ? (size - src == n ? 1 : 0) : r == 1 ? n & 0xFF : r == 2 ? n >> 8
            : r == 3 ? nlen & 0xFF : nlen >> 8;
      }
      orow[o] = static_cast<uint8_t>(v);
    }
    return;
  }

  // ---- 6b: the stream: the header words, then super-rounds of tokens (a
  // block scan of their bit counts places them; codes are or-ed into a ring
  // of words and the finished words go to the row), then EOB
  const bool aligned = (reinterpret_cast<uintptr_t>(orow) & 3) == 0;
  auto flush = [&](int f0, int f1) {  // ring words [f0, f1) to the row, bytes below op
    for (int k = f0 + tid; k < f1; k += kPThreads) {
      const uint32_t v = ring[k & (kRingWords - 1)];
      ring[k & (kRingWords - 1)] = 0;
      if (aligned && 4 * k + 4 <= op) {
        *reinterpret_cast<uint32_t*>(orow + 4 * k) = v;
      } else {
        for (int b = 0; b < 4 && 4 * k + b < op; ++b)
          orow[4 * k + b] = static_cast<uint8_t>(v >> (8 * b));
      }
    }
  };
  for (int i = tid; i < kRingWords; i += kPThreads) {
    uint32_t v = 0;
    if (32 * i < hn) {
      v = static_cast<uint32_t>(hdr_words[static_cast<size_t>(chunk) * kHdrWords + i]);
      if (hn - 32 * i < 32) v &= (1u << (hn - 32 * i)) - 1u;
    }
    ring[i] = v;
  }
  __syncthreads();
  int base = hn, flushed = 0;
  int jm = 0;
  for (int g = 0; g * kRows < rounds; ++g) {
    uint64_t val[kWarpRounds];
    int nb[kWarpRounds], inc[kWarpRounds];
    int wsum = 0;
#pragma unroll
    for (int k = 0; k < kWarpRounds; ++k) {
      const int key = (g * kRows + wi * kWarpRounds + k) * 32;
      const unsigned mm = lzp::round_matches(tnum, m, key, jm, lane);
      val[k] = 0;
      nb[k] = 0;
      if (key + lane < ntok) token_code(key + lane, mm, jm, lane, pm, dm, tnum, bytes, s_tab,
                                        val[k], nb[k]);
      int x = nb[k];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(lzp::kFull, x, o);
        if (lane >= o) x += u;
      }
      inc[k] = wsum + x;  // inclusive, within the warp's rows
      wsum += __shfl_sync(lzp::kFull, x, 31);
    }
    if (lane == 0) wbits[wi] = wsum;
    __syncthreads();
    int wbase = 0, gsum = 0;
    for (int w = 0; w < kPWarps; ++w) {  // the warps before this one, and all of them
      const int b = wbits[w];
      wbase += w < wi ? b : 0;
      gsum += b;
    }
#pragma unroll
    for (int k = 0; k < kWarpRounds; ++k) {
      if (!val[k]) continue;
      const int o = base + wbase + inc[k] - nb[k];
      const int k0 = o >> 5, sh = o & 31;
      const uint64_t lo = val[k] << sh;
      const uint32_t hi = sh ? static_cast<uint32_t>(val[k] >> (64 - sh)) : 0u;
      atomicOr(ring + (k0 & (kRingWords - 1)), static_cast<uint32_t>(lo));
      if (lo >> 32) atomicOr(ring + ((k0 + 1) & (kRingWords - 1)), static_cast<uint32_t>(lo >> 32));
      if (hi) atomicOr(ring + ((k0 + 2) & (kRingWords - 1)), hi);
    }
    __syncthreads();
    base += gsum;
    flush(flushed, base >> 5);
    flushed = base >> 5;
    __syncthreads();
  }
  if (tid == 0) {  // end of block
    const uint32_t v = s_tab[256] & 0xFFFF;
    const int k0 = base >> 5, sh = base & 31;
    const uint64_t lo = static_cast<uint64_t>(v) << sh;
    ring[k0 & (kRingWords - 1)] |= static_cast<uint32_t>(lo);
    ring[(k0 + 1) & (kRingWords - 1)] |= static_cast<uint32_t>(lo >> 32);
  }
  __syncthreads();
  flush(flushed, (total + 31) >> 5);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).  cand, cand8 and nxt are all null for entropy-only coding.
extern "C" int tpucomp_deflate_encode_fixed(const uint8_t* data, const int32_t* sizes,
                                            const int32_t* cand, const int32_t* cand8,
                                            const int32_t* nxt, int batch, int cap,
                                            uint8_t* out, int out_cap, int32_t* out_sizes,
                                            int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  deflate_fixed_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, batch, cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

// hist and emit read at most the first 64 KiB of a row.
extern "C" int tpucomp_deflate_encode_hist(const uint8_t* data, const int32_t* sizes,
                                           const int32_t* cand, const int32_t* cand8,
                                           const int32_t* nxt, int batch, int cap,
                                           int32_t* llh, int32_t* dh, void* stream) {
  return lzp::launch_hist<30, 1>(data, sizes, cand, cand8, nxt, batch, cap, llh, dh, stream);
}

extern "C" int tpucomp_deflate_encode_emit(const uint8_t* data, const int32_t* sizes,
                                           const int32_t* cand, const int32_t* cand8,
                                           const int32_t* nxt, int batch, int cap,
                                           const int32_t* tab, const int32_t* hdr_words,
                                           const int32_t* hdr_bits, uint8_t* out, int out_cap,
                                           int32_t* out_sizes, int32_t* statuses,
                                           void* stream) {
  if (batch <= 0) return 0;
  static unsigned long long raised = 0;  // one bit a device
  const cudaError_t e = lzp::raise_smem_limit(deflate_emit_kernel, lzp::kSmemBytes, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  deflate_emit_kernel<<<batch, kPThreads, lzp::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, cap, tab, hdr_words, hdr_bits, out, out_cap, out_sizes,
      statuses);
  return static_cast<int>(cudaGetLastError());
}
