// Batched GDeflate encode: the token parse of a chunk, one CTA of 1024
// threads a chunk, then its symbol counts (mode hist) or its emission into 32
// round-robin lane bit buffers (modes fixed and emit).
//
// Replaces the TPU kernel tpucomp/ops/pallas/gdeflate_encode.py::_kernel in
// its three trace-time modes: "fixed" and "emit" (called at
// gdeflate_encode.py:471; algo 0, algos 1 and 2) and "hist" (called at :453,
// algos 1 and 2).  Match finding is not in here: the caller first runs the
// sort-based candidate pass (tpucomp_torch/ops/match.py::candidates2 with the
// 64 KiB window), which gives for every position the nearest previous 4-byte
// match `cand`, an 8-byte-prefix sort neighbour `cand8`, and `nxt`, the next
// position that has either (all three null for entropy-only coding).  Every
// mode sees the tokens of csrc/deflate_encode.cu's walk:
//
//   nm = nxt[scan]; stop at nm >= mflimit = size - 3
//   extend cand and cand8 forward, at most min(size - (nm + 4), 254) bytes;
//   keep the longer (cand8 only if longer)
//   back-extend while nm2 > anchor, src2 > 0 and the bytes before match
//   ml = min(back + 4 + longer, 258): literals [anchor, nm2), the match,
//   anchor = scan = nm2 + ml
//
// then the literals [anchor, size); there is no end-of-block symbol.
// Distances use GDeflate's 32 codes (30 and 31 carry 14 extra bits).
//  * hist: litlen and distance symbol counts into int32[B, 288] and [B, 32].
//  * fixed / emit: token t's codes go to lane t & 31 (litlen code, length
//    extra, distance code, distance extra), closed-form fixed codes or
//    tab[sym] = bit-reversed code | length << 16 (distances at 288+).  A lane
//    appends LSB first (the TPU's (lo, hi, nbits) triple) and keeps at most
//    WCAP = 832 dwords (more set the overflow flag, and the tile falls back
//    to stored).  The token's four field bit counts, packed 4 x 4 bits, go
//    to nb16 as u16 t (two tokens an int32 word, low half first); t >= 65536
//    sets the flag.  dcnt = a lane's dwords (its last one partial), meta =
//    [tokens, overflow, tokens > 65536, 0].  Lane words and nb16 entries
//    past those written are 0.
//
// Bound: bytes.  A call must read each input byte once and write the lane
// words, the field counts and the lane counts (B x (32 x 832 + 32768 + 36)
// int32; hist B x 320).  The parse also reads cand and cand8 in full (8
// bytes a position), which the bound does not count.
//
// Every mode reads at most a row's first 64 KiB and runs phases 1-5 of
// csrc/lz_parse.cuh over the CTA's 227 KB of shared memory (staging, the
// next-token pass, next() elsewhere, the 32 merged chases, the tokens
// recomputed and numbered), then
//  * hist: the counting phase it shares with Deflate's hist
//    (lz_parse.cuh's count_symbols and hist_kernel: the matches' symbols and
//    a coverage bitmask of their bytes, then the uncovered bytes a warp word
//    at a time, warp-aggregated increments into 8 copies of the counts);
//    entropy only is the staged bytes' histogram, with no parse;
//  * fixed / emit, phase 6: emission in super-rounds of 64 rounds (2048
//    tokens): warp w codes rounds 64 g + 2 w and 64 g + 2 w + 1, token t in
//    lane t & 31; a block scan down each lane's column gives the bit offsets;
//    codes are or-ed into a 128-word ring a lane in shared memory, and each
//    lane's finished words go to lw by one warp in contiguous stores; nb16 is
//    stored 32 tokens a warp store, the zero tails 16 bytes a thread store.

#include <cstdint>

#include <cuda_runtime.h>

#include "lz_parse.cuh"

namespace {

using lzp::dist_sym;
using lzp::len_sym;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLanes = 32;
constexpr int kNTab = 288 + 32;
constexpr int kWCap = 832;
constexpr int kNtCap = 65536;

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int n) {
  return n ? __brev(v) >> (32 - n) : 0u;
}

// =============================================================== emission ==
// fixed / emit: one CTA a chunk, phases 1-5 of csrc/lz_parse.cuh, then the
// emission (hist is lz_parse.cuh's hist_kernel).

using lzp::kPThreads;
using lzp::kPWarps;
constexpr int kWarpRounds = 2;                       // rounds a warp codes a super-round
constexpr int kRing = 128;                           // ring words a lane

// Region A past the parse's match records: the lane rings, the column
// matrix and the lanes' bit counts for phase 6; the code table in the
// parse's tail.
constexpr int kOffRing = lzp::kEndDm;                        // u32 [32][kRing]
constexpr int kOffCol = kOffRing + 4 * kLanes * kRing;       // int [kPWarps * kWarpRounds][33]
constexpr int kOffBase = kOffCol + 4 * kPWarps * kWarpRounds * 33;  // int [32] bits a lane
constexpr int kOffFlushed = kOffBase + 4 * kLanes;           // int [32] words flushed
static_assert(kOffFlushed + 4 * kLanes <= lzp::kBytesA, "region A overflows");
static_assert(4 * kNTab <= lzp::kTailBytes, "the code table does not fit the tail");
// a super-round adds at most 32 * kWarpRounds tokens of <= 49 bits to a
// lane, and a token's bits touch at most 3 words
static_assert(kRing >= (32 * kWarpRounds * 49 + 31) / 32 + 4, "a lane's ring is too short");

enum Mode { kFixed = 0, kEmit = 1 };

// Token fields -> (value LSB first, bit count, packed field counts).
template <int M>
__device__ __forceinline__ void code_match(int ml, int dist, const int32_t* tab, uint64_t& val,
                                           int& nbits, int& packed) {
  int li, e, ev, dc, de, dv;
  len_sym(ml, li, e, ev);
  dist_sym(dist, dc, de, dv);
  uint32_t c1, c3;
  int n1, n3;
  if (M == kEmit) {
    c1 = tab[257 + li] & 0xFFFF, n1 = tab[257 + li] >> 16;
    c3 = tab[288 + dc] & 0xFFFF, n3 = tab[288 + dc] >> 16;
  } else {
    const int lsym = 257 + li;
    n1 = lsym < 280 ? 7 : 8;
    c1 = rev_bits(lsym < 280 ? lsym - 256 : 0xC0 + lsym - 280, n1);
    c3 = rev_bits(dc, 5), n3 = 5;
  }
  val = c1 | (static_cast<uint64_t>(ev) << n1) | (static_cast<uint64_t>(c3) << (n1 + e)) |
        (static_cast<uint64_t>(dv) << (n1 + e + n3));
  nbits = n1 + e + n3 + de;
  packed = n1 | (e << 4) | (n3 << 8) | (de << 12);
}

template <int M>
__device__ __forceinline__ void code_literal(int v, const int32_t* tab, uint64_t& val, int& nbits,
                                             int& packed) {
  if (M == kEmit) {
    val = static_cast<uint32_t>(tab[v] & 0xFFFF);
    nbits = tab[v] >> 16;
  } else {
    nbits = v < 144 ? 8 : 9;
    val = v < 144 ? rev_bits(0x30 + v, 8) : rev_bits(0x190 + v - 144, 9);
  }
  packed = nbits;
}

template <int M>
__global__ void __launch_bounds__(kPThreads, 1)
gdeflate_parse_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                      const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
                      const int32_t* __restrict__ nxt, int cap, const int32_t* __restrict__ tab,
                      int32_t* __restrict__ lw, int32_t* __restrict__ nb16,
                      int32_t* __restrict__ dcnt, int32_t* __restrict__ meta) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t* pm = reinterpret_cast<const uint32_t*>(smem + lzp::kOffPm);
  const uint16_t* dm = reinterpret_cast<const uint16_t*>(smem + lzp::kOffDm);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kOffRing);
  int* col = reinterpret_cast<int*>(smem + kOffCol);
  int* base = reinterpret_cast<int*>(smem + kOffBase);
  int* flushed = reinterpret_cast<int*>(smem + kOffFlushed);
  const uint8_t* bytes = smem + lzp::kOffB;
  const uint16_t* path = reinterpret_cast<const uint16_t*>(smem + lzp::kOffC);
  int32_t* s_tab = reinterpret_cast<int32_t*>(smem + lzp::kOffTail);
  int* misc = reinterpret_cast<int*>(smem + lzp::kOffMisc);

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  // a row past GDeflate's largest chunk is parsed over its first 64 KiB
  // (the caller gives such a chunk ERROR_CHUNK_SIZE_TOO_LARGE)
  const int size = min(max(sizes[chunk], 0), min(cap, lzp::kMaxPos));
  const bool matches = nxt != nullptr;

  // ---- 1-5: stage the bytes and the table, parse
  lzp::stage_bytes(smem + lzp::kOffB, in, size, cap, tid);
  if (M == kEmit)
    for (int i = tid; i < kNTab; i += kPThreads) s_tab[i] = tab[static_cast<size_t>(chunk) * kNTab + i];
  lzp::deflate_parse(smem, matches ? cand + row : nullptr, matches ? cand8 + row : nullptr,
                     matches ? nxt + row : nullptr, size, matches, tid, lane, wi);
  const int m = misc[lzp::kM];
  for (int i = tid; i < kLanes * kRing; i += kPThreads) ring[i] = 0;
  if (tid < kLanes) base[tid] = 0, flushed[tid] = 0;
  __syncthreads();

  // ---- 6: emission
  const uint16_t* tnum = path;
  const int ntok = misc[lzp::kTokens];
  const int rounds = (ntok + 31) >> 5;
  uint16_t* fc = reinterpret_cast<uint16_t*>(nb16) + static_cast<size_t>(chunk) * kNtCap;
  uint32_t* lwc = reinterpret_cast<uint32_t*>(lw) + static_cast<size_t>(chunk) * kLanes * kWCap;
  constexpr int kRows = kPWarps * kWarpRounds;  // rounds a super-round
  int jm = 0;  // this warp's first match at or after its round
  for (int g = 0; g * kRows < rounds; ++g) {
    uint64_t val[kWarpRounds];
#pragma unroll
    for (int k = 0; k < kWarpRounds; ++k) {
      const int rr = wi * kWarpRounds + k;  // the round's row in the super-round
      const int key = (g * kRows + rr) * 32;
      const int t = key + lane;
      const unsigned mm = lzp::round_matches(tnum, m, key, jm, lane);
      val[k] = 0;
      int nbits = 0;
      if (t < ntok) {
        const int below = __popc(mm & ((1u << lane) - 1u));
        int packed;
        if ((mm >> lane) & 1) {
          const int j = jm + below;
          code_match<M>(static_cast<int>(pm[j] >> 16) + 3, dm[j] + 1, s_tab, val[k], nbits,
                        packed);
        } else {
          // the match before this literal, and the literal's byte
          const int pos = lzp::literal_pos(pm, tnum, jm + below - 1, t);
          code_literal<M>(bytes[pos], s_tab, val[k], nbits, packed);
        }
        fc[t] = static_cast<uint16_t>(packed);
      }
      col[rr * 33 + lane] = nbits;
    }
    __syncthreads();
    for (int c = wi; c < kLanes; c += kPWarps) {  // lane c's column: exclusive prefix
      int v[kWarpRounds], sum = 0;
#pragma unroll
      for (int k = 0; k < kWarpRounds; ++k) {
        const int rr = lane * kWarpRounds + k;
        v[k] = rr < kRows ? col[rr * 33 + c] : 0;
        sum += v[k];
      }
      int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += u;
      }
      const int b = base[c];
      int at = b + inc - sum;
#pragma unroll
      for (int k = 0; k < kWarpRounds; ++k) {
        const int rr = lane * kWarpRounds + k;
        if (rr < kRows) col[rr * 33 + c] = at;
        at += v[k];
      }
      const int total = __shfl_sync(kFull, inc, 31);
      __syncwarp();
      if (lane == 0) base[c] = b + total;
    }
    __syncthreads();
    uint32_t* rl = ring + lane * kRing;
#pragma unroll
    for (int k = 0; k < kWarpRounds; ++k) {
      if (!val[k]) continue;
      const int o = col[(wi * kWarpRounds + k) * 33 + lane];
      const int k0 = o >> 5, sh = o & 31;
      const uint64_t lo = val[k] << sh;
      const uint32_t hi = sh ? static_cast<uint32_t>(val[k] >> (64 - sh)) : 0u;
      atomicOr(rl + (k0 & (kRing - 1)), static_cast<uint32_t>(lo));
      if (lo >> 32) atomicOr(rl + ((k0 + 1) & (kRing - 1)), static_cast<uint32_t>(lo >> 32));
      if (hi) atomicOr(rl + ((k0 + 2) & (kRing - 1)), hi);
    }
    __syncthreads();
    for (int c = wi; c < kLanes; c += kPWarps) {  // lane c's finished words to lw
      const int f0 = flushed[c], f1 = base[c] >> 5;
      uint32_t* rc = ring + c * kRing;
      for (int k = f0 + lane; k < f1; k += 32) {
        const uint32_t v = rc[k & (kRing - 1)];
        rc[k & (kRing - 1)] = 0;
        if (k < kWCap) lwc[c * kWCap + k] = v;
      }
      __syncwarp();
      if (lane == 0) flushed[c] = f1;
    }
  }
  __syncthreads();

  // the partial words, the lane counts, the zero tails, meta
  if (tid == 0) misc[lzp::kOver] = 0;
  __syncthreads();
  for (int c = wi; c < kLanes; c += kPWarps) {
    const int bits = base[c];
    const int d = (bits + 31) >> 5;
    if (lane == 0) {
      if ((bits & 31) && d - 1 < kWCap) lwc[c * kWCap + d - 1] = ring[c * kRing + ((d - 1) & (kRing - 1))];
      dcnt[static_cast<size_t>(chunk) * kLanes + c] = d;
      if (d > kWCap) misc[lzp::kOver] = 1;
    }
    // zeros from word min(d, WCAP) on: words to a 16-byte boundary, then
    // 16 bytes a store (a lane's row is 3328 bytes, a multiple of 16)
    uint32_t* lr = lwc + c * kWCap;
    const int z = min(d, kWCap), z4 = min((z + 3) & ~3, kWCap);
    if (lane < z4 - z) lr[z + lane] = 0;
    for (int k = z4 + 4 * lane; k < kWCap; k += 128)
      *reinterpret_cast<uint4*>(lr + k) = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0 && (ntok & 1) && ntok < kNtCap) fc[ntok] = 0;
  int32_t* nbw = nb16 + static_cast<size_t>(chunk) * (kNtCap / 2);
  const int zw = (ntok + 1) / 2, zw4 = min((zw + 3) & ~3, kNtCap / 2);
  if (tid < zw4 - zw) nbw[zw + tid] = 0;
  for (int i = zw4 + 4 * tid; i < kNtCap / 2; i += 4 * kPThreads)
    *reinterpret_cast<int4*>(nbw + i) = make_int4(0, 0, 0, 0);
  __syncthreads();
  if (tid == 0) {
    int32_t* mt = meta + static_cast<size_t>(chunk) * 4;
    mt[0] = ntok;
    mt[1] = misc[lzp::kOver];
    mt[2] = ntok > kNtCap ? 1 : 0;
    mt[3] = 0;
  }
}

template <int M>
int launch_parse(const uint8_t* data, const int32_t* sizes, const int32_t* cand,
                 const int32_t* cand8, const int32_t* nxt, int batch, int cap,
                 const int32_t* tab, int32_t* lw, int32_t* nb16, int32_t* dcnt, int32_t* meta,
                 void* stream) {
  if (batch <= 0) return 0;
  static unsigned long long raised = 0;  // one bit a device
  const cudaError_t e = lzp::raise_smem_limit(gdeflate_parse_kernel<M>, lzp::kSmemBytes, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  gdeflate_parse_kernel<M><<<batch, kPThreads, lzp::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, cap, tab, lw, nb16, dcnt, meta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).  cand, cand8 and nxt are all null for entropy-only coding.
// Every mode reads at most the first 64 KiB of a row.
extern "C" int tpucomp_gdeflate_encode_fixed(const uint8_t* data, const int32_t* sizes,
                                             const int32_t* cand, const int32_t* cand8,
                                             const int32_t* nxt, int batch, int cap,
                                             int32_t* lw, int32_t* nb16, int32_t* dcnt,
                                             int32_t* meta, void* stream) {
  return launch_parse<kFixed>(data, sizes, cand, cand8, nxt, batch, cap, nullptr, lw, nb16, dcnt,
                              meta, stream);
}

extern "C" int tpucomp_gdeflate_encode_hist(const uint8_t* data, const int32_t* sizes,
                                            const int32_t* cand, const int32_t* cand8,
                                            const int32_t* nxt, int batch, int cap,
                                            int32_t* llh, int32_t* dh, void* stream) {
  return lzp::launch_hist<32, 0>(data, sizes, cand, cand8, nxt, batch, cap, llh, dh, stream);
}

extern "C" int tpucomp_gdeflate_encode_emit(const uint8_t* data, const int32_t* sizes,
                                            const int32_t* cand, const int32_t* cand8,
                                            const int32_t* nxt, int batch, int cap,
                                            const int32_t* tab, int32_t* lw, int32_t* nb16,
                                            int32_t* dcnt, int32_t* meta, void* stream) {
  return launch_parse<kEmit>(data, sizes, cand, cand8, nxt, batch, cap, tab, lw, nb16, dcnt,
                             meta, stream);
}
