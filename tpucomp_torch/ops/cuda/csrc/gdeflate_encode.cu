// Batched GDeflate encode: the token parse of a chunk and its emission into
// 32 round-robin lane bit buffers.  Two kernels:
//
//  * the parse (modes fixed and emit): one CTA a chunk finds the chunk's
//    tokens with per-position work in parallel and a cheap serial chain in
//    shared memory, then emits them in parallel;
//  * the walk (mode hist): one warp a chunk walks the tokens serially and
//    counts their symbols.
//
// Replaces the TPU kernel tpucomp/ops/pallas/gdeflate_encode.py::_kernel in
// its three trace-time modes: "fixed" and "emit" (called at
// gdeflate_encode.py:471; algo 0, algos 1 and 2) by the parse, "hist"
// (called at :453, algos 1 and 2) by the walk.  Match finding is not in
// here: the caller first runs the sort-based candidate pass
// (tpucomp_torch/ops/match.py::candidates2 with the 64 KiB window), which
// gives for every position the nearest previous 4-byte match `cand`, an
// 8-byte-prefix sort neighbour `cand8`, and `nxt`, the next position that
// has either (all three null for entropy-only coding).  Both kernels see the
// tokens of csrc/deflate_encode.cu's walk:
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
// The parse, one CTA of 1024 threads a chunk (its first 64 KiB at most), in
// phases over its 227 KB of shared memory:
//  1. the chunk's bytes are staged by cp.async;
//  2. next-token pass: since anchor == scan throughout the walk, the token
//     that follows a scan position s depends on s alone.  A candidate
//     position p (cand or cand8 set) gives E(p) = p + 4 + L(p), L the longer
//     forward extension, and A(p) = p - bk(p), bk the back extension bounded
//     by the previous candidate position q (every s whose nxt is p lies in
//     (q, p]); from s the walk goes to next(s) = min(E, max(s, A) + 258).
//     Warps take 32 consecutive positions; each lane compares 8 bytes, and
//     a run of lanes with one distance whose first 8 bytes all match is
//     resolved by one 256-byte compare of the whole warp (mortgage's long
//     matches cost a step a run, not 32 a position);
//  3. next(s) for the positions without a candidate: the value at the first
//     determined position after s, found through a bitmask and a suffix
//     scan of its words (where the 258 cap cuts a back-extended match, its
//     candidate thread has written the positions [A, p) itself);
//  4. the chain from 0 through next(), a uint16 a position in shared
//     memory (kStop: no match from here; kTerm: the match ends at or past
//     mflimit): 32 lanes chase it from the starts of 32 segments at once,
//     chases from different starts meet within a few tokens, and one lane
//     joins them segment by segment; the match starts, marked in a bitmask,
//     become a list;
//  5. the tokens: each listed position recomputes its match in parallel
//     (global nxt/cand/cand8, shared bytes), and a block scan of the literal
//     runs numbers the tokens;
//  6. emission in super-rounds of 64 rounds (2048 tokens): warp w codes
//     rounds 64 g + 2 w and 64 g + 2 w + 1, token t in lane t & 31; a block
//     scan down each lane's column gives the bit offsets; codes are or-ed
//     into a 128-word ring a lane in shared memory, and each lane's finished
//     words go to lw by one warp in contiguous stores; nb16 is stored 32
//     tokens a warp store, the zero tails 16 bytes a thread store.
// The walk for hist: a warp a chunk, all lanes carrying the same state; a
// run of literals is counted by all lanes at once; histograms in shared
// memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 258;
constexpr int kMaxExt = kMaxMatch - kMinMatch;   // 254
constexpr int kLanes = 32;
constexpr int kNTab = 288 + 32;
constexpr int kWCap = 832;
constexpr int kNtCap = 65536;

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int n) {
  return n ? __brev(v) >> (32 - n) : 0u;
}

// Match length -> length symbol index 0..28, extra bit count and value.
__device__ __forceinline__ void len_sym(int ml, int& li, int& e, int& ev) {
  const int m = ml - 3;
  if (m < 8) {
    li = m, e = 0, ev = 0;
  } else if (ml == kMaxMatch) {
    li = 28, e = 0, ev = 0;
  } else {
    e = 29 - __clz(m);  // bit length - 3
    li = ((e + 1) << 2) | ((m >> e) - 4);
    ev = m & ((1 << e) - 1);
  }
}

// Distance (1..65536) -> GDeflate distance symbol 0..31, extra bits and value.
__device__ __forceinline__ void dist_sym(int dist, int& dc, int& e, int& ev) {
  const int d = dist - 1;
  if (d < 4) {
    dc = d, e = 0, ev = 0;
  } else {
    e = 30 - __clz(d);  // bit length - 2
    dc = ((e + 1) << 1) | ((d >> e) - 2);
    ev = d & ((1 << e) - 1);
  }
}

// =================================================================== walk ==
// hist: one warp a chunk, the serial walk.

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gdeflate_hist_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                     const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
                     const int32_t* __restrict__ nxt, int batch, int cap,
                     int32_t* __restrict__ llh, int32_t* __restrict__ dh) {
  __shared__ int32_t s_tab[kWarpsPerBlock][kNTab];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  const int size = min(max(sizes[chunk], 0), cap);
  int32_t* t_ = s_tab[wi];
  for (int i = lane; i < kNTab; i += 32) t_[i] = 0;
  __syncwarp();

  // literals [a, b): each lane counts every 32nd
  auto lits = [&](int a, int b) {
    for (int k = lane; k < b - a; k += 32) atomicAdd(&t_[in[a + k]], 1);
  };
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
      const int fcap = min(size - (nm + kMinMatch), kMaxExt);
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
      lits(anchor, nm2);
      int li, e, ev, dc, de, dv;
      len_sym(ml, li, e, ev);
      dist_sym(nm - src, dc, de, dv);
      if (lane == 0) {
        atomicAdd(&t_[257 + li], 1);
        atomicAdd(&t_[288 + dc], 1);
      }
      anchor = scan = nm2 + ml;
    }
  }
  lits(anchor, size);

  __syncwarp();
  for (int i = lane; i < kNTab; i += 32) {
    if (i < 288)
      llh[static_cast<size_t>(chunk) * 288 + i] = t_[i];
    else
      dh[static_cast<size_t>(chunk) * 32 + i - 288] = t_[i];
  }
}

// ================================================================== parse ==
// fixed / emit: one CTA a chunk.

constexpr int kPWarps = 32;                          // warps of a parse CTA
constexpr int kPThreads = kPWarps * 32;
constexpr int kMaxPos = 65536;                       // GDeflate's largest chunk
constexpr int kWords = kMaxPos / 32;                 // bitmask words a chunk
constexpr int kMaxMatches = kMaxPos / kMinMatch;     // a match covers >= 4 bytes
constexpr int kWarpRounds = 2;                       // rounds a warp codes a super-round
constexpr int kRing = 128;                           // ring words a lane
constexpr uint16_t kStop = 0xFFFF;                   // next(): no match from here
constexpr uint16_t kTerm = 0xFFFE;                   // next(): ends at or past mflimit
constexpr uint16_t kNone = 0xFFFF;                   // suffix scan: no word after

// Shared memory, in bytes.  Region A: next() (u16 a position) for phases
// 2-4, then the match records (Pm u32, Dm u16), the lane rings, the column
// matrix and the lanes' bit counts for phases 5-6.  Region B: the chunk's
// bytes (+16 for 8-byte reads at any position up to the size).  Region C:
// the candidate bitmask and the suffix scan of its words for phases 2-3,
// the chain's match starts as a bitmask for 4, as a list for 4-5, the
// token numbers for 5-6.
constexpr int kOffPm = 0;                            // u32 [kMaxMatches]
constexpr int kOffDm = kOffPm + 4 * kMaxMatches;     // u16 [kMaxMatches]
constexpr int kOffRing = kOffDm + 2 * kMaxMatches;   // u32 [32][kRing]
constexpr int kOffCol = kOffRing + 4 * kLanes * kRing;       // int [kPWarps * kWarpRounds][33]
constexpr int kOffBase = kOffCol + 4 * kPWarps * kWarpRounds * 33;  // int [32] bits a lane
constexpr int kOffFlushed = kOffBase + 4 * kLanes;           // int [32] words flushed
constexpr int kBytesA = 2 * kMaxPos;
constexpr int kOffB = kBytesA;
constexpr int kBytesB = kMaxPos + 16;
constexpr int kOffC = kOffB + kBytesB;
constexpr int kOffNextWord = 4 * kWords;             // within C, after the bitmask
constexpr int kOffMarks = kOffNextWord + 2 * kWords;  // within C: the chain's match starts
constexpr int kBytesC = 2 * kMaxMatches;
constexpr int kOffTab = kOffC + kBytesC;
constexpr int kOffScr = kOffTab + 4 * kNTab;         // int [32] block-scan scratch
constexpr int kOffMisc = kOffScr + 4 * 32;           // int [8]
constexpr int kSmemBytes = kOffMisc + 4 * 8;
static_assert(kOffFlushed + 4 * kLanes <= kBytesA, "region A overflows");
// a super-round adds at most 32 * kWarpRounds tokens of <= 49 bits to a
// lane, and a token's bits touch at most 3 words
static_assert(kRing >= (32 * kWarpRounds * 49 + 31) / 32 + 4, "a lane's ring is too short");
static_assert(kOffMarks + 4 * kWords <= kBytesC, "region C overflows");
static_assert(kSmemBytes <= 232448, "more shared memory than a Hopper CTA may have");
static_assert(kOffB % 16 == 0 && kOffC % 16 == 0, "cp.async needs 16-byte alignment");

enum Misc { kM = 0, kTokens = 1, kOver = 2 };

enum Mode { kFixed = 0, kEmit = 1 };

// Exclusive block scan of v in thread order under op (ident its identity).
// Every thread of the CTA calls it; scr holds 32 ints.
template <class Op>
__device__ __forceinline__ int block_scan_excl(int v, int ident, Op op, int* scr, int lane,
                                               int wi) {
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = op(u, inc);
  }
  if (lane == 31) scr[wi] = inc;
  __syncthreads();
  if (wi == 0) {
    int s = lane < kPWarps ? scr[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s = op(u, s);
    }
    if (lane < kPWarps) scr[lane] = s;
  }
  __syncthreads();
  int ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = ident;
  const int out = wi > 0 ? op(scr[wi - 1], ex) : ex;
  __syncthreads();  // scr may be reused after
  return out;
}

// The 8 bytes at byte offset x of the chunk (little-endian words w), as two
// words: 4 bytes at x, 4 at x + 4.  (Funnel shifts of 32-bit words take
// fewer instructions here than 64-bit loads and shifts.)
__device__ __forceinline__ void bytes8(const uint32_t* w, int x, uint32_t& lo, uint32_t& hi) {
  const int i = x >> 2, sh = (x & 3) * 8;
  const uint32_t a = w[i], b = w[i + 1], c = w[i + 2];
  lo = __funnelshift_r(a, b, sh);
  hi = __funnelshift_r(b, c, sh);
}

// Index (0..7) of the first byte where the 8 bytes a0:a1 and those at c
// differ; 8 if none does.
__device__ __forceinline__ int mismatch8(const uint32_t* w, uint32_t a0, uint32_t a1, int c) {
  uint32_t c0, c1;
  bytes8(w, c, c0, c1);
  const uint32_t d0 = a0 ^ c0, d1 = a1 ^ c1;
  if (d0) return (__ffs(d0) - 1) >> 3;
  if (d1) return 4 + ((__ffs(d1) - 1) >> 3);
  return 8;
}

// ... of the 8 bytes at a and at c.
__device__ __forceinline__ int mismatch8(const uint32_t* w, int a, int c) {
  uint32_t a0, a1;
  bytes8(w, a, a0, a1);
  return mismatch8(w, a0, a1, c);
}

// Common-prefix length of the bytes at a and at c (c < a), at most cap_n.
__device__ __forceinline__ int match_len(const uint32_t* w, int a, int c, int cap_n) {
  for (int l = 0; l < cap_n; l += 8) {
    const int k = mismatch8(w, a + l, c + l);
    if (k < 8) return min(l + k, cap_n);
  }
  return cap_n;
}

// Forward extensions of a warp's 32 consecutive positions p = base + lane,
// each against up to two sources sa (lanes with wa) and sb (lanes with wb;
// sb != sa): the common prefix of the bytes at p + 4 and at src + 4, at most
// fcap (<= 254), into la and lb.  Each lane compares 8 bytes a source; the
// (lane, source) items whose 8 bytes all match are resolved a run at a
// time: the highest lane with one leads, the warp compares the next 248
// bytes at its distance in one step, and every item at the same distance
// whose 8-byte window chains to the leader's (windows at most 8 apart)
// shares the leader's first mismatch.  A lane's two items have different
// distances, so a run takes at most one of them.
__device__ __forceinline__ void warp_extend(const uint32_t* w, int p, bool wa, int sa, bool wb,
                                            int sb, int fcap, int size, int lane, int& la,
                                            int& lb) {
  la = lb = 0;
  bool oa = false, ob = false;
  uint32_t a0 = 0, a1 = 0;  // the 8 bytes at p + 4 (wb implies wa)
  if (wa) {
    bytes8(w, p + kMinMatch, a0, a1);
    const int k = mismatch8(w, a0, a1, sa + kMinMatch);
    if (k < 8 || fcap <= 8)
      la = min(k, fcap);
    else
      oa = true;
  }
  if (wb) {
    const int k = mismatch8(w, a0, a1, sb + kMinMatch);
    if (k < 8 || fcap <= 8)
      lb = min(k, fcap);
    else
      ob = true;
  }
  const int da = p - sa, db = p - sb;
  unsigned u = __ballot_sync(kFull, oa || ob);
  while (u) {
    const int lead = 31 - __clz(u);
    const int dl = __shfl_sync(kFull, oa ? da : db, lead);
    const int pl = p - lane + lead;
    const int fl = min(size - (pl + kMinMatch), kMaxExt);
    const int x = pl + kMinMatch + 8 + 8 * lane;
    const int k = x < pl + kMinMatch + fl ? mismatch8(w, x, x - dl) : 8;
    const unsigned bad = __ballot_sync(kFull, k < 8);
    int mfirst = 0x7FFFFFFF;  // none before the leader's cap
    if (bad) {
      const int b = __ffs(bad) - 1;
      mfirst = pl + kMinMatch + 8 + 8 * b + __shfl_sync(kFull, k, b);
    }
    // items at the leader's distance, and where their chain to it breaks
    const bool ia = oa && da == dl, ib = ob && db == dl;
    const unsigned ms = __ballot_sync(kFull, ia || ib);
    const unsigned above = lane == 31 ? 0u : ms & (kFull << (lane + 1));
    const bool brk = (ia || ib) && above && (__ffs(above) - 1 - lane > 8);
    const unsigned breaks = __ballot_sync(kFull, brk);
    // a break in [lane, lead) cuts this lane off the leader
    if ((ia || ib) && !(breaks & ((1u << lead) - 1u) & (kFull << lane))) {
      const int len = mfirst == 0x7FFFFFFF ? fcap : min(mfirst - (p + kMinMatch), fcap);
      if (ia)
        la = len, oa = false;
      else
        lb = len, ob = false;
    }
    u = __ballot_sync(kFull, oa || ob);
  }
}

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

// First j in [lo, hi) with T[j] >= key (hi if none); T ascending.  Warp-wide.
__device__ __forceinline__ int warp_lower_bound(const uint16_t* T, int lo, int hi, int key,
                                                int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + step * (lane + 1) - 1;  // the last entry of bucket `lane`
    const bool lt = i < hi && T[i] < key;
    const int k = __popc(__ballot_sync(kFull, lt));  // buckets wholly below key
    lo += step * k;
    hi = min(hi, lo + step);
  }
  const bool lt = lane < hi - lo && T[lo + lane] < key;
  return lo + __popc(__ballot_sync(kFull, lt));
}

template <int M>
__global__ void __launch_bounds__(kPThreads, 1)
gdeflate_parse_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                      const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
                      const int32_t* __restrict__ nxt, int cap, const int32_t* __restrict__ tab,
                      int32_t* __restrict__ lw, int32_t* __restrict__ nb16,
                      int32_t* __restrict__ dcnt, int32_t* __restrict__ meta) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* nextv = reinterpret_cast<uint16_t*>(smem);
  uint32_t* pm = reinterpret_cast<uint32_t*>(smem + kOffPm);
  uint16_t* dm = reinterpret_cast<uint16_t*>(smem + kOffDm);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kOffRing);
  int* col = reinterpret_cast<int*>(smem + kOffCol);
  int* base = reinterpret_cast<int*>(smem + kOffBase);
  int* flushed = reinterpret_cast<int*>(smem + kOffFlushed);
  uint8_t* bytes = smem + kOffB;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bytes);
  uint32_t* det = reinterpret_cast<uint32_t*>(smem + kOffC);
  uint16_t* nextword = reinterpret_cast<uint16_t*>(smem + kOffC + kOffNextWord);
  uint32_t* marks = reinterpret_cast<uint32_t*>(smem + kOffC + kOffMarks);
  uint16_t* path = reinterpret_cast<uint16_t*>(smem + kOffC);   // then the token numbers
  int32_t* s_tab = reinterpret_cast<int32_t*>(smem + kOffTab);
  int* scr = reinterpret_cast<int*>(smem + kOffScr);
  int* misc = reinterpret_cast<int*>(smem + kOffMisc);

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  // a row past GDeflate's largest chunk is parsed over its first 64 KiB
  // (the caller gives such a chunk ERROR_CHUNK_SIZE_TOO_LARGE)
  const int size = min(max(sizes[chunk], 0), min(cap, kMaxPos));
  const int mflimit = size - kMinMatch + 1;
  const bool matches = nxt != nullptr && mflimit > 0;

  // ---- 1: stage the bytes, the table; clear the bitmask
  // (8-byte reads reach up to 11 bytes past the size: those bytes are 0)
  const int staged = (size + 15) & ~15;
  if ((reinterpret_cast<uintptr_t>(in) & 15) == 0 && (cap & 15) == 0) {
    for (int i = 16 * tid; i < size; i += 16 * kPThreads) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bytes + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(in + i));
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    if (tid < 16) bytes[staged + tid] = 0;
  } else {
    for (int i = tid; i < staged + 16; i += kPThreads) bytes[i] = i < size ? in[i] : 0;
  }
  if (M == kEmit)
    for (int i = tid; i < kNTab; i += kPThreads) s_tab[i] = tab[static_cast<size_t>(chunk) * kNTab + i];
  for (int i = tid; i < kWords; i += kPThreads) det[i] = 0, marks[i] = 0;
  __syncthreads();

  const int32_t* c4 = matches ? cand + row : nullptr;
  const int32_t* c8 = matches ? cand8 + row : nullptr;
  const int nblk = matches ? (mflimit + 31) >> 5 : 0;

  // ---- 2: next(p) at the candidate positions
  int c4n = -1, c8n = -1;  // the next block's candidates, loaded a block ahead
  if (wi < nblk && wi * 32 + lane < mflimit)
    c4n = __ldg(c4 + wi * 32 + lane), c8n = __ldg(c8 + wi * 32 + lane);
  for (int blk = wi; blk < nblk; blk += kPWarps) {
    const int p = blk * 32 + lane;
    const int c4p = c4n, c8p = c8n;
    const int q = p + 32 * kPWarps;
    c4n = c8n = -1;
    if (q < mflimit) c4n = __ldg(c4 + q), c8n = __ldg(c8 + q);
    const bool isc = c4p >= 0 || c8p >= 0;
    const unsigned cm = __ballot_sync(kFull, isc);
    if (lane == 0 && cm) atomicOr(&det[blk], cm);
    const int p4 = c4p >= 0 ? c4p : c8p;
    const int p8 = c8p >= 0 ? c8p : p4;
    const int fcap = isc ? min(size - (p + kMinMatch), kMaxExt) : 0;
    const bool two = isc && p8 != p4;
    int l4, l8;
    warp_extend(words, p, isc, p4, two, p8, fcap, size, lane, l4, l8);
    if (isc) {
      const int len = two ? max(l4, l8) : l4;
      const int src = two && l8 > l4 ? p8 : p4;
      // back extension, through positions without a candidate only
      int x = p - 1, y = src - 1;
      while (x >= 0 && y >= 0 && bytes[x] == bytes[y]) {
        const bool xc = x >= blk * 32 ? (cm >> (x - blk * 32)) & 1
                                      : (__ldg(c4 + x) >= 0 || __ldg(c8 + x) >= 0);
        if (xc) break;
        --x;
        --y;
      }
      const int a = x + 1;  // A(p)
      const int e = p + kMinMatch + len;
      nextv[p] = e >= mflimit ? kTerm : static_cast<uint16_t>(e);
      if (p - a + kMinMatch + len > kMaxMatch) {
        // the cap cuts the match from the gap's positions below p: [a, p)
        // take min(e, s + 258) and count as determined; those below a take
        // a's value through phase 3
        for (int s = a; s < p; ++s) {
          const int v = min(e, s + kMaxMatch);
          nextv[s] = v >= mflimit ? kTerm : static_cast<uint16_t>(v);
          atomicOr(&det[s >> 5], 1u << (s & 31));
        }
      }
    }
  }
  __syncthreads();

  // ---- 3: next(s) elsewhere: the value at the first determined position
  // after s.  nextword[k]: the first word >= k with a bit set.
  if (matches) {
    constexpr int kPer = kWords / kPThreads;
    const int r = kPThreads - 1 - tid;  // reversed, so the scan runs from the end
    int first = 0x7FFFFFFF;
    for (int k = r * kPer + kPer - 1; k >= r * kPer; --k)
      if (det[k]) first = k;
    int cur = block_scan_excl(first, 0x7FFFFFFF, [](int a, int b) { return min(a, b); }, scr,
                              lane, wi);
    for (int k = r * kPer + kPer - 1; k >= r * kPer; --k) {
      if (det[k]) cur = k;
      nextword[k] = cur == 0x7FFFFFFF ? kNone : static_cast<uint16_t>(cur);
    }
    __syncthreads();
    for (int blk = wi; blk < nblk; blk += kPWarps) {
      const int s = blk * 32 + lane;
      const uint32_t dw = det[blk];
      if (s < mflimit && !((dw >> lane) & 1)) {
        const uint32_t after = lane == 31 ? 0u : dw & (kFull << (lane + 1));
        int q = -1;
        if (after) {
          q = blk * 32 + __ffs(after) - 1;
        } else if (blk + 1 < kWords) {
          const int w2 = nextword[blk + 1];
          if (w2 != kNone) q = w2 * 32 + __ffs(det[w2]) - 1;
        }
        nextv[s] = q < 0 ? kStop : nextv[q];
      }
    }
  }
  __syncthreads();

  // ---- 4: the chain from 0.  Lane k of warp 0 chases next() from the
  // start of segment k (32 segments of whole bitmask words) until it leaves
  // the segment, marking the match starts it meets; chases from different
  // starts soon meet and then agree.  Lane 0 then merges the segments in
  // order: from the true chain's entry into a segment it walks to the first
  // marked position (where it meets the segment's chase) or out of the
  // segment; the warp clears the segment's marks below that point and lane
  // 0 marks the true chain's positions there again.
  if (wi == 0 && matches) {
    const int seg = (((mflimit + 31) >> 5) + 31) >> 5 << 5;  // positions a segment
    auto marked = [&](int x) { return (marks[x >> 5] >> (x & 31)) & 1; };
    auto mark = [&](int x) { atomicOr(&marks[x >> 5], 1u << (x & 31)); };
    // clear [x, y) of the marks (the whole warp)
    auto clear = [&](int x, int y) {
      for (int w = (x >> 5) + lane; w <= (y - 1) >> 5 && x < y; w += 32) {
        uint32_t keep = 0;
        if (w == x >> 5) keep |= (1u << (x & 31)) - 1u;
        if (w == (y - 1) >> 5 && (y & 31)) keep |= ~((1u << (y & 31)) - 1u);
        marks[w] &= keep;
      }
      __syncwarp();
    };
    int s = lane * seg, ex = -1;  // ex: where the chase leaves its segment, -1 if it ends
    const int hi = min(s + seg, mflimit);
    while (s < hi) {
      const int v = nextv[s];
      if (v == kStop) break;
      mark(s);
      if (v == kTerm) break;
      s = v;
    }
    if (s >= hi && lane * seg < mflimit) ex = s;
    __syncwarp();
    int e = __shfl_sync(kFull, ex, 0);  // the true chain's first position in segment k
    for (int k = 1; k < 32 && k * seg < mflimit; ++k) {
      const int lo = k * seg, hk = min(lo + seg, mflimit);
      const int exk = __shfl_sync(kFull, ex, k);
      if (e < 0) {  // the true chain has ended: no mark from here on is true
        clear(lo, mflimit);
        break;
      }
      int a = e, end = 0;  // end: 1 the chain stops at a, 2 it stops after a
      if (lane == 0) {
        while (a < hk && !marked(a)) {
          const int v = nextv[a];
          if (v == kStop) { end = 1; break; }
          if (v == kTerm) { end = 2; break; }
          a = v;
        }
      }
      a = __shfl_sync(kFull, a, 0);
      end = __shfl_sync(kFull, end, 0);
      clear(lo, end ? mflimit : min(a, hk));
      if (lane == 0) {
        for (int x = e; x < a; x = nextv[x]) mark(x);
        if (end == 2) mark(a);
      }
      __syncwarp();
      if (end) break;
      e = a < hk ? exk : a;  // met the chase of segment k: its exit is the chain's
    }
  }
  __syncthreads();
  // the marks as a list: each thread its kWords / kPThreads words
  {
    constexpr int kPer = kWords / kPThreads;
    uint32_t mw[kPer];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      mw[i] = matches ? marks[tid * kPer + i] : 0u;
      cnt += __popc(mw[i]);
    }
    int at = block_scan_excl(cnt, 0, [](int x, int y) { return x + y; }, scr, lane, wi);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      for (uint32_t b = mw[i]; b; b &= b - 1)
        path[at++] = static_cast<uint16_t>((tid * kPer + i) * 32 + __ffs(b) - 1);
    if (tid == kPThreads - 1) misc[kM] = at;
  }
  __syncthreads();
  const int m = misc[kM];

  // ---- 5: the tokens.  Each thread takes matches tid + k * kPThreads, four
  // at a time (their global loads in flight together; a warp's lanes take
  // neighbouring matches, so its loads fall close together).  Match j's
  // successor on the chain, s' = path[j + 1], is where it ends: with one
  // source that is all it needs; with two, where the 258 cap cannot have cut
  // it, the longer forward extension is s' - nm - 4, and one compare (is
  // cand's extension that long?) picks the source.  The last match, and any
  // with two sources that the cap may have cut, are extended in full.
  for (int jb = tid; jb < m; jb += 4 * kPThreads) {
    int sv[4], nm[4], c4v[4], c8v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = jb + u * kPThreads;
      sv[u] = j < m ? path[j] : 0;
      nm[u] = j < m ? __ldg(nxt + row + sv[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = jb + u * kPThreads;
      c4v[u] = j < m ? __ldg(c4 + nm[u]) : 0;
      c8v[u] = j < m ? __ldg(c8 + nm[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = jb + u * kPThreads;
      if (j >= m) break;
      const int s = sv[u], n = nm[u];
      const int p4 = c4v[u] >= 0 ? c4v[u] : c8v[u];
      const int p8 = c8v[u] >= 0 ? c8v[u] : p4;
      // the back extension from each source, bounded by s
      auto back = [&](int src) {
        int a = n, b = src;
        while (a > s && b > 0 && bytes[a - 1] == bytes[b - 1]) --a, --b;
        return a;
      };
      const int a4 = back(p4), a8 = p8 != p4 ? back(p8) : a4;
      const int nx2 = j + 1 < m ? path[j + 1] : -1;  // next(s), where known
      int src, nm2, ml;
      if (nx2 >= 0 && p8 == p4) {  // one source: the match ends at nx2
        src = p4, nm2 = a4, ml = nx2 - a4;
      } else if (nx2 >= 0 && nx2 - a4 < kMaxMatch && nx2 - a8 < kMaxMatch) {
        // not cut by the cap: the longer extension is nx2 - n - 4
        const int len = nx2 - n - kMinMatch;
        src = match_len(words, n + kMinMatch, p4 + kMinMatch, len) < len ? p8 : p4;
        nm2 = src == p4 ? a4 : a8;
        ml = nx2 - nm2;
      } else {
        const int fcap = min(size - (n + kMinMatch), kMaxExt);
        const int l4 = match_len(words, n + kMinMatch, p4 + kMinMatch, fcap);
        const int l8 = p8 != p4 ? match_len(words, n + kMinMatch, p8 + kMinMatch, fcap) : l4;
        src = l8 > l4 ? p8 : p4;
        nm2 = src == p4 ? a4 : a8;
        ml = min(n - nm2 + kMinMatch + max(l4, l8), kMaxMatch);
      }
      pm[j] = static_cast<uint32_t>(nm2) | (static_cast<uint32_t>(ml - 3) << 16);
      dm[j] = static_cast<uint16_t>(n - src - 1);
    }
  }
  __syncthreads();
  // the token numbers: thread tid takes matches [j0, j1)
  const int per = (m + kPThreads - 1) / kPThreads;
  const int j0 = min(m, tid * per), j1 = min(m, j0 + per);
  int lit_sum = 0;
  for (int j = j0; j < j1; ++j) lit_sum += static_cast<int>(pm[j] & 0xFFFF) - path[j];
  int run = block_scan_excl(lit_sum, 0, [](int a, int b) { return a + b; }, scr, lane, wi);
  for (int j = j0; j < j1; ++j) {
    run += static_cast<int>(pm[j] & 0xFFFF) - path[j];
    path[j] = static_cast<uint16_t>(run + j);  // token number of match j
    if (j == m - 1) {
      const int end = static_cast<int>(pm[j] & 0xFFFF) + static_cast<int>(pm[j] >> 16) + 3;
      misc[kTokens] = run + m + (size - end);
    }
  }
  if (tid == 0 && m == 0) misc[kTokens] = size;
  for (int i = tid; i < kLanes * kRing; i += kPThreads) ring[i] = 0;
  if (tid < kLanes) base[tid] = 0, flushed[tid] = 0;
  __syncthreads();

  // ---- 6: emission
  const uint16_t* tnum = path;
  const int ntok = misc[kTokens];
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
      jm = warp_lower_bound(tnum, jm, m, key, lane);
      const int tj = jm + lane < m ? tnum[jm + lane] : 0x7FFFFFFF;
      const unsigned mm = __reduce_or_sync(kFull, tj < key + 32 ? 1u << (tj - key) : 0u);
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
          const int kp = jm + below - 1;  // the match before this literal
          int pos = t;
          if (kp >= 0) {
            const uint32_t pk = pm[kp];
            pos = static_cast<int>(pk & 0xFFFF) + static_cast<int>(pk >> 16) + 3 +
                  (t - tnum[kp] - 1);
          }
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
  if (tid == 0) misc[kOver] = 0;
  __syncthreads();
  for (int c = wi; c < kLanes; c += kPWarps) {
    const int bits = base[c];
    const int d = (bits + 31) >> 5;
    if (lane == 0) {
      if ((bits & 31) && d - 1 < kWCap) lwc[c * kWCap + d - 1] = ring[c * kRing + ((d - 1) & (kRing - 1))];
      dcnt[static_cast<size_t>(chunk) * kLanes + c] = d;
      if (d > kWCap) misc[kOver] = 1;
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
    mt[1] = misc[kOver];
    mt[2] = ntok > kNtCap ? 1 : 0;
    mt[3] = 0;
  }
}

// Raise the parse kernel's shared-memory limit once a device.
template <int M>
cudaError_t parse_smem_limit() {
  static unsigned long long raised = 0;  // one bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ((raised >> dev) & 1))) return e;
  e = cudaFuncSetAttribute(gdeflate_parse_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e == cudaSuccess && dev < 64) raised |= 1ull << dev;
  return e;
}

template <int M>
int launch_parse(const uint8_t* data, const int32_t* sizes, const int32_t* cand,
                 const int32_t* cand8, const int32_t* nxt, int batch, int cap,
                 const int32_t* tab, int32_t* lw, int32_t* nb16, int32_t* dcnt, int32_t* meta,
                 void* stream) {
  if (batch <= 0) return 0;
  const cudaError_t e = parse_smem_limit<M>();
  if (e != cudaSuccess) return static_cast<int>(e);
  gdeflate_parse_kernel<M><<<batch, kPThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, cap, tab, lw, nb16, dcnt, meta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).  cand, cand8 and nxt are all null for entropy-only coding.
// fixed and emit read at most the first 64 KiB of a row.
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
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gdeflate_hist_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, batch, cap, llh, dh);
  return static_cast<int>(cudaGetLastError());
}


extern "C" int tpucomp_gdeflate_encode_emit(const uint8_t* data, const int32_t* sizes,
                                            const int32_t* cand, const int32_t* cand8,
                                            const int32_t* nxt, int batch, int cap,
                                            const int32_t* tab, int32_t* lw, int32_t* nb16,
                                            int32_t* dcnt, int32_t* meta, void* stream) {
  return launch_parse<kEmit>(data, sizes, cand, cand8, nxt, batch, cap, tab, lw, nb16, dcnt,
                             meta, stream);
}
