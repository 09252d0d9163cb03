// The parallel token parse of one LZ77 chunk by one CTA of 1024 threads,
// shared by the Deflate and GDeflate encoders (csrc/deflate_encode.cu,
// csrc/gdeflate_encode.cu), and the pieces of it that the Zstandard encoder's
// gated parse (csrc/zstd_encode.cu) reuses.
//
// Replaces the token walk inside the TPU kernels
// tpucomp/ops/pallas/deflate_encode.py::_kernel and gdeflate_encode.py::_kernel
// (one serial loop over the chunk's scan positions).  Both walk the tokens
//
//   nm = nxt[scan]; stop at nm >= mflimit = size - 3
//   extend cand and cand8 forward, at most min(size - (nm + 4), 254) bytes;
//   keep the longer (cand8 only if longer)
//   back-extend while nm2 > anchor, src2 > 0 and the bytes before match
//   ml = min(back + 4 + longer, 258): literals [anchor, nm2), the match,
//   anchor = scan = nm2 + ml
//
// over the candidates of tpucomp_torch/ops/match.py::candidates2 (the nearest
// previous 4-byte match `cand`, an 8-byte-prefix sort neighbour `cand8`, and
// `nxt`, the next position with either); the formats differ only in the
// window the candidates come from (32 KiB for Deflate, 64 KiB for GDeflate)
// and in their emission.  A chunk is at most 64 KiB (constants.py: both
// formats' largest chunk); a longer row is parsed over its first 64 KiB.
//
// The parse, in phases over the CTA's 227 KB of shared memory:
//  1. the chunk's bytes are staged by cp.async (stage_bytes);
//  2. next-token pass: since anchor == scan throughout the walk, the token
//     that follows a scan position s depends on s alone.  A candidate
//     position p gives E(p) = p + 4 + L(p), L the longer forward extension,
//     and A(p) = p - bk(p), bk the back extension bounded by the previous
//     candidate position q (every s whose nxt is p lies in (q, p]); from s the
//     walk goes to next(s) = min(E, max(s, A) + 258).  Warps take 32
//     consecutive positions; each lane compares 8 bytes, and a run of lanes
//     with one distance whose first 8 bytes all match is resolved by one
//     256-byte compare of the whole warp a step (warp_extend);
//  3. next(s) for the positions without a candidate: the value at the first
//     determined position after s, found through a bitmask and a suffix
//     scan of its words (where the 258 cap cuts a back-extended match, its
//     candidate thread has written the positions [A, p) itself);
//  4. the chain from 0 through next(), a uint16 a position in shared memory
//     (kStop: no match from here; kTerm: the match ends at or past mflimit):
//     32 lanes chase it from the starts of 32 segments at once, chases from
//     different starts meet within a few tokens, and one lane joins them
//     segment by segment (chase); the match starts, marked in a bitmask,
//     become a list (marks_to_list);
//  5. the tokens: each listed position recomputes its match in parallel
//     (global nxt/cand/cand8, shared bytes), and a block scan of the literal
//     runs numbers the tokens.
// The caller emits from the match records (pm: start | (ml - 3) << 16, dm:
// distance - 1) and the token numbers, or counts their symbols
// (count_symbols, the hist kernel of both formats; the Zstandard hist kernel
// counts its sequences with warp_cover, warp_count and count_uncovered).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace lzp {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 258;
constexpr int kMaxExt = kMaxMatch - kMinMatch;       // 254
constexpr int kPWarps = 32;                          // warps of a parse CTA
constexpr int kPThreads = kPWarps * 32;
constexpr int kMaxPos = 65536;                       // the largest chunk
constexpr int kWords = kMaxPos / 32;                 // bitmask words a chunk
constexpr int kMaxMatches = kMaxPos / kMinMatch;     // a match covers >= 4 bytes
constexpr uint16_t kStop = 0xFFFF;                   // next(): no match from here
constexpr uint16_t kTerm = 0xFFFE;                   // next(): ends at or past mflimit
constexpr uint16_t kNone = 0xFFFF;                   // suffix scan: no word after
constexpr int kSmemMax = 232448;                     // a Hopper CTA's shared memory

// Shared memory of the Deflate parse, in bytes.  Region A: next() (u16 a
// position) for phases 2-4, then the match records (Pm u32, Dm u16) from
// phase 5 on, and from kEndDm to kBytesA the caller's scratch (its
// emission, or the counts of count_symbols).
// Region B: the chunk's bytes (+16 for 8-byte reads at any position up to
// the size).  Region C: the candidate bitmask and the suffix scan of its
// words for phases 2-3, the chain's match starts as a bitmask for 4, as a
// list for 4-5, the token numbers from 5 on.  Past C, kTailBytes for the
// caller (its tables), then the block-scan scratch and the misc words.
constexpr int kOffPm = 0;                            // u32 [kMaxMatches]
constexpr int kOffDm = kOffPm + 4 * kMaxMatches;     // u16 [kMaxMatches]
constexpr int kEndDm = kOffDm + 2 * kMaxMatches;
constexpr int kBytesA = 2 * kMaxPos;
constexpr int kOffB = kBytesA;
constexpr int kBytesB = kMaxPos + 16;
constexpr int kOffC = kOffB + kBytesB;
constexpr int kOffNextWord = 4 * kWords;             // within C, after the bitmask
constexpr int kOffMarks = kOffNextWord + 2 * kWords;  // within C: the chain's match starts
constexpr int kBytesC = 2 * kMaxMatches;
constexpr int kOffTail = kOffC + kBytesC;
constexpr int kTailBytes = 4 * 320;                  // the caller's code table
constexpr int kOffScr = kOffTail + kTailBytes;       // int [32] block-scan scratch
constexpr int kOffMisc = kOffScr + 4 * 32;           // int [8]
constexpr int kSmemBytes = kOffMisc + 4 * 8;
static_assert(kOffMarks + 4 * kWords <= kBytesC, "region C overflows");
static_assert(kSmemBytes <= kSmemMax, "more shared memory than a Hopper CTA may have");
static_assert(kOffB % 16 == 0 && kOffC % 16 == 0, "cp.async needs 16-byte alignment");

enum Misc { kM = 0, kTokens = 1, kOver = 2, kAux = 3 };

// Match length (3..258) -> length symbol index 0..28 (litlen symbol 257 +
// index), extra bit count and value; the same in Deflate and GDeflate.
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

// Distance (1..65536) -> distance symbol, extra bit count and value: 0..29
// up to Deflate's 32 KiB, GDeflate's codes 30 and 31 (14 extra bits) past it.
__device__ __forceinline__ void dist_sym(int dist, int& di, int& e, int& ev) {
  const int d = dist - 1;
  if (d < 4) {
    di = d, e = 0, ev = 0;
  } else {
    e = 30 - __clz(d);  // bit length - 2
    di = ((e + 1) << 1) | ((d >> e) - 2);
    ev = d & ((1 << e) - 1);
  }
}

// Exclusive block scan of v in thread order under op (ident its identity).
// Every thread of the CTA calls it; scr holds 32 values of type T.
template <class T, class Op>
__device__ __forceinline__ T block_scan_excl(T v, T ident, Op op, T* scr, int lane, int wi) {
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = op(u, inc);
  }
  if (lane == 31) scr[wi] = inc;
  __syncthreads();
  if (wi == 0) {
    T s = lane < kPWarps ? scr[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s = op(u, s);
    }
    if (lane < kPWarps) scr[lane] = s;
  }
  __syncthreads();
  T ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = ident;
  const T out = wi > 0 ? op(scr[wi - 1], ex) : ex;
  __syncthreads();  // scr may be reused after
  return out;
}

// Phase 1: the chunk's first `size` bytes into `bytes` (16-byte aligned), by
// cp.async where the row is 16-byte aligned; the 16 bytes past the size
// rounded up to 16 are 0 (8-byte reads reach up to 11 bytes past the size).
// No barrier: the caller syncs.
__device__ __forceinline__ void stage_bytes(uint8_t* bytes, const uint8_t* in, int size,
                                            int cap, int tid) {
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
// fcap = min(size - (p + 4), kCap), into la and lb.  Each lane compares 8
// bytes a source; the (lane, source) items whose 8 bytes all match are
// resolved a run at a time: the highest lane with one leads, the warp
// compares the bytes after its window at its distance, 256 a step, until a
// mismatch or the leader's cap, and every item at the same distance whose
// 8-byte window chains to the leader's (windows at most 8 apart) shares the
// leader's first mismatch.  A lane's two items have different distances, so
// a run takes at most one of them.
// A resolved item a warp hands to the block below it (warp_extend's carry):
// its distance (-1 for none), position and first mismatch (0x7FFFFFFF: it
// runs to its cap).  A leader below at that distance whose window ends
// where the carried item's starts (at most 8 positions below it) has the
// carried item's first mismatch, with no compare.
struct Carry {
  int d[2], q[2], mfirst[2];
};

template <int kCap>
__device__ __forceinline__ void warp_extend(const uint32_t* w, int p, bool wa, int sa, bool wb,
                                            int sb, int fcap, int size, int lane, int& la,
                                            int& lb, Carry* carry = nullptr) {
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
    const int fl = min(size - (pl + kMinMatch), kCap);
    int mfirst = 0x7FFFFFFF;  // none before the leader's cap
    int from = 8;
    if (carry) {
      for (int i = 0; i < 2; ++i)
        if (carry->d[i] == dl && carry->q[i] > pl && carry->q[i] - pl <= 8)
          mfirst = carry->mfirst[i], from = 0x7FFFFFFF;
    }
    for (int o = from; o < fl || (kCap <= 256 && o == 8); o += 256) {
      const int x = pl + kMinMatch + o + 8 * lane;
      const int k = x < pl + kMinMatch + fl ? mismatch8(w, x, x - dl) : 8;
      const unsigned bad = __ballot_sync(kFull, k < 8);
      if (bad) {
        const int b = __ffs(bad) - 1;
        mfirst = pl + kMinMatch + o + 8 * b + __shfl_sync(kFull, k, b);
        break;
      }
      if (kCap <= 256) break;  // one step covers the cap
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
  if (carry) {  // lane 0's items, for the block below
    const int ma = wa && la < fcap ? p + kMinMatch + la : 0x7FFFFFFF;
    const int mb = wb && lb < fcap ? p + kMinMatch + lb : 0x7FFFFFFF;
    carry->d[0] = __shfl_sync(kFull, wa ? da : -1, 0);
    carry->d[1] = __shfl_sync(kFull, wb ? db : -1, 0);
    carry->q[0] = carry->q[1] = __shfl_sync(kFull, p, 0);
    carry->mfirst[0] = __shfl_sync(kFull, ma, 0);
    carry->mfirst[1] = __shfl_sync(kFull, mb, 0);
  }
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

// nextword[k] (k < kWords): the first word >= k of `mask` with a bit set,
// kNone if none.  Every thread calls it; it ends in a barrier.
__device__ __forceinline__ void next_set_words(const uint32_t* mask, uint16_t* nextword, int* scr,
                                               int tid, int lane, int wi) {
  constexpr int kPer = kWords / kPThreads;
  const int r = kPThreads - 1 - tid;  // reversed, so the scan runs from the end
  int first = 0x7FFFFFFF;
  for (int k = r * kPer + kPer - 1; k >= r * kPer; --k)
    if (mask[k]) first = k;
  int cur = block_scan_excl(first, 0x7FFFFFFF, [](int a, int b) { return min(a, b); }, scr, lane,
                            wi);
  for (int k = r * kPer + kPer - 1; k >= r * kPer; --k) {
    if (mask[k]) cur = k;
    nextword[k] = cur == 0x7FFFFFFF ? kNone : static_cast<uint16_t>(cur);
  }
  __syncthreads();
}

// The first position >= x with its bit set in `mask`, or -1; nextword as
// next_set_words gives it.
__device__ __forceinline__ int next_set(const uint32_t* mask, const uint16_t* nextword, int x) {
  if (x >= kMaxPos) return -1;
  const uint32_t wd = mask[x >> 5] & (kFull << (x & 31));
  if (wd) return (x & ~31) + __ffs(wd) - 1;
  if ((x >> 5) + 1 >= kWords) return -1;
  const int w2 = nextword[(x >> 5) + 1];
  return w2 == kNone ? -1 : w2 * 32 + __ffs(mask[w2]) - 1;
}

// Phase 4, warp 0: the chain through next() from x0 (every position below
// mflimit has a next position, kS or kT), its positions marked in `marks`
// from x0 on (marks below x0 are kept).  Lane k chases next() from the start
// of segment k of [x0, mflimit) until it leaves the segment, marking what it
// meets; chases from different starts soon meet and then agree.  Lane 0 then
// merges the segments in order: from the true chain's entry into a segment
// it walks to the first marked position (where it meets the segment's
// chase) or out of the segment; the warp clears the segment's marks below
// that point and lane 0 marks the true chain's positions there again.
// Returns (to every lane) where the chain ends: end_pos, and end_kind 0 (it
// stops at end_pos, unmarked: next() is kS there) or 1 (the token at
// end_pos, marked, ends at or past mflimit: next() is kT there).  `next`
// maps a position to its next one or to the sentinels kS and kT, which no
// position takes.
template <int kS, int kT, class Next>
__device__ __forceinline__ void chase_with(Next next, uint32_t* marks, int x0, int mflimit,
                                           int lane, int& end_pos, int& end_kind) {
  const int n = mflimit - x0;
  const int seg = (((n + 31) >> 5) + 31) >> 5 << 5;  // positions a segment
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
  int s = x0 + lane * seg, ex = -1, ek = 0;  // ex: where the chase leaves its segment, -1 if it ends
  const int hi = min(s + seg, mflimit);
  while (s < hi) {
    const int v = next(s);
    if (v == kS) break;
    mark(s);
    if (v == kT) {
      ek = 1;
      break;
    }
    s = v;
  }
  const int es = s;  // where this chase ends, if it does
  if (s >= hi && x0 + lane * seg < mflimit) ex = s;
  __syncwarp();
  int e = __shfl_sync(kFull, ex, 0);  // the true chain's first position in segment k
  int fin = __shfl_sync(kFull, es, 0), fink = __shfl_sync(kFull, ek, 0);
  for (int k = 1; k < 32 && x0 + k * seg < mflimit; ++k) {
    const int lo = x0 + k * seg, hk = min(lo + seg, mflimit);
    const int exk = __shfl_sync(kFull, ex, k);
    const int esk = __shfl_sync(kFull, es, k), ekk = __shfl_sync(kFull, ek, k);
    if (e < 0) {  // the true chain has ended: no mark from here on is true
      clear(lo, mflimit);
      break;
    }
    int a = e, end = 0;  // end: 1 the chain stops at a, 2 it stops after a
    if (lane == 0) {
      while (a < hk && !marked(a)) {
        const int v = next(a);
        if (v == kS) { end = 1; break; }
        if (v == kT) { end = 2; break; }
        a = v;
      }
    }
    a = __shfl_sync(kFull, a, 0);
    end = __shfl_sync(kFull, end, 0);
    clear(lo, end ? mflimit : min(a, hk));
    if (lane == 0) {
      for (int x = e; x < a; x = next(x)) mark(x);
      if (end == 2) mark(a);
    }
    __syncwarp();
    if (end) {
      fin = a, fink = end - 1;
      break;
    }
    if (a < hk) {  // met the chase of segment k: its exit is the chain's
      e = exk;
      fin = esk, fink = ekk;
    } else {
      e = a;
    }
  }
  end_pos = fin;
  end_kind = fink;
}

// The chase through a u16 next() table (positions below 65536; kStop, kTerm).
__device__ __forceinline__ void chase(const uint16_t* nextv, uint32_t* marks, int x0, int mflimit,
                                      int lane, int& end_pos, int& end_kind) {
  chase_with<kStop, kTerm>([nextv](int x) { return static_cast<int>(nextv[x]); }, marks, x0,
                           mflimit, lane, end_pos, end_kind);
}

// The marks at and past position x0 as an ascending list into path[at0...):
// each thread its kWords / kPThreads words.  Returns the list's new length
// (to every thread); ends in a barrier.
__device__ __forceinline__ int marks_to_list(const uint32_t* marks, uint16_t* path, int at0, int x0,
                                             bool any, int* scr, int* misc, int tid, int lane,
                                             int wi) {
  constexpr int kPer = kWords / kPThreads;
  uint32_t mw[kPer];
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int wd = tid * kPer + i;
    uint32_t v = any ? marks[wd] : 0u;
    if (wd < (x0 >> 5)) v = 0;
    else if (wd == (x0 >> 5)) v &= kFull << (x0 & 31);
    mw[i] = v;
    cnt += __popc(v);
  }
  int at = at0 + block_scan_excl(cnt, 0, [](int x, int y) { return x + y; }, scr, lane, wi);
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    for (uint32_t b = mw[i]; b; b &= b - 1)
      path[at++] = static_cast<uint16_t>((tid * kPer + i) * 32 + __ffs(b) - 1);
  if (tid == kPThreads - 1) misc[kM] = at;
  __syncthreads();
  return misc[kM];
}

// Phases 2-5 of the Deflate parse of one chunk whose bytes are staged at
// smem + kOffB (phase 1, synced by the caller).  On return (after a
// barrier) pm[j] = start | (ml - 3) << 16 and dm[j] = distance - 1 for the
// chunk's m = misc[kM] matches, path[j] the token number of match j, and
// misc[kTokens] the token count (literals and matches, the trailing
// literals included).  With no candidates (matches false) every byte is a
// literal token.
__device__ __forceinline__ void deflate_parse(uint8_t* smem, const int32_t* __restrict__ c4,
                              const int32_t* __restrict__ c8, const int32_t* __restrict__ nx,
                              int size, bool matches, int tid, int lane, int wi) {
  uint16_t* nextv = reinterpret_cast<uint16_t*>(smem);
  uint32_t* pm = reinterpret_cast<uint32_t*>(smem + kOffPm);
  uint16_t* dm = reinterpret_cast<uint16_t*>(smem + kOffDm);
  uint8_t* bytes = smem + kOffB;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bytes);
  uint32_t* det = reinterpret_cast<uint32_t*>(smem + kOffC);
  uint16_t* nextword = reinterpret_cast<uint16_t*>(smem + kOffC + kOffNextWord);
  uint32_t* marks = reinterpret_cast<uint32_t*>(smem + kOffC + kOffMarks);
  uint16_t* path = reinterpret_cast<uint16_t*>(smem + kOffC);   // then the token numbers
  int* scr = reinterpret_cast<int*>(smem + kOffScr);
  int* misc = reinterpret_cast<int*>(smem + kOffMisc);
  const int mflimit = size - kMinMatch + 1;
  matches = matches && mflimit > 0;
  for (int i = tid; i < kWords; i += kPThreads) det[i] = 0, marks[i] = 0;
  __syncthreads();
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
    warp_extend<kMaxExt>(words, p, isc, p4, two, p8, fcap, size, lane, l4, l8);
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
  // after s
  if (matches) {
    next_set_words(det, nextword, scr, tid, lane, wi);
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

  // ---- 4: the chain from 0, and its match starts as a list
  if (wi == 0 && matches) {
    int ep, ek;
    chase(nextv, marks, 0, mflimit, lane, ep, ek);
  }
  __syncthreads();
  const int m = marks_to_list(marks, path, 0, 0, matches, scr, misc, tid, lane, wi);

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
      nm[u] = j < m ? __ldg(nx + sv[u]) : 0;
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
  __syncthreads();
}

// Token t's place among the matches, for a warp taking the 32 tokens from
// key = 32 * round: jm (carried from round to round, ascending) becomes the
// first match numbered at or past key; the bitmask of the round's tokens
// that are matches comes back.
__device__ __forceinline__ unsigned round_matches(const uint16_t* tnum, int m, int key, int& jm,
                                                  int lane) {
  jm = warp_lower_bound(tnum, jm, m, key, lane);
  const int tj = jm + lane < m ? tnum[jm + lane] : 0x7FFFFFFF;
  return __reduce_or_sync(kFull, tj < key + 32 ? 1u << (tj - key) : 0u);
}

// Where token t's literal byte sits: after match kp (the last match before
// it, -1 for none), t - tnum[kp] - 1 bytes past its end.
__device__ __forceinline__ int literal_pos(const uint32_t* pm, const uint16_t* tnum, int kp,
                                           int t) {
  if (kp < 0) return t;
  const uint32_t pk = pm[kp];
  return static_cast<int>(pk & 0xFFFF) + static_cast<int>(pk >> 16) + 3 + (t - tnum[kp] - 1);
}

// The output row's bytes [lo, hi) set to 0: single bytes to a 16-byte
// boundary, then 16 bytes a store.  Every thread calls it.
__device__ __forceinline__ void zero_bytes(uint8_t* p, int lo, int hi, int tid) {
  if (hi <= lo) return;
  const int a = min(hi, static_cast<int>(lo + ((16 - (reinterpret_cast<uintptr_t>(p + lo) & 15)) & 15)));
  if (tid < a - lo) p[lo + tid] = 0;
  const int n16 = (hi - a) >> 4;
  for (int i = tid; i < n16; i += kPThreads)
    *reinterpret_cast<uint4*>(p + a + 16 * i) = make_uint4(0, 0, 0, 0);
  const int b = a + 16 * n16;
  if (tid < hi - b) p[b + tid] = 0;
}

// Raise a parse kernel's shared-memory limit once a device.
template <class K>
cudaError_t raise_smem_limit(K kernel, int bytes, unsigned long long& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ((raised >> dev) & 1))) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) raised |= 1ull << dev;
  return e;
}

// ================================================================= hist ==
// The symbol counts of a chunk, the hist kernel of both formats (rows 11 and
// 16): litlen symbols (literal bytes, 257 + length symbol, EOB at 256 when
// the format has one) into bins 0..287, distance symbols into 288 + code.
// The counts live in shared memory in kHistCopies copies, warp w adding to
// copy w % kHistCopies, and a warp's lanes with one bin add once together
// (warp_count: __match_any_sync and one atomicAdd a group): a 64 KiB run of
// one byte costs 2048 shared atomics over 8 addresses, not 65536 on one.

constexpr int kBins = 288 + 32;                      // litlen, then up to 32 distance codes
constexpr int kHistCopies = 8;
constexpr int kHistBytes = 4 * kHistCopies * kBins;
// With matches: region A past the match records (free after phase 5)
// holds the coverage bitmask of the matches' bytes, then the counts.
constexpr int kOffCover = kEndDm;                    // u32 [kWords]
constexpr int kOffHist = kOffCover + 4 * kWords;     // u32 [kHistCopies][kBins]
static_assert(kOffHist + kHistBytes <= kBytesA, "region A overflows");
// Entropy only (no parse): the bytes at 0, the counts after them.
constexpr int kOffHistLit = kBytesB;
constexpr int kSmemLitBytes = kOffHistLit + kHistBytes;
static_assert(kOffHistLit % 16 == 0, "cp.async needs 16-byte alignment");

// One count in bin `bin` of h for every lane (none where bin < 0); the whole
// warp calls it.
__device__ __forceinline__ void warp_count(uint32_t* h, int bin, int lane) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(h + bin, static_cast<unsigned>(__popc(peers)));
}

// Set the bits of positions [s, s + n) (n >= 1) in `cover` for every lane
// with `valid`: the two end words by atomicOr, the words between by plain
// stores (no other range touches them); a range with more than 8 words
// between its ends (only Zstandard's matches are that long) is stored by the
// whole warp.  The whole warp calls it.
__device__ __forceinline__ void warp_cover(uint32_t* cover, int s, int n, bool valid, int lane) {
  const int w0 = s >> 5, w1 = (s + n - 1) >> 5;
  if (valid) {
    const uint32_t m0 = kFull << (s & 31), m1 = kFull >> (31 - ((s + n - 1) & 31));
    if (w0 == w1) {
      atomicOr(cover + w0, m0 & m1);
    } else {
      atomicOr(cover + w0, m0);
      if (w1 - w0 <= 9)
        for (int w = w0 + 1; w < w1; ++w) cover[w] = kFull;
      atomicOr(cover + w1, m1);
    }
  }
  for (unsigned big = __ballot_sync(kFull, valid && w1 - w0 > 9); big; big &= big - 1) {
    const int l = __ffs(big) - 1;
    const int a = __shfl_sync(kFull, w0, l) + 1, b = __shfl_sync(kFull, w1, l);
    for (int w = a + lane; w < b; w += 32) cover[w] = kFull;
  }
}

// The bytes [0, size) whose bit in `cover` is clear (all of them where cover
// is null), counted into h: each warp takes one word of the bitmask (32
// positions) a step, four steps at once; a word all covered is skipped, so a
// warp's share follows the positions, not the literal runs.  `bytes` may be
// shared or global.  Every warp calls it; no barrier.
__device__ __forceinline__ void count_uncovered(const uint8_t* bytes, const uint32_t* cover,
                                                uint32_t* h, int size, int lane, int wi) {
  constexpr int kSteps = 4;
  const int nw = (size + 31) >> 5;
  for (int w0 = wi; w0 < nw; w0 += kSteps * kPWarps) {
    uint32_t cv[kSteps];
    int bin[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int w = w0 + u * kPWarps, p = 32 * w + lane;
      cv[u] = w >= nw ? kFull : cover ? cover[w] : 0u;
      bin[u] = p < size && !((cv[u] >> lane) & 1) ? bytes[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (cv[u] != kFull) warp_count(h, bin[u], lane);  // cv is the warp's: a uniform branch
  }
}

// The counting phase: a chunk's symbol counts into llh[0..288) and
// dh[0..n_dist) (global), from its staged `bytes` and, where cover is not
// null, deflate_parse's m match records (pm, dm).  Every thread calls it;
// the first barrier also orders the caller's staging.
//  a. the counts and the coverage bitmask are zeroed;
//  b. each match counts its length and distance symbols and sets its bytes'
//     bits in the bitmask (warp_cover);
//  c. the bytes whose bit is clear are counted (count_uncovered);
//  d. the copies are summed into the output.
template <int kNDist, int kEob>
__device__ __forceinline__ void count_symbols(const uint8_t* bytes, const uint32_t* pm,
                                              const uint16_t* dm, int m, uint32_t* cover,
                                              uint32_t* hist, int size, int32_t* llh,
                                              int32_t* dh, int tid, int lane, int wi) {
  for (int i = tid; i < kHistCopies * kBins; i += kPThreads) hist[i] = 0;
  if (cover)
    for (int i = tid; i < kWords; i += kPThreads) cover[i] = 0;
  __syncthreads();
  uint32_t* h = hist + (wi % kHistCopies) * kBins;
  if (kEob && tid == 0) atomicAdd(h + 256, static_cast<unsigned>(kEob));
  for (int jb = wi * 32; jb < m; jb += kPThreads) {  // b. the matches
    const int j = jb + lane;
    int lbin = -1, dbin = -1, s = 0, ml = 0;
    if (j < m) {
      s = static_cast<int>(pm[j] & 0xFFFF), ml = static_cast<int>(pm[j] >> 16) + 3;
      int sym, e, ev;
      len_sym(ml, sym, e, ev);
      lbin = 257 + sym;
      dist_sym(dm[j] + 1, sym, e, ev);
      dbin = 288 + sym;
    }
    warp_cover(cover, s, ml, j < m, lane);
    warp_count(h, lbin, lane);
    warp_count(h, dbin, lane);
  }
  __syncthreads();
  count_uncovered(bytes, cover, h, size, lane, wi);  // c. the literals
  __syncthreads();
  for (int i = tid; i < 288 + kNDist; i += kPThreads) {  // d. the sum
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < kHistCopies; ++c) v += hist[c * kBins + i];
    if (i < 288)
      llh[i] = static_cast<int32_t>(v);
    else
      dh[i - 288] = static_cast<int32_t>(v);
  }
}

// The hist kernel, one CTA a chunk (its first 64 KiB at most): with matches,
// phases 1-5 of the parse and the counting phase; entropy only (kMatches
// false), the staged bytes' histogram, two CTAs an SM.  llh int32[B, 288],
// dh int32[B, kNDist].
template <int kNDist, int kEob, bool kMatches>
__global__ void __launch_bounds__(kPThreads, kMatches ? 1 : 2)
hist_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
            const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
            const int32_t* __restrict__ nxt, int cap, int32_t* __restrict__ llh,
            int32_t* __restrict__ dh) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const size_t row = static_cast<size_t>(chunk) * cap;
  // a row past the formats' largest chunk is counted over its first 64 KiB
  // (the caller gives such a chunk ERROR_CHUNK_SIZE_TOO_LARGE)
  const int size = min(max(sizes[chunk], 0), min(cap, kMaxPos));
  int32_t* lh = llh + static_cast<size_t>(chunk) * 288;
  int32_t* d = dh + static_cast<size_t>(chunk) * kNDist;
  if constexpr (kMatches) {
    stage_bytes(smem + kOffB, data + row, size, cap, tid);
    deflate_parse(smem, cand + row, cand8 + row, nxt + row, size, true, tid, lane, wi);
    count_symbols<kNDist, kEob>(smem + kOffB, reinterpret_cast<const uint32_t*>(smem + kOffPm),
                                reinterpret_cast<const uint16_t*>(smem + kOffDm),
                                reinterpret_cast<const int*>(smem + kOffMisc)[kM],
                                reinterpret_cast<uint32_t*>(smem + kOffCover),
                                reinterpret_cast<uint32_t*>(smem + kOffHist), size, lh, d, tid,
                                lane, wi);
  } else {
    stage_bytes(smem, data + row, size, cap, tid);
    count_symbols<kNDist, kEob>(smem, nullptr, nullptr, 0, nullptr,
                                reinterpret_cast<uint32_t*>(smem + kOffHistLit), size, lh, d, tid,
                                lane, wi);
  }
}

// Launch the hist kernel on `stream` (the parse where nxt is not null, else
// entropy only); returns cudaGetLastError() after the launch (0 = ok).
template <int kNDist, int kEob>
int launch_hist(const uint8_t* data, const int32_t* sizes, const int32_t* cand,
                const int32_t* cand8, const int32_t* nxt, int batch, int cap, int32_t* llh,
                int32_t* dh, void* stream) {
  if (batch <= 0) return 0;
  static unsigned long long raised[2] = {0, 0};  // one bit a device, a kernel each
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (nxt != nullptr) {
    e = raise_smem_limit(hist_kernel<kNDist, kEob, true>, kSmemBytes, raised[0]);
    if (e != cudaSuccess) return static_cast<int>(e);
    hist_kernel<kNDist, kEob, true><<<batch, kPThreads, kSmemBytes, st>>>(
        data, sizes, cand, cand8, nxt, cap, llh, dh);
  } else {
    e = raise_smem_limit(hist_kernel<kNDist, kEob, false>, kSmemLitBytes, raised[1]);
    if (e != cudaSuccess) return static_cast<int>(e);
    hist_kernel<kNDist, kEob, false><<<batch, kPThreads, kSmemLitBytes, st>>>(
        data, sizes, nullptr, nullptr, nullptr, cap, llh, dh);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lzp
