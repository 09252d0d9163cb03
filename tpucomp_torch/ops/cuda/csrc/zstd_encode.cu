// Batched Zstandard encode in two kernels over one gated parse: the hist
// kernel (the sequences' counts) and the full kernel (the frame), one
// resident CTA of 1024 threads an SM in both.
//
// Replaces the TPU kernel tpucomp/ops/pallas/zstd_encode.py::_kernel in its
// two trace-time modes: "hist" (called by compress_batch at
// zstd_encode.py:864, exact entropy only) and "full" (compress_batch at
// :932).  Match finding is not in here: the caller first runs the sort-based
// candidate pass (tpucomp_torch/ops/match.py::candidates2 with the 64 KiB
// window), which gives for every position the nearest previous 4-byte match
// `cand` and an 8-byte-prefix sort neighbour `cand8` (its `nxt`, the next
// position with either, is the TPU kernel's; the parse does not read it).
// Both modes compute the sequences of the TPU kernel's walk:
//
//   nm = nxt[scan]; stop at nm >= mflimit = size - 3 or a full sequence buffer
//   extend cand and cand8 forward, at most size - (nm + 4) bytes; keep the
//   longer (cand8 only if longer); c = nm - src is the offset
//   back-extend while nm2 > anchor, src2 > 0 and the bytes before match
//   ml = back + 4 + longer, ll = nm2 - anchor
//   cost gate: keep it if c is one of the three repeat offsets or
//     ml * 5 >= floor(log2 c) + 18; else scan = nm + 1 (anchor stays)
//   kept: literals [anchor, nm2), offset value 1-3 (repeat) or c + 3, the
//     repeat stack updated as RFC 8878 3.1.1.5 says (ll == 0 shifts the
//     repeat codes by one), anchor = scan = nm2 + ml
//
// then the literals [anchor, size).  The sequence buffer (cap / 4 + 8 slots)
// never fills at cap <= 65536: a sequence covers at least 4 bytes, so a
// chunk has at most size / 4 of them; the parse has no such stop.
//  * hist: the literal bytes' histogram into int32[B, 256] and the kept
//    sequences' LL/ML/OF code counts into int32[B, 121] (LL at 0, ML at 36,
//    OF at 89, the OF code capped at 31); no output row.  They feed the
//    caller's table builders, so they are exact.
//  * full: one complete frame: header (magic, FHD 0x80, window byte, 4-byte
//    content size, block header); the literal section, 4-stream Huffman
//    (Size_Format 3, the tree description given, a 6-byte jump table, each
//    stream written backward with a 1-bit sentinel) when huf_ok, n_lit >= 64
//    and 5 + csize < 3 + n_lit, else raw (a 3-byte header with a 20-bit
//    size); the sequence count (2-byte form), the symbol compression modes
//    byte, the custom tables' descriptions and the backward FSE bitstream:
//    the last sequence sets the three states; every earlier one appends the
//    OF, ML and LL transitions (fse_tab packs state | nb << 10 | base << 14,
//    LL and ML 512 columns, OF 256), then every sequence its LL, ML and OF
//    extra bits; then the ML, OF and LL states and the padding bit.  A frame
//    not shorter than 13 + size bytes is rewritten as one raw block.
// The streams are LSB first, the same bytes as the TPU kernel's (lo, hi,
// nbits) triple.  A frame longer than out_cap ends as
// OUTPUT_BUFFER_TOO_SMALL with size 0: the TPU kernel writes into a row of
// max(out_cap, 16 + cap + 64 + 11 cap / 8 + 9 cap_seq + 192) bytes (its
// Huffman streams in a scratch region past the literals, then moved down)
// and drops the excess; here the frame's length is known before a byte of
// it is written, so the streams go straight to their place, or not at all.
// The TPU kernel's 4096-byte slabs over a second grid dimension only
// pipeline the candidate arrays through SMEM: a match that runs past a slab
// resumes in the next, and a walk that stops ends every later slab, so here
// a chunk is parsed whole.  Shapes: cap <= 65536 (a wider row takes the
// multi-block encoder, tpucomp_torch/formats/zstd.py), any batch.
//
// Bound: bytes.  A call must read each input byte once and write each output
// byte once (B x out_cap, the zero tail included; hist writes B x 377
// counts); both modes read cand and cand8 in full, full reads fse_tab (216
// KB a chunk) only in the columns its sequences use.  The exact-entropy
// rung parses every chunk twice, once a mode.
#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "lz_parse.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kOutputTooSmall = 15;
constexpr int kMinMatch = 4;
// the constant table of ops/cuda/zstd_encode.py (CONST): code lookups first
constexpr int kOLLC = 0, kOMLC = 64, kOLLX = 192, kOMLX = 228;
// each chunk's FSE block (ops/cuda/zstd_encode.py: O2_*, FSE_TT)
constexpr int kO2LL = 0;
constexpr int kO2ML = kO2LL + 36 * 512;
constexpr int kO2OF = kO2ML + 53 * 512;
constexpr int kO2LLF = kO2OF + 32 * 256;
constexpr int kO2MLF = kO2LLF + 36;
constexpr int kO2OFF = kO2MLF + 53;
constexpr int kO2Meta = kO2OFF + 32;
constexpr int kFseTT = (kO2Meta + 8 + 127) / 128 * 128;
constexpr int kNcCap = 512;
constexpr int kTreeCap = 176;
constexpr int kHufMeta = 258;
constexpr int kHist = 256 + 121;

// floor(log2 v) for v >= 1
__device__ __forceinline__ int hibit(int v) { return 31 - __clz(v); }

__device__ __forceinline__ int ll_code(const int32_t* cst, int ll) {
  return ll < 64 ? cst[kOLLC + ll] : 19 + hibit(ll);
}

__device__ __forceinline__ int ml_code(const int32_t* cst, int mlv) {
  return mlv < 128 ? cst[kOMLC + mlv] : 36 + hibit(max(mlv, 1));
}

// ================================================================= parse ==
// The gated parse: one CTA of 1024 threads a chunk, in phases over 227 KB of
// shared memory (csrc/lz_parse.cuh gives the staging, the forward
// extensions, the merged chases and the scans).  Phases 1-5 are the parse
// (zstd_parse, shared by both kernels); hist then counts (hist_chunk), full
// places the literals and goes on with 6-9 (full_chunk):
//  1. the chunk's bytes are staged by cp.async;
//  2. every candidate position p at once: the walk's source, offset c(p)
//     and forward length Lf(p) (no cap: runs of one distance are resolved
//     a run at a time, and a warp takes its stretch of blocks top down,
//     handing each block's lowest items to the block below), its back
//     extension up to 3 bytes, and its gate level: the least back extension
//     b with (Lf + b) * 5 >= floor(log2 c) + 18.  Since Lf >= 4 and c <
//     2^16, 3 bytes always pass, so the gate from an anchor s needs only
//     min(level, p - s).  Bitmasks of the positions that pass (G) and of
//     the candidates that are no sure keep (level above 0: R); Lf | c << 16
//     and the level go to a global scratch;
//  3. next(s) = E(K(s)), K(s) the first candidate the gate keeps from anchor
//     s and E its match's end, for every s (a sure keep writes its own in 2);
//  4. rounds: the chain from x0 through next() (32 merged chases), the
//     sequences' match positions, the repeat stack before each (a block scan
//     of three-offset summaries: with no literals a sequence never repeats
//     the offset before it, so RFC 8878 3.1.1.5's update is a move to front),
//     and the R candidates in the stretches the sequences scan: the first
//     whose offset is on its stack is kept instead (the walk's repeat rule),
//     and the next round starts past its match;
//  5. each sequence's exact back extension (bounded by its anchor and
//     src2 > 0), ll, ml, offset value and codes;
// hist: the code counts from each sequence's codes, and the literal bytes:
//     a coverage bitmask of the sequences' matches, then the bytes no match
//     covers a bitmask word a warp step (lz_parse.cuh's warp_cover and
//     count_uncovered), warp-aggregated increments into 8 copies of the
//     counts in region N (a chunk without a kept match adds 2048 times a
//     copy, not 65536 times one address);
// full, 5b: each sequence's literals to the scratch at a block scan of ll;
//  6. the literal streams' bit counts (a reduction of code lengths), the
//     Huffman-or-raw decision;
//  7. the FSE states, step by step from the last sequence: the used columns
//     of the encode tables in shared memory, three lanes stepping the LL, ML
//     and OF states (a shared-memory load a step; the states of custom
//     tables never meet from guessed starts, so segments would not pay);
//  8. the sequence stream's length, the raw-block and too-big decisions;
//  9. the frame: each literal's code at its stream's suffix sum and each
//     sequence's fields at a prefix sum, or-ed into shared words and copied
//     to the row; the zero tail in 16-byte stores.
// The CTAs stay resident, one an SM, each taking every gridDim-th chunk
// through its own row of the global scratch.

using lzp::kFull;
using lzp::kPThreads;
using lzp::kPWarps;
using lzp::kStop;
using lzp::kTerm;
constexpr int kMaxPos = lzp::kMaxPos;
constexpr int kWords = lzp::kWords;
constexpr int kMaxSeq = lzp::kMaxMatches;          // a sequence covers >= 4 bytes
constexpr int kNoCap = kMaxPos;                    // zstd's forward extension is not capped
constexpr uint8_t kNotCand = 7;                    // plvl of a position without a candidate
constexpr int kNoGate = 4;                         // plvl of a candidate that fails the gate

// Global scratch a CTA, in int32 words (the wrapper allocates a row for
// each CTA it launches; a CTA's chunks reuse it one after another): the
// per-position table, the per-sequence records, the literals.
constexpr int kScrInfo = 0;                        // u32 [65536]: Lf | c << 16
constexpr int kScrLvl = kScrInfo + kMaxPos;        // u8 [65536]: the gate level
constexpr int kScrSeqA = kScrLvl + kMaxPos / 4;    // [kMaxSeq] ll | (ml - 3) << 16
constexpr int kScrSeqB = kScrSeqA + kMaxSeq;       // [kMaxSeq] offset value
constexpr int kScrStack = kScrSeqB + kMaxSeq;      // u64 [kMaxSeq] the repeat stack before
constexpr int kScrState = kScrStack + 2 * kMaxSeq; // [kMaxSeq] FSE states after a step
constexpr int kScrCode = kScrState + kMaxSeq;      // [kMaxSeq] llc | mlc << 6 | ofc << 12
constexpr int kScrLit = kScrCode + kMaxSeq;        // u8 [65536] the literals in order
constexpr int kScrLane = kScrLit + kMaxPos / 4;    // u16 [3][kMaxSeq] each table's states
constexpr int kScrWords = kScrLane + 3 * kMaxSeq / 2;

// Shared memory, in bytes.  Region A: the bytes for phases 1-2, then each
// sequence's anchor and match position (u16 lists) for the rounds and 5,
// each FSE step's codes for 7, the staging of the literal streams and of
// the sequence stream for 9.  Region N: next() (u16 a position) for phases
// 2-4; then in hist the coverage bitmask and the counts; in full the
// literals' places for 5b, then (with the dead masks) the FSE encode
// tables' used columns (u16: next state << 1 | bits << 11) for 7-9.
constexpr int kZA = 0;
constexpr int kZPath = kZA;                        // u16 [kMaxSeq] sequence j's anchor
constexpr int kZK = kZPath + 2 * kMaxSeq;          // u16 [kMaxSeq] its match position
constexpr int kZN = kMaxPos + 16;                  // region N
constexpr int kZG = kZN + 2 * kMaxPos;             // u32 [kWords] the gate bitmask
constexpr int kZNW = kZG + 4 * kWords;             // u16 [kWords] its next set word
constexpr int kZMarks = kZNW + 2 * kWords;         // u32 [kWords] the chain's positions
constexpr int kZR = kZMarks + 4 * kWords;          // u32 [kWords] candidates that are no sure keep
constexpr int kZHuf = kZR + 4 * kWords;            // int [256] the Huffman codes
constexpr int kZScr = kZHuf + 4 * 256;             // int [32] block-scan scratch
constexpr int kZScr64 = kZScr + 4 * 32;            // u64 [32] stack-scan scratch
constexpr int kZMisc = kZScr64 + 8 * 32;           // int [24]
constexpr int kZBytes = kZMisc + 4 * 24;
constexpr int kStage = kMaxPos + 16;               // staging bytes (a stream is < 64 KiB + 13)
constexpr int kZFse = kZN;                         // u16 [kO2LLF] the FSE columns in use
constexpr int kZCodes = kZA;                       // u32 [kMaxSeq] each FSE step's codes
constexpr int kSegs = 10;                          // FSE chase segments, three lanes each
constexpr int kZCover = kZN;                       // u32 [kWords] hist: the matches' bytes
constexpr int kZHist = kZCover + 4 * kWords;       // u32 [kHistCopies][kHist] hist: the counts
static_assert(kZHist + 4 * lzp::kHistCopies * kHist <= kZG, "the hist counts overflow region N");
static_assert(kZK + 2 * kMaxSeq <= kZN && kStage <= kZN, "region A overflows");
static_assert(kZFse + 2 * kO2LLF <= kZR && 4 * kMaxSeq <= kZN, "the FSE columns or codes overflow");
static_assert(kZBytes <= lzp::kSmemMax, "more shared memory than a Hopper CTA may have");

enum ZMisc { kZm = 0, kZEndPos = 1, kZEndKind = 2, kZViol = 3, kZLast0 = 4, kZLast1 = 5,
             kZSum = 7, kZSb = 8 /* 4 */, kZNlit = 12, kZUsed = 13 /* 5 */ };

// The repeat stack as a summary of a stretch of offsets: its last three
// distinct values, newest first, 16 bits each (0: none).  push: one more
// offset; join: an older summary under a newer one.  Since a sequence with
// no literals never repeats the offset before it (that match ended where
// the bytes at this offset differ), RFC 8878 3.1.1.5's update is exactly
// push.
__device__ __forceinline__ uint64_t st_get(uint64_t s, int i) { return (s >> (16 * i)) & 0xFFFF; }

__device__ __forceinline__ uint64_t st_push(uint64_t s, int c) {
  const uint64_t cc = static_cast<uint64_t>(c);
  if (st_get(s, 0) == cc) return s;
  if (st_get(s, 1) == cc) return cc | (st_get(s, 0) << 16) | (st_get(s, 2) << 32);
  return cc | (st_get(s, 0) << 16) | (st_get(s, 1) << 32);
}

__device__ __forceinline__ uint64_t st_join(uint64_t older, uint64_t newer) {
  uint64_t out = newer;
  int n = st_get(newer, 0) ? (st_get(newer, 1) ? (st_get(newer, 2) ? 3 : 2) : 1) : 0;
  for (int i = 0; i < 3 && n < 3; ++i) {
    const uint64_t v = st_get(older, i);
    if (v && v != st_get(newer, 0) && v != st_get(newer, 1) && v != st_get(newer, 2))
      out |= v << (16 * n++);
  }
  return out;
}

// A sequence's fields: ll, ml - 3, the offset value and their codes.
struct Seq {
  int ll, mlv, ofv, llc, mlc, ofc;
};

__device__ __forceinline__ int fse_at(const int32_t* fse, int i) {
  return __ldg(fse + min(max(i, 0), kFseTT - 1));
}

// FSE step b's fields (value, width) in stream order: the OF, ML and LL
// transitions from the states before it (width 0 at the first step: they
// set the states), then the LL, ML and OF extra bits.  A transition emits
// the low `bits` bits of the state (fse_tab's state - base).
__device__ __forceinline__ void fse_fields(const uint16_t* t16, const int32_t* cst, const Seq& q,
                                           bool first, uint32_t prev, uint32_t v[6], int n[6]) {
  if (first) {
    v[0] = v[1] = v[2] = 0;
    n[0] = n[1] = n[2] = 0;
  } else {
    const int ofr = min(q.ofc, 31);
    const int s_ll = prev & 0x3FF, s_ml = (prev >> 10) & 0x3FF, s_of = (prev >> 20) & 0x3FF;
    n[0] = (t16[kO2OF + ofr * 256 + s_of] >> 11) & 0xF;
    n[1] = (t16[kO2ML + q.mlc * 512 + s_ml] >> 11) & 0xF;
    n[2] = (t16[kO2LL + q.llc * 512 + s_ll] >> 11) & 0xF;
    v[0] = s_of & ((1u << n[0]) - 1u);
    v[1] = s_ml & ((1u << n[1]) - 1u);
    v[2] = s_ll & ((1u << n[2]) - 1u);
  }
  const int llpk = __ldg(cst + kOLLX + q.llc), mlpk = __ldg(cst + kOMLX + q.mlc);
  v[3] = q.ll - static_cast<int>(static_cast<uint32_t>(llpk) >> 8), n[3] = llpk & 0xFF;
  v[4] = q.mlv + 3 - static_cast<int>(static_cast<uint32_t>(mlpk) >> 8), n[4] = mlpk & 0xFF;
  v[5] = q.ofv - (1 << q.ofc), n[5] = q.ofc;
}

// Or n (<= 32) bits of v into the staging words at bit o.
__device__ __forceinline__ void or_bits(uint32_t* wds, int o, uint32_t v, int n) {
  if (n == 0) return;
  if (n < 32) v &= (1u << n) - 1u;
  const uint64_t x = static_cast<uint64_t>(v) << (o & 31);
  if (static_cast<uint32_t>(x)) atomicOr(wds + (o >> 5), static_cast<uint32_t>(x));
  if (x >> 32) atomicOr(wds + (o >> 5) + 1, static_cast<uint32_t>(x >> 32));
}

// Copy the staging bytes [0, n) to the row at o, and zero the staging words
// [0, ceil(n / 4)) behind them.  Ends in a barrier.
__device__ __forceinline__ void unstage(uint32_t* wds, uint8_t* orow, int o, int n, int tid) {
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(wds);
  for (int i = tid; i < n; i += kPThreads) orow[o + i] = sb[i];
  __syncthreads();
  for (int i = tid; i < (n + 3) >> 2; i += kPThreads) wds[i] = 0;
  __syncthreads();
}

// K(s): the first candidate position p >= s that passes the cost gate from
// anchor s (its gate level at most p - s: the back extension it needs, of
// the at most 3 bytes before it that match), -1 if none.  Only the
// positions in rmask (level above 0) need their level read.
__device__ __forceinline__ int kept_from(const uint32_t* gmask, const uint32_t* rmask,
                                         const uint16_t* nw, const uint8_t* plvl, int s) {
  int q = lzp::next_set(gmask, nw, s);
  while (q >= 0 && q - s < 3 && ((rmask[q >> 5] >> (q & 31)) & 1) && plvl[q] > q - s)
    q = lzp::next_set(gmask, nw, q + 1);
  return q;
}

// Phases 1-5 of one chunk (its first size = min(max(sizes[chunk], 0), cap)
// bytes at `in`), into the CTA's shared memory and scratch row scw.  Returns
// m, the sequence count, after a barrier; sequence j < m has its anchor at
// path[j] and its match at tokk[j] (nm2), ll | (ml - 3) << 16 in seqa[j],
// the offset value in seqb[j], llc | mlc << 6 | ofc << 12 in seqc[j], the
// repeat stack before it in sstack[j]; misc[kZUsed..] has a bit for each
// code used.
__device__ __forceinline__ int zstd_parse(uint8_t* smem, const uint8_t* __restrict__ in,
                                          int size, const int32_t* __restrict__ c4,
                                          const int32_t* __restrict__ c8, int cap,
                                          const int32_t* __restrict__ cst,
                                          int32_t* __restrict__ scw) {
  uint8_t* bytes = smem + kZA;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bytes);
  uint16_t* nextv = reinterpret_cast<uint16_t*>(smem + kZN);
  uint32_t* gmask = reinterpret_cast<uint32_t*>(smem + kZG);
  uint16_t* nw = reinterpret_cast<uint16_t*>(smem + kZNW);
  uint32_t* marks = reinterpret_cast<uint32_t*>(smem + kZMarks);
  uint32_t* rmask = reinterpret_cast<uint32_t*>(smem + kZR);
  uint16_t* path = reinterpret_cast<uint16_t*>(smem + kZPath);
  uint16_t* tokk = reinterpret_cast<uint16_t*>(smem + kZK);
  int* scr = reinterpret_cast<int*>(smem + kZScr);
  uint64_t* scr64 = reinterpret_cast<uint64_t*>(smem + kZScr64);
  int* misc = reinterpret_cast<int*>(smem + kZMisc);

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int mflimit = size - kMinMatch + 1;
  uint32_t* pinfo = reinterpret_cast<uint32_t*>(scw + kScrInfo);
  uint8_t* plvl = reinterpret_cast<uint8_t*>(scw + kScrLvl);
  int32_t* seqa = scw + kScrSeqA;
  int32_t* seqb = scw + kScrSeqB;
  uint64_t* sstack = reinterpret_cast<uint64_t*>(scw + kScrStack);
  int32_t* seqc = scw + kScrCode;

  // ---- 1: stage the bytes; clear the masks
  lzp::stage_bytes(bytes, in, size, cap, tid);
  for (int i = tid; i < kWords; i += kPThreads) gmask[i] = 0, marks[i] = 0, rmask[i] = 0;
  if (tid < 24) misc[tid] = 0;
  __syncthreads();

  // ---- 2: every candidate position's offset c, forward length Lf (no cap:
  // zstd's extension may run to the end of the chunk), and gate level: the
  // least back extension b with (Lf + b) * 5 >= floor(log2 c) + 18, kept
  // when the position's own back extension (at most 3 bytes, src2 > 0)
  // reaches it; 3 bytes always pass (5 * 7 >= 33).  G = level <= 3.
  const int nblk = mflimit > 0 ? (mflimit + 31) >> 5 : 0;
  // warp wi takes a stretch of blocks from the top down, each handing its
  // lowest items' first mismatches to the block below (long matches cost a
  // compare a run, not one a block)
  const int bper = (nblk + kPWarps - 1) / kPWarps;
  lzp::Carry carry{{-1, -1}, {0, 0}, {0, 0}};
  const int top = min(nblk, (wi + 1) * bper) - 1;
  int c4n = -1, c8n = -1;  // the next block's candidates, loaded a block ahead
  if (top >= wi * bper && top * 32 + lane < mflimit)
    c4n = __ldg(c4 + top * 32 + lane), c8n = __ldg(c8 + top * 32 + lane);
  for (int blk = top; blk >= wi * bper; --blk) {
    const int p = blk * 32 + lane;
    const int c4p = c4n, c8p = c8n;
    c4n = c8n = -1;
    if (blk > wi * bper) c4n = __ldg(c4 + p - 32), c8n = __ldg(c8 + p - 32);
    const bool isc = c4p >= 0 || c8p >= 0;
    const int p4 = c4p >= 0 ? c4p : c8p;
    const int p8 = c8p >= 0 ? c8p : p4;
    const int fcap = isc ? size - (p + kMinMatch) : 0;
    const bool two = isc && p8 != p4;
    int l4, l8;
    lzp::warp_extend<kNoCap>(words, p, isc, p4, two, p8, fcap, size, lane, l4, l8, &carry);
    int lvl = kNotCand;
    uint32_t info = 0;
    if (isc) {
      const int len = two ? max(l4, l8) : l4;
      const int src = two && l8 > l4 ? p8 : p4;
      const int c = p - src, lf = kMinMatch + len;
      int b3 = 0;
      while (b3 < 3 && src - 1 - b3 >= 0 && bytes[p - 1 - b3] == bytes[src - 1 - b3]) ++b3;
      const int need = max(0, (hibit(c) + 18 + 4) / 5 - lf);
      lvl = need <= b3 ? need : kNoGate;
      info = static_cast<uint32_t>(lf) | (static_cast<uint32_t>(c) << 16);
    }
    const unsigned g = __ballot_sync(kFull, lvl <= 3);
    const unsigned r = __ballot_sync(kFull, lvl != 0 && lvl != kNotCand);
    if (lane == 0) gmask[blk] = g, rmask[blk] = r;
    if (lvl == 0) {  // a sure keep from its own anchor: next(p) = E(p)
      const int e = p + static_cast<int>(info & 0xFFFF);
      nextv[p] = static_cast<uint16_t>(e >= mflimit ? kTerm : e);
    }
    if (p < mflimit) {
      pinfo[p] = info;
      plvl[p] = static_cast<uint8_t>(lvl);
    }
  }
  __syncthreads();

  // ---- 3: next(s) for every other s < mflimit: E(K(s)) = K + Lf(K), the
  // chain's next position when no repeat offset intervenes
  if (mflimit > 0) lzp::next_set_words(gmask, nw, scr, tid, lane, wi);
  for (int s0 = tid; s0 < mflimit; s0 += 8 * kPThreads) {  // eight at a time: loads in flight
    int k[8];
    uint32_t inf[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = s0 + u * kPThreads;
      const bool sure = s < mflimit && ((gmask[s >> 5] & ~rmask[s >> 5]) >> (s & 31)) & 1;
      k[u] = s < mflimit && !sure ? kept_from(gmask, rmask, nw, plvl, s) : -2;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) inf[u] = k[u] >= 0 ? pinfo[k[u]] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = s0 + u * kPThreads;
      if (s >= mflimit) break;
      if (k[u] == -2) continue;  // phase 2 wrote it
      int v = kStop;
      if (k[u] >= 0) {
        const int e = k[u] + static_cast<int>(inf[u] & 0xFFFF);
        v = e >= mflimit ? kTerm : e;
      }
      nextv[s] = static_cast<uint16_t>(v);
    }
  }
  __syncthreads();

  // ---- 4: rounds.  The chain from x0 through next() (32 merged chases),
  // its sequences' match positions, the repeat stack before each (a block
  // scan), then every candidate that fails the gate in the stretch a
  // sequence scans: the first whose offset is on the stack is kept instead
  // (the walk's repeat rule), and the next round starts past its match.
  int x0 = 0, j0 = 0;
  uint64_t stk0 = 1u | (4u << 16) | (static_cast<uint64_t>(8) << 32);
  int m = 0;
  while (x0 < mflimit) {
    if (wi == 0) {
      int ep, ek;
      lzp::chase(nextv, marks, x0, mflimit, lane, ep, ek);
      if (lane == 0) misc[kZEndPos] = ep, misc[kZEndKind] = ek, misc[kZViol] = 0x7FFFFFFF;
    }
    __syncthreads();
    m = lzp::marks_to_list(marks, path, j0, x0, true, scr, misc, tid, lane, wi);
    const int end_pos = misc[kZEndPos], end_kind = misc[kZEndKind];
    for (int j = j0 + tid; j < m; j += kPThreads)
      tokk[j] = static_cast<uint16_t>(kept_from(gmask, rmask, nw, plvl, path[j]));
    __syncthreads();
    // the stack before each sequence j >= j0: thread tid folds [q0, q1)
    const int n = m - j0, per = (n + kPThreads - 1) / kPThreads;
    const int q0 = j0 + min(n, tid * per), q1 = j0 + min(n, tid * per + per);
    uint64_t sum = 0;
    for (int j = q0; j < q1; ++j) sum = st_push(sum, pinfo[tokk[j]] >> 16);
    uint64_t inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc = st_join(u, inc);
    }
    if (lane == 31) scr64[wi] = inc;
    __syncthreads();
    uint64_t pre = stk0;
    for (int w = 0; w < wi; ++w) pre = st_join(pre, scr64[w]);
    uint64_t ex = __shfl_up_sync(kFull, inc, 1);
    if (lane > 0) pre = st_join(pre, ex);
    for (int j = q0; j < q1; ++j) {
      sstack[j] = pre;
      pre = st_push(pre, pinfo[tokk[j]] >> 16);
    }
    if (q1 == m && q1 > q0) misc[kZLast0] = static_cast<int>(pre), misc[kZLast1] = static_cast<int>(pre >> 32);
    if (n == 0 && tid == 0) misc[kZLast0] = static_cast<int>(stk0), misc[kZLast1] = static_cast<int>(stk0 >> 32);
    __syncthreads();
    const uint64_t last = static_cast<uint32_t>(misc[kZLast0]) |
                          (static_cast<uint64_t>(static_cast<uint32_t>(misc[kZLast1])) << 32);
    // the repeat check, over the candidates that are no sure keep (rmask):
    // thread tid takes positions [64 tid, 64 tid + 64); the sequence whose
    // stretch holds p is the last chain position at or before it
    {
      const int w0 = 2 * tid;
      uint32_t mk[2], rk[2];
      for (int k = 0; k < 2; ++k) {
        const uint32_t keep = w0 + k < (x0 >> 5) ? 0u
                              : w0 + k == (x0 >> 5) ? kFull << (x0 & 31) : kFull;
        mk[k] = marks[w0 + k] & keep;
        rk[k] = rmask[w0 + k] & keep;
      }
      const int before = lzp::block_scan_excl(__popc(mk[0]) + __popc(mk[1]), 0,
                                              [](int a, int b) { return a + b; }, scr, lane, wi);
      bool found = false;
      for (int k = 0; k < 2 && !found; ++k) {
        for (uint32_t bits = rk[k]; bits && !found; bits &= bits - 1) {
          const int bit = __ffs(bits) - 1, p = 32 * (w0 + k) + bit;
          uint64_t sk;
          if (end_kind == 0 && p >= end_pos) {
            sk = last;  // the stretch after the last sequence
          } else {
            const int cur = j0 - 1 + before + (k ? __popc(mk[0]) : 0) +
                            __popc(mk[k] & ((2u << bit) - 1u));
            if (cur < j0 || p >= tokk[cur]) continue;  // inside a match
            sk = sstack[cur];
          }
          const uint64_t c = pinfo[p] >> 16;
          if (c == st_get(sk, 0) || c == st_get(sk, 1) || c == st_get(sk, 2)) {
            atomicMin(&misc[kZViol], p);
            found = true;
          }
        }
      }
    }
    __syncthreads();
    const int pv = misc[kZViol];
    if (pv == 0x7FFFFFFF) break;
    // the sequence that keeps pv: the last one anchored at or before it, or a
    // new one at end_pos
    int jv;
    uint64_t before;
    if (end_kind == 0 && pv >= end_pos) {
      jv = m;
      before = last;
    } else {
      int lo = j0, hi = m;  // the last j with path[j] <= pv
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (path[mid] <= pv) lo = mid; else hi = mid;
      }
      jv = lo;
      before = sstack[jv];
    }
    __syncthreads();
    const int sv = jv == m ? end_pos : path[jv];
    // clear the marks past sv, keep sv's
    for (int w = tid; w < kWords; w += kPThreads) {
      const int lo = sv + 1;
      if (32 * w + 31 < lo) continue;
      marks[w] &= (lo >> 5) == w ? ((1u << (lo & 31)) - 1u) : 0u;
    }
    if (tid == 0) {
      if (jv == m) marks[sv >> 5] |= 1u << (sv & 31);
      path[jv] = static_cast<uint16_t>(sv);
      tokk[jv] = static_cast<uint16_t>(pv);
      sstack[jv] = before;
    }
    __syncthreads();
    stk0 = st_push(before, pinfo[pv] >> 16);
    j0 = jv + 1;
    m = j0;
    x0 = pv + static_cast<int>(pinfo[pv] & 0xFFFF);
  }
  __syncthreads();

  // ---- 5: the sequences: the exact back extension (bounded by the anchor
  // and src2 > 0), ll, ml, the offset value from the stack, the codes
  {
    const int per = (m + kPThreads - 1) / kPThreads;
    const int q0 = min(m, tid * per), q1 = min(m, tid * per + per);
    for (int j = q0; j < q1; ++j) {
      const int s = path[j], k = tokk[j];
      const uint32_t inf = pinfo[k];
      const int c = inf >> 16, lf = inf & 0xFFFF;
      int nm2 = k, src2 = k - c;
      while (nm2 > s && src2 > 0 && __ldg(in + nm2 - 1) == __ldg(in + src2 - 1)) --nm2, --src2;
      const int ll = nm2 - s, ml = k - nm2 + lf;
      const uint64_t sk = sstack[j];
      const int r0 = st_get(sk, 0), r1 = st_get(sk, 1), r2 = st_get(sk, 2);
      const int ofv = ll > 0 ? (c == r0 ? 1 : c == r1 ? 2 : c == r2 ? 3 : c + 3)
                             : (c == r1 ? 1 : c == r2 ? 2 : c + 3);
      seqa[j] = static_cast<int32_t>(static_cast<uint32_t>(ll) | (static_cast<uint32_t>(ml - 3) << 16));
      seqb[j] = ofv;
      const int llc = ll_code(cst, ll), mlc = ml_code(cst, ml - 3), ofc = hibit(ofv);
      seqc[j] = llc | (mlc << 6) | (ofc << 12);
      atomicOr(&misc[kZUsed + (llc >> 5)], 1 << (llc & 31));
      atomicOr(&misc[kZUsed + 2 + (mlc >> 5)], 1 << (mlc & 31));
      atomicOr(&misc[kZUsed + 4], 1 << min(ofc, 31));
      tokk[j] = static_cast<uint16_t>(nm2);
    }
  }
  __syncthreads();
  return m;
}

// The hist kernel's chunk: the parse, then the counts of its sequences'
// codes and of the bytes no match covers.
__device__ __forceinline__ void hist_chunk(int chunk, uint8_t* smem,
                                           const uint8_t* __restrict__ data,
                                           const int32_t* __restrict__ sizes,
                                           const int32_t* __restrict__ cand,
                                           const int32_t* __restrict__ cand8, int cap,
                                           const int32_t* __restrict__ cst,
                                           int32_t* __restrict__ scw, int32_t* __restrict__ freq,
                                           int32_t* __restrict__ sch) {
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  const int size = min(max(sizes[chunk], 0), min(cap, kMaxPos));
  const int m = zstd_parse(smem, in, size, cand + row, cand8 + row, cap, cst, scw);
  const uint16_t* tokk = reinterpret_cast<const uint16_t*>(smem + kZK);
  const int32_t* seqa = scw + kScrSeqA;
  const int32_t* seqc = scw + kScrCode;
  uint32_t* cover = reinterpret_cast<uint32_t*>(smem + kZCover);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + kZHist);
  for (int i = tid; i < lzp::kHistCopies * kHist; i += kPThreads) hist[i] = 0;
  for (int i = tid; i < kWords; i += kPThreads) cover[i] = 0;
  __syncthreads();
  uint32_t* h = hist + (wi % lzp::kHistCopies) * kHist;
  for (int jb = wi * 32; jb < m; jb += kPThreads) {  // the sequences' codes and matches
    const int j = jb + lane;
    int s = 0, ml = 0, code = 0;
    if (j < m) {
      s = tokk[j];
      ml = static_cast<int>(static_cast<uint32_t>(seqa[j]) >> 16) + 3;
      code = seqc[j];
    }
    lzp::warp_cover(cover, s, ml, j < m, lane);
    lzp::warp_count(h, j < m ? 256 + (code & 0x3F) : -1, lane);
    lzp::warp_count(h, j < m ? 256 + 36 + ((code >> 6) & 0x3F) : -1, lane);
    lzp::warp_count(h, j < m ? 256 + 89 + min(code >> 12, 31) : -1, lane);
  }
  __syncthreads();
  lzp::count_uncovered(in, cover, h, size, lane, wi);  // the literals, from global memory
  __syncthreads();
  for (int i = tid; i < kHist; i += kPThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < lzp::kHistCopies; ++c) v += hist[c * kHist + i];
    if (i < 256)
      freq[static_cast<size_t>(chunk) * 256 + i] = static_cast<int32_t>(v);
    else
      sch[static_cast<size_t>(chunk) * 121 + i - 256] = static_cast<int32_t>(v);
  }
}

// The full kernel's chunk: the parse, then phases 5b-9.
__device__ __forceinline__ void full_chunk(
    int chunk, uint8_t* smem, const uint8_t* __restrict__ data,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ cand8, int cap, const int32_t* __restrict__ cst,
    const int32_t* __restrict__ huf_meta, const uint8_t* __restrict__ tree,
    const int32_t* __restrict__ fse_tab, const uint8_t* __restrict__ nc,
    int32_t* __restrict__ scw, uint8_t* __restrict__ out, int out_cap,
    int32_t* __restrict__ out_sizes, int32_t* __restrict__ statuses) {
  uint32_t* litpos = reinterpret_cast<uint32_t*>(smem + kZN);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + kZA);
  uint16_t* path = reinterpret_cast<uint16_t*>(smem + kZPath);
  uint16_t* tokk = reinterpret_cast<uint16_t*>(smem + kZK);
  int32_t* huf = reinterpret_cast<int32_t*>(smem + kZHuf);
  int* scr = reinterpret_cast<int*>(smem + kZScr);
  int* misc = reinterpret_cast<int*>(smem + kZMisc);

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  const int size = min(max(sizes[chunk], 0), min(cap, kMaxPos));
  int32_t* seqa = scw + kScrSeqA;
  int32_t* seqb = scw + kScrSeqB;
  uint32_t* sstate = reinterpret_cast<uint32_t*>(scw + kScrState);
  int32_t* seqc = scw + kScrCode;
  uint16_t* t16 = reinterpret_cast<uint16_t*>(smem + kZFse);
  uint32_t* scodes = reinterpret_cast<uint32_t*>(smem + kZCodes);
  const int32_t* fse = fse_tab + static_cast<size_t>(chunk) * kFseTT;
  const int32_t* meta = huf_meta + static_cast<size_t>(chunk) * kHufMeta;
  const int m = zstd_parse(smem, in, size, cand + row, cand8 + row, cap, cst, scw);

  // ---- 5b: the Huffman codes; the literal counts' prefix places each
  // sequence's literals
  for (int i = tid; i < 256; i += kPThreads) huf[i] = meta[i];
  {
    const int per = (m + kPThreads - 1) / kPThreads;
    const int q0 = min(m, tid * per), q1 = min(m, tid * per + per);
    int mylit = 0;
    for (int j = q0; j < q1; ++j) mylit += tokk[j] - path[j];
    int at = lzp::block_scan_excl(mylit, 0, [](int a, int b) { return a + b; }, scr, lane, wi);
    for (int j = q0; j < q1; ++j) {
      litpos[j] = at;
      at += tokk[j] - path[j];
    }
    if (tid == kPThreads - 1) misc[kZNlit] = at;
  }
  __syncthreads();
  const int tail = m > 0 ? tokk[m - 1] + static_cast<int>((static_cast<uint32_t>(seqa[m - 1]) >> 16) + 3)
                         : 0;
  const int n_lit = misc[kZNlit] + size - tail;
  uint8_t* lit = reinterpret_cast<uint8_t*>(scw + kScrLit);
  for (int j = wi; j <= m; j += kPWarps) {  // warp j: sequence j's literals (j == m: the tail)
    const int a = j < m ? path[j] : tail, b = j < m ? tokk[j] : size;
    const int o = j < m ? static_cast<int>(litpos[j]) : misc[kZNlit];
    for (int i = lane; i < b - a; i += 32) lit[o + i] = in[a + i];
  }
  __syncthreads();
  if (tid < 4) misc[kZSb + tid] = 0;
  __syncthreads();

  // ---- 6: the literal section's length: each stream's bits (4 streams of
  // ceil(n_lit / 4) literals, the last the rest), its bytes with the
  // sentinel, Huffman or raw
  const int tree_b = meta[256];
  const int per4 = (n_lit + 3) >> 2;
  const int lper = (n_lit + kPThreads - 1) / kPThreads;
  const int i0 = min(n_lit, tid * lper), i1 = min(n_lit, tid * lper + lper);
  const bool try_huf = meta[257] > 0 && n_lit >= 64;
  int sb[4] = {0, 0, 0, 0};
  bool use_huf = false;
  if (try_huf) {
    int part[4] = {0, 0, 0, 0};
    for (int i = i0; i < i1; ++i) part[min(i / per4, 3)] += huf[lit[i]] >> 12;
    for (int k = 0; k < 4; ++k)
      if (part[k]) atomicAdd(&misc[kZSb + k], part[k]);
    __syncthreads();
    int s_total = 0;
    for (int k = 0; k < 4; ++k) sb[k] = (misc[kZSb + k] + 1 + 7) >> 3, s_total += sb[k];
    use_huf = 5 + (tree_b + 6 + s_total) < 3 + n_lit;
  }
  const int csize = tree_b + 6 + sb[0] + sb[1] + sb[2] + sb[3];
  const int o1 = use_huf ? 18 + csize : 16 + n_lit;

  // ---- 7: the FSE states, step b = m - 1 - j (from the last sequence).
  // The used columns of the encode tables come into shared memory (t16:
  // next state << 1 | bits << 11), each step's codes too.  Lane 3g + t of
  // warp 0 chases table t's states (LL, ML, OF) over segment g of the steps
  // from a guessed start (the first slots), into table t's row of the
  // scratch; then lanes 0-2 join the segments in order: from the true state
  // entering one, each steps until it meets the chase (predefined tables'
  // states soon do; custom tables' seldom) or the segment's end.  A step is
  // one add, one shared load and one and (the state kept doubled, a byte
  // offset; the columns of eight steps worked out first), with no branch.
  auto seq_at = [&](int b) {
    const int j = m - 1 - b;
    const uint32_t a = static_cast<uint32_t>(seqa[j]), code = static_cast<uint32_t>(seqc[j]);
    Seq q;
    q.ll = a & 0xFFFF, q.mlv = (a >> 16) & 0xFFFF, q.ofv = seqb[j];
    q.llc = code & 0x3F, q.mlc = (code >> 6) & 0x3F, q.ofc = code >> 12;
    return q;
  };
  auto used = [&](int i) {
    if (i < kO2ML) return (misc[kZUsed + (i >> 14)] >> ((i >> 9) & 31)) & 1;
    if (i < kO2OF) return (misc[kZUsed + 2 + ((i - kO2ML) >> 14)] >> (((i - kO2ML) >> 9) & 31)) & 1;
    return (misc[kZUsed + 4] >> ((i - kO2OF) >> 8)) & 1;
  };
  for (int i0 = tid; i0 < kO2LLF; i0 += 8 * kPThreads) {  // eight loads in flight
    int e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kPThreads;
      e[u] = i < kO2LLF && used(i) ? __ldg(fse + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (e[u] >= 0) t16[i0 + u * kPThreads] = static_cast<uint16_t>(((e[u] & 0x3FF) << 1) | (((e[u] >> 10) & 0xF) << 11));
  }
  for (int b = tid; b < m; b += kPThreads) scodes[b] = seqc[m - 1 - b];
  __syncthreads();
  uint16_t* lstate = reinterpret_cast<uint16_t*>(scw + kScrLane);  // [3][kMaxSeq]
  if (wi == 0 && lane < 3 * kSegs && m > 0) {
    // lane 3g + t: table t (its code field: LL bits 0-5, ML 6-11, OF from
    // 12 capped at 31; its columns' start and width in bytes; its first
    // slots), segment g
    const int t = lane % 3, g = lane / 3;
    const int shr = 6 * t, lim = t == 2 ? 31 : 63;
    const uint32_t mask = t == 2 ? 0xFFFFFFFFu : 0x3Fu;
    const int cols2 = 2 * (t == 0 ? kO2LL : t == 1 ? kO2ML : kO2OF);
    const int width2 = t == 2 ? 512 : 1024;
    const int firsts = t == 0 ? kO2LLF : t == 1 ? kO2MLF : kO2OFF;
    uint16_t* mine = lstate + t * kMaxSeq;
    const char* tb = reinterpret_cast<const char*>(t16);
    const int seg = (m + kSegs - 1) / kSegs;
    // steps [b, b + 8) from doubled state s2, each stored when before `to`;
    // returns the doubled state after step b + 7
    auto eight = [&](int b, int to, int s2) {
      int cb[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = min(b + u, m - 1);
        cb[u] = cols2 + min(static_cast<int>((scodes[i] >> shr) & mask), lim) * width2;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s2 = *reinterpret_cast<const uint16_t*>(tb + cb[u] + s2) & 0x7FE;
        if (b + u < to) mine[b + u] = static_cast<uint16_t>(s2 >> 1);
      }
      return s2;
    };
    const int lo = min(m, g * seg), hi = min(m, lo + seg);
    if (lo < hi) {  // the chase: segment 0's start is the true one
      const int st0 = fse_at(fse, firsts + min(static_cast<int>((scodes[lo] >> shr) & mask), lim));
      mine[lo] = static_cast<uint16_t>(st0);
      int s2 = 2 * (st0 & 0x3FF);
      for (int b = lo + 1; b < hi; b += 8) s2 = eight(b, hi, s2);
    }
    __syncwarp(0x3FFFFFFFu);
    if (g == 0) {  // the join
      for (int k = 1; k < kSegs && k * seg < m; ++k) {
        const int jlo = k * seg, jhi = min(m, jlo + seg);
        int s2 = 2 * (mine[jlo - 1] & 0x3FF);
        for (int b = jlo; b < jhi; b += 8) {
          const int guess = b + 7 < jhi ? mine[b + 7] : -1;  // the chase's state there
          s2 = eight(b, jhi, s2);
          if (2 * guess == s2) break;  // met: the chase is right from here on
        }
      }
    }
  }
  __syncthreads();
  for (int b = tid; b < m; b += kPThreads)
    sstate[b] = static_cast<uint32_t>(lstate[b]) | (static_cast<uint32_t>(lstate[kMaxSeq + b]) << 10) |
                (static_cast<uint32_t>(lstate[2 * kMaxSeq + b]) << 20);
  const int sper = (m + kPThreads - 1) / kPThreads;
  const int b0 = min(m, tid * sper), b1 = min(m, tid * sper + sper);
  __syncthreads();
  for (int i = tid; i < kStage / 4; i += kPThreads) stage[i] = 0;
  __syncthreads();

  // ---- 8: the sequence stream's length, then the frame's
  int mybits = 0;
  for (int b = b0; b < b1; ++b) {
    uint32_t v[6];
    int nn[6];
    fse_fields(t16, cst, seq_at(b), b == 0, b > 0 ? sstate[b - 1] : 0, v, nn);
    mybits += nn[0] + nn[1] + nn[2] + nn[3] + nn[4] + nn[5];
  }
  const int bits_before = lzp::block_scan_excl(mybits, 0, [](int a, int b) { return a + b; }, scr,
                                               lane, wi);
  if (tid == kPThreads - 1) misc[kZSum] = bits_before + mybits;
  __syncthreads();
  const int acc_ll = fse_at(fse, kO2Meta), acc_ml = fse_at(fse, kO2Meta + 1),
            acc_of = fse_at(fse, kO2Meta + 2);
  const int nc_len = min(fse_at(fse, kO2Meta + 4), kNcCap);
  const int seq_bits = misc[kZSum] + acc_ml + acc_of + acc_ll + 1;
  const int seq_bytes = (seq_bits + 7) >> 3;
  int total = m > 0 ? o1 + 3 + nc_len + seq_bytes : o1 + 1;
  const bool raw = total >= 13 + size;
  if (raw) total = 13 + size;
  const bool too_big = total > out_cap;
  const int osz = too_big ? 0 : total;
  uint8_t* orow = out + static_cast<size_t>(chunk) * out_cap;
  if (tid == 0) {
    out_sizes[chunk] = osz;
    statuses[chunk] = too_big ? kOutputTooSmall : kSuccess;
  }
  lzp::zero_bytes(orow, osz, out_cap, tid);
  if (too_big) return;

  // ---- 9: the frame: header, then raw block, or literal and sequence sections
  if (tid == 0) {  // magic, FHD (4-byte FCS), window, FCS, block header
    const int bh = raw ? 1 | (size << 3) : 1 | (2 << 1) | ((total - 13) << 3);
    const int bl = 32 - __clz(max(size - 1, 1));
    const int wl = size <= 1024 ? 10 : max(bl, 10);
    const int head[13] = {0x28, 0xB5, 0x2F, 0xFD, 0x80, (wl - 10) << 3,
                          size & 0xFF, (size >> 8) & 0xFF, (size >> 16) & 0xFF,
                          (size >> 24) & 0xFF, bh & 0xFF, (bh >> 8) & 0xFF, (bh >> 16) & 0xFF};
    for (int k = 0; k < 13; ++k) orow[k] = static_cast<uint8_t>(head[k]);
  }
  if (raw) {
    for (int i = tid; i < size; i += kPThreads) orow[13 + i] = in[i];
    return;
  }
  if (use_huf) {
    // each literal's bit place in its stream, written backward: the stream's
    // bits after it; then the sentinel after the stream's last bit
    int part[4] = {0, 0, 0, 0};
    for (int i = i0; i < i1; ++i) part[min(i / per4, 3)] += huf[lit[i]] >> 12;
    // inclusive prefix of each stream's bits below this thread's range
    int pre[4];
    for (int k = 0; k < 4; ++k)
      pre[k] = lzp::block_scan_excl(part[k], 0, [](int a, int b) { return a + b; }, scr, lane,
                                    wi);
    int sbits[4], sbyte[4], at = 0;
    for (int k = 0; k < 4; ++k) sbits[k] = misc[kZSb + k], sbyte[k] = at, at += sb[k];
    for (int i = i0; i < i1; ++i) {
      const int k = min(i / per4, 3);
      const int pk = huf[lit[i]];
      pre[k] += pk >> 12;
      or_bits(stage, 8 * sbyte[k] + sbits[k] - pre[k], pk & 0xFFF, pk >> 12);
    }
    if (tid < 4) or_bits(stage, 8 * sbyte[tid] + sbits[tid], 1, 1);
    __syncthreads();
    unstage(stage, orow, 18 + tree_b + 6, at, tid);
    for (int i = tid; i < min(tree_b, kTreeCap); i += kPThreads)
      orow[18 + i] = tree[static_cast<size_t>(chunk) * kTreeCap + i];
    if (tid == 0) {
      const int jo = 18 + tree_b;
      for (int k = 0; k < 3; ++k) {
        orow[jo + 2 * k] = static_cast<uint8_t>(sb[k] & 0xFF);
        orow[jo + 2 * k + 1] = static_cast<uint8_t>((sb[k] >> 8) & 0xFF);
      }
      // the 5-byte header: type 2 (compressed), Size_Format 3 (18 + 18 bits)
      const uint32_t lo = 2u | (3u << 2) | ((static_cast<uint32_t>(n_lit) & 0x3FFFF) << 4) |
                          ((static_cast<uint32_t>(csize) & 0x3FF) << 22);
      for (int k = 0; k < 4; ++k) orow[13 + k] = static_cast<uint8_t>((lo >> (8 * k)) & 0xFF);
      orow[17] = static_cast<uint8_t>((csize >> 10) & 0xFF);
    }
  } else {  // raw literals, the 3-byte header (Size_Format 3: a 20-bit size)
    if (tid == 0) {
      orow[13] = static_cast<uint8_t>((3 << 2) | ((n_lit & 0xF) << 4));
      orow[14] = static_cast<uint8_t>((n_lit >> 4) & 0xFF);
      orow[15] = static_cast<uint8_t>((n_lit >> 12) & 0xFF);
    }
    for (int i = tid; i < n_lit; i += kPThreads) orow[16 + i] = lit[i];
  }
  if (m == 0) {
    if (tid == 0) orow[o1] = 0;
    return;
  }
  // the sequences section: count, modes, the tables' descriptions, the stream
  if (tid == 0) {
    orow[o1] = static_cast<uint8_t>(128 + (m >> 8));
    orow[o1 + 1] = static_cast<uint8_t>(m & 0xFF);
    orow[o1 + 2] = static_cast<uint8_t>(fse_at(fse, kO2Meta + 3));
  }
  for (int i = tid; i < nc_len; i += kPThreads)
    orow[o1 + 3 + i] = nc[static_cast<size_t>(chunk) * kNcCap + i];
  int o = bits_before;
  for (int b = b0; b < b1; ++b) {
    uint32_t v[6];
    int nn[6];
    fse_fields(t16, cst, seq_at(b), b == 0, b > 0 ? sstate[b - 1] : 0, v, nn);
    for (int k = 0; k < 6; ++k) {
      or_bits(stage, o, v[k], nn[k]);
      o += nn[k];
    }
  }
  if (tid == 0) {  // the final states and the padding bit
    const uint32_t st = sstate[m - 1];
    int q = misc[kZSum];
    or_bits(stage, q, (st >> 10) & 0x3FF, acc_ml), q += acc_ml;
    or_bits(stage, q, (st >> 20) & 0x3FF, acc_of), q += acc_of;
    or_bits(stage, q, st & 0x3FF, acc_ll), q += acc_ll;
    or_bits(stage, q, 1, 1);
  }
  __syncthreads();
  unstage(stage, orow, o1 + 3 + nc_len, seq_bytes, tid);
}

// The kernels, a CTA an SM: CTA i takes every gridDim-th chunk from i,
// through scratch row i.
__global__ void __launch_bounds__(kPThreads, 1)
zstd_hist_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                 const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8, int batch,
                 int cap, const int32_t* __restrict__ cst, int32_t* __restrict__ scratch,
                 int32_t* __restrict__ freq, int32_t* __restrict__ sch) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* scw = scratch + static_cast<size_t>(blockIdx.x) * kScrWords;
  for (int chunk = blockIdx.x; chunk < batch; chunk += gridDim.x) {
    hist_chunk(chunk, smem, data, sizes, cand, cand8, cap, cst, scw, freq, sch);
    __syncthreads();  // shared memory and the scratch row are the next chunk's
  }
}

__global__ void __launch_bounds__(kPThreads, 1)
zstd_full_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                 const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8, int batch,
                 int cap, const int32_t* __restrict__ cst, const int32_t* __restrict__ huf_meta,
                 const uint8_t* __restrict__ tree, const int32_t* __restrict__ fse_tab,
                 const uint8_t* __restrict__ nc, int32_t* __restrict__ scratch,
                 uint8_t* __restrict__ out, int out_cap, int32_t* __restrict__ out_sizes,
                 int32_t* __restrict__ statuses) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* scw = scratch + static_cast<size_t>(blockIdx.x) * kScrWords;
  for (int chunk = blockIdx.x; chunk < batch; chunk += gridDim.x) {
    full_chunk(chunk, smem, data, sizes, cand, cand8, cap, cst, huf_meta, tree, fse_tab, nc, scw,
               out, out_cap, out_sizes, statuses);
    __syncthreads();  // shared memory and the scratch row are the next chunk's
  }
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).  cst is ops/cuda/zstd_encode.py's CONST; cap <= 65536; scratch
// int32[ctas, scratch_words()], a row for each of the min(B, ctas) CTAs
// launched (the per-position table, the sequence records, the literals),
// which both kernels may share on one stream.

// The parse's scratch a CTA, in int32 words.
extern "C" int tpucomp_zstd_encode_scratch_words() { return kScrWords; }

// hist: freq int32[B, 256], sch int32[B, 121].
extern "C" int tpucomp_zstd_encode_hist(const uint8_t* data, const int32_t* sizes,
                                        const int32_t* cand, const int32_t* cand8, int batch,
                                        int cap, const int32_t* cst, int32_t* scratch, int ctas,
                                        int32_t* freq, int32_t* sch, void* stream) {
  if (batch <= 0) return 0;
  if (cap > kMaxPos || ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long raised = 0;  // one bit a device
  const cudaError_t e = lzp::raise_smem_limit(zstd_hist_kernel, kZBytes, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  zstd_hist_kernel<<<min(batch, ctas), kPThreads, kZBytes, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, batch, cap, cst, scratch, freq, sch);
  return static_cast<int>(cudaGetLastError());
}

// full: huf_meta int32[B, 258] (code | nbits << 12 per byte, tree bytes,
// huf_ok), tree uint8[B, 176], fse_tab int32[B, 54016], nc uint8[B, 512].
extern "C" int tpucomp_zstd_encode_full(const uint8_t* data, const int32_t* sizes,
                                        const int32_t* cand, const int32_t* cand8, int batch,
                                        int cap, const int32_t* cst, const int32_t* huf_meta,
                                        const uint8_t* tree, const int32_t* fse_tab,
                                        const uint8_t* nc, int32_t* scratch, int ctas,
                                        uint8_t* out, int out_cap, int32_t* out_sizes,
                                        int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  if (cap > kMaxPos || ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long raised = 0;  // one bit a device
  const cudaError_t e = lzp::raise_smem_limit(zstd_full_kernel, kZBytes, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  zstd_full_kernel<<<min(batch, ctas), kPThreads, kZBytes, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, batch, cap, cst, huf_meta, tree, fse_tab, nc, scratch, out,
      out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}
