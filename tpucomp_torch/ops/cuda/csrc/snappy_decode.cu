// Batched Snappy block decode in two kernels, chosen by shape: the parse, one
// CTA of 1024 threads a chunk (out_cap <= 65536 and a padded row of at most
// 81920 bytes: every shape the batched API makes at its 64 KiB chunk size),
// and the walk, one warp a chunk (any shape; the wrapper takes it where the
// parse's shared memory does not reach).
//
// Replaces the TPU kernel tpucomp/ops/pallas/snappy_decode.py::_kernel
// (called by decompress_batch at snappy_decode.py:158).  That kernel walks
// one chunk per grid step: the scalar core reads tags out of SMEM words and
// moves literals and copies as 128-byte VPU wild stores.  What it computes,
// and what both kernels compute, is:
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
// So a chunk decodes (SUCCESS) exactly when the chain of element starts from
// the preamble ends at csize, no element on it fails its own check (ll < 1,
// s + ll > csize, ip + hdr > csize, off <= 0), no copy's offset passes the
// output before it, and the output lengths sum to expected; the row is then
// the decoded bytes, else it is all zero.  The walk stops once op passes
// out_cap + 1 (op only grows, so the end check must fail): the same status,
// without walking a csize far beyond the row.
//
// Bound: bytes.  A call must read each compressed byte once and write each
// output byte once (B x out_cap, the zero tail included).
//
// The parse (snappy_parse_kernel), in phases over 219 KiB of shared memory
// (one CTA an SM):
//  1. the preamble; a too-big or broken one writes the zero row at once;
//  2. the chunk's first min(wpad, csize + 8) bytes are staged by cp.async
//     (the compressed bytes, up to 80 KB, sit beside the parse's tables
//     until phase 5, which gives them up for the output window: its element
//     reads go to global memory, where the row sits in L2); every position
//     x < np = min(csize, wpad) gets the length d(x) its element would have
//     if a tag started there (hdr + ll for a literal, hdr for a copy), 4
//     bits a position: 0 where the element fails its own check, 15 where it
//     is longer (read again when needed);
//  3. the chain from the preamble's end through next(x) = x + d(x), whose
//     starts do not resynchronise from a wrong one (so merged chases, as the
//     LZ77 parse's, would walk it on one lane): a. for every x, the chain's
//     last element from x in x's block of 128 positions (its leaver), by six
//     rounds of pointer jumping (a block holds at most 64 elements); b. one
//     lane hops from leaver to leaver, a block a step, which gives each
//     block's entry and the chain's end; c. each entered block's thread
//     marks its elements in a bitmask;
//  4. each thread takes a stretch of the bitmask's words; its elements'
//     output lengths go through a block scan in 64 bits (a literal length
//     may reach 2^31), which gives op at every element and so the copies'
//     offset check; the status follows before a byte is written;
//  5. on success only (expected <= out_cap <= 65536), in a 64 KiB output
//     window and a u16 source a byte (192 KiB): each element marks its
//     output start (a bitmask) and its bytes' source distance (off, or 0 for
//     a literal); literals' bytes go into the window (those past 64 bytes
//     in pieces of 1 KiB, a warp a piece); a scan of the starts gives every
//     byte its source, o - the distance of the last start at or before it;
//     the copy chains are resolved by pointer jumping (at most 16 rounds for
//     64 KiB; bytes whose source is a literal's are skipped), and the row is
//     flushed in 16-byte stores with its zero tail.
// The tail: a chain may leave [0, np) only when csize > wpad.  Past wpad
// every element is one of four (its tag from the last two words, by x & 3;
// its literal bytes 0), so lane 0 walks the tail and, once a position's
// x & 3 comes round again, skips the whole cycles of elements that can
// neither fail nor pass csize or out_cap + 1 (a few steps in all); on
// success (at most out_cap bytes) it places the tail's elements itself.
//
// The walk (snappy_walk_kernel): a warp a chunk; all 32 lanes parse the
// same element (uniform control flow, broadcast loads); literal and copy
// bytes are spread over the lanes (csrc/bytecopy.cuh), 32 neighbouring
// bytes per store, straight into the output row.
// Both kernels write every byte of the output row, so the caller's buffer
// needs no clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "lz_parse.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
constexpr int kWarpsPerBlock = 4;  // the walk

// The compressed row as the reference's padded words: bytes at and past n
// (comp_cap, or where a staged copy ends) up to wpad read as 0.
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

// The varint32 preamble, in 32 bits as the reference: its length, the value
// and whether it is broken (a continuation after 5 bytes, a negative value,
// a csize shorter than it).
struct Preamble {
  int len;
  long long expected;
  bool err;
};

__device__ __forceinline__ Preamble preamble(const Words& src, long long csize) {
  uint32_t expected_u = src.byte(0) & 0x7F;
  bool more = (src.byte(0) & 0x80) != 0;
  int len = 1;
  for (int k = 1; k < 5; ++k) {
    const uint32_t bk = src.byte(k);
    if (more) {
      expected_u |= (bk & 0x7F) << (7 * k);
      ++len;
    }
    more = more && (bk & 0x80) != 0;
  }
  const long long expected = static_cast<int32_t>(expected_u);
  return {len, expected, more || csize < len || expected < 0};
}

// The element whose tag is at x, read as the walk reads it: its length in
// the stream (in), the bytes it writes (out), a literal's first byte (lit;
// -1 for a copy), a copy's offset, and its own check (ok: ll >= 1 and
// s + ll <= csize, or x + hdr <= csize and off > 0).
struct Elem {
  long long in, out, lit, off;
  bool ok;
};

// ... from its bytes: w = the 4 bytes the tag word gives, b4() the byte
// after (read only by a literal with 4 length bytes and a copy-4).
template <class B4>
__device__ __forceinline__ Elem decode(uint32_t w, B4 b4, long long x, long long csize) {
  const int tag = w & 0xFF, b1 = (w >> 8) & 0xFF, b2 = (w >> 16) & 0xFF, b3 = w >> 24;
  const int t6 = tag >> 2;
  Elem e;
  if ((tag & 3) == 0) {  // literal
    const int extra = min(max(t6 - 59, 0), 4);
    long long ll = t6 + 1;
    if (extra > 0) {
      uint32_t acc = b1;
      if (extra > 1) acc |= b2 << 8;
      if (extra > 2) acc |= b3 << 16;
      if (extra > 3) acc |= b4() << 24;
      ll = static_cast<long long>(static_cast<int32_t>(acc)) + 1;
    }
    const long long s = x + 1 + extra;
    e.in = 1 + extra + ll, e.out = ll, e.lit = s, e.off = 0;
    e.ok = ll >= 1 && s + ll <= csize;
    return e;
  }
  int hdr;
  if ((tag & 3) == 1) {         // copy-1
    e.out = (t6 & 7) + 4;
    e.off = ((tag >> 5) << 8) | b1;
    hdr = 2;
  } else if ((tag & 3) == 2) {  // copy-2
    e.out = t6 + 1;
    e.off = b1 | (b2 << 8);
    hdr = 3;
  } else {                      // copy-4
    e.out = t6 + 1;
    e.off = static_cast<int32_t>(b1 | (b2 << 8) | (b3 << 16) | (b4() << 24));
    hdr = 5;
  }
  e.in = hdr, e.lit = -1;
  e.ok = x + hdr <= csize && e.off > 0;
  return e;
}

__device__ __forceinline__ Elem element(const Words& src, long long x, long long csize) {
  return decode(src.get4(x), [&] { return src.getb(x + 4); }, x, csize);
}

// ... from a staged copy of the row (16-byte aligned, 0 past comp_cap up to
// wpad): where x + 4 < wpad the word reads are not clipped, so the five
// bytes at x are the element's.
__device__ __forceinline__ Elem element_staged(const Words& st, int x, long long csize) {
  if (x + 4 >= st.wpad) return element(st, x, csize);
  uint32_t lo, hi;
  lzp::bytes8(reinterpret_cast<const uint32_t*>(st.p), x, lo, hi);
  return decode(lo, [hi] { return hi & 0xFFu; }, x, csize);
}

// =================================================================== walk ==
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
snappy_walk_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes,
                   int batch, int comp_cap, uint8_t* __restrict__ out, int out_cap,
                   int32_t* __restrict__ out_sizes, int32_t* __restrict__ statuses) {
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint8_t* row = comp + static_cast<size_t>(chunk) * comp_cap;
  const Words src{row, comp_cap, (max(comp_cap, 8) + 3LL) / 4 * 4};
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const long long csize = comp_sizes[chunk];
  const Preamble pre = preamble(src, csize);
  bool err = pre.err;
  const bool too_big = !err && pre.expected > out_cap;

  // the elements decoded in place: element() gives the same fields, but in
  // 64 bits and with both tag words read, which costs the walk's one lane
  // about 15%
  long long ip = err ? csize : pre.len, op = 0;
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
      off = static_cast<int32_t>(b1 | (b2 << 8) | (b3 << 16) | (src.getb(ip + 4) << 24));
      hdr = 5;
    }
    err = ip + hdr > csize || off <= 0 || off > op;
    if (!err && op + ml <= out_cap)
      tpucomp::warp_match_copy(dst, op, static_cast<int>(off), ml, lane);
    ip += hdr;
    op += ml;
  }
  err = (err || op != min(max(pre.expected, 0LL), out_cap + 1LL)) && !too_big;
  const long long osz = (err || too_big) ? 0 : op;
  tpucomp::warp_fill(dst, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = static_cast<int32_t>(osz);
    statuses[chunk] = too_big ? kOutputTooSmall : (err ? kCannotDecompress : kSuccess);
  }
}

// ================================================================== parse ==
using lzp::kPThreads;
constexpr int kMaxOut = 65536;     // the largest out_cap the parse takes
constexpr int kMaxComp = 81920;    // the largest padded row (wpad) it takes
constexpr int kCWords = kMaxComp / 32;
constexpr int kBlk = 128;          // positions a block of the chain's leavers (4 words)
constexpr int kBlocks = kMaxComp / kBlk;
constexpr int kLongD = 15;         // d(x), 4 bits: 0 its check fails, 2-14 its length, 15 longer
constexpr int kNear = 128;         // E(x) >= kNear: the chain leaves x's block for blockend +
                                   // E(x) - kNear; below: an offset in the block (its leaver)
constexpr int kEBad = 255;         // E(x): the chain from x meets an element that fails its check
constexpr int kNoEntry = 0xFF;     // a block the chain does not enter
constexpr int kShortLit = 64;      // longer literals are copied by warps, in pieces
constexpr int kNoCode = -2, kLitCode = -1;  // an element's code: a copy's offset, kLitCode, none
constexpr int kPiece = 1024;       // bytes a piece
constexpr int kQueue = 1152;       // pieces: every literal longer than kShortLit, cut
static_assert(kMaxOut / (kShortLit + 1) + kMaxOut / kPiece <= kQueue, "the queue is too short");

// Shared memory, in bytes.  Phases 2-4: d (4 bits a position), E (a byte a
// position: where the chain from there leaves its block), the staged bytes
// and each block's entry; phase 5, over them: the source of each
// output byte (u16), the output window and the queue of long literals'
// pieces (op | (len - 1) << 17, s).  Past them, for every phase: the
// chain's elements (a bitmask over the positions; in phase 5, once read,
// the run start carried into each starts word), the scan scratch, the misc
// words and, for phase 5, the runs' output starts (a bitmask).
constexpr int kSD4 = 0;                              // u32 [kMaxComp / 8]
constexpr int kSE = kSD4 + kMaxComp / 2;             // u8 [kMaxComp]
constexpr int kSBytes = kSE + kMaxComp;              // u8 [kMaxComp + 16]
constexpr int kSEntry = kSBytes + kMaxComp + 16;     // u8 [kBlocks]
constexpr int kSSrc = 0;                             // u16 [kMaxOut]
constexpr int kSWin = 2 * kMaxOut;                   // u8 [kMaxOut]
constexpr int kSQueue = kSWin + kMaxOut;             // u32 [2][kQueue]
constexpr int kSMarks = kSQueue + 8 * kQueue;        // u32 [kCWords]
constexpr int kSScr = kSMarks + 4 * kCWords;         // long long [32]
constexpr int kSMisc = kSScr + 8 * 32;               // long long [8]
constexpr int kSStarts = kSMisc + 8 * 8;             // u32 [kMaxOut / 32]
constexpr int kSTotal = kSStarts + kMaxOut / 8;
static_assert(4 * kCWords >= 4 * (kMaxOut / 32), "the run carries do not fit over the marks");
static_assert(kSEntry + kBlocks <= kSMarks, "phases 2-4 overflow into the marks");
static_assert(kSBytes % 16 == 0 && kSMarks % 16 == 0 && kSScr % 8 == 0, "alignment");
static_assert(kSTotal <= lzp::kSmemMax, "more shared memory than a Hopper CTA may have");

enum PMisc { kEndPos = 0, kEndKind = 1, kTotal = 2, kTail = 3, kErr = 4, kQ = 5, kLast = 6 };

// The tail walk from x (>= wpad, < csize) with op bytes before it, as the
// walk does it (every element there depends on x & 3 alone): returns false
// at an error or once op passes cap1 = out_cap + 1, else true with op the
// total.  When a position's x & 3 comes round again, the elements since its
// last visit form a cycle that passed every check, and the cycles after it
// pass them too (a copy's offset against a larger op) as long as they end
// before csize and keep op <= cap1: those are skipped in one step.
__device__ __forceinline__ bool tail_walk(const Words& src, long long x, long long csize,
                                          long long cap1, long long& op) {
  long long seen_x[4] = {-1, -1, -1, -1}, seen_op[4] = {0, 0, 0, 0};
  bool skipped = false;
  while (x < csize) {
    if (op > cap1) return false;
    const int r = static_cast<int>(x & 3);
    if (!skipped && seen_x[r] >= 0) {
      const long long dx = x - seen_x[r], dop = op - seen_op[r];  // both >= 1
      const long long k = max(0LL, min((csize - x) / dx, (cap1 - op) / dop) - 1);
      x += k * dx;
      op += k * dop;
      skipped = true;
    }
    seen_x[r] = x;
    seen_op[r] = op;
    const Elem e = element(src, x, csize);
    if (!e.ok || (e.lit < 0 && e.off > op)) return false;
    x += e.in;
    op += e.out;
  }
  return true;
}

// The stream length of the element whose tag is at x in a staged copy of
// the row where its own check passes, else 0: element()'s in and ok, in 32
// bits where it can (a literal's length in 64).
__device__ __forceinline__ long long stream_len(const Words& st, int x, long long csize) {
  uint32_t w, b4;
  if (x + 4 < st.wpad) {
    uint32_t hi;
    lzp::bytes8(reinterpret_cast<const uint32_t*>(st.p), x, w, hi);
    b4 = hi & 0xFF;
  } else {
    w = st.get4(x), b4 = st.getb(x + 4);
  }
  const uint32_t tag = w & 0xFF, kind = tag & 3, t6 = tag >> 2;
  const long long room = csize - x;
  if (kind == 0) {  // 1 + extra + ll: ll = t6 + 1, or int32(the extra bytes) + 1 >= 1
    const int extra = min(max(static_cast<int>(t6) - 59, 0), 4);
    const uint32_t lenb = (w >> 8) | (b4 << 24);
    const uint32_t acc = extra == 0 ? t6 : extra == 4 ? lenb : lenb & ((1u << (8 * extra)) - 1u);
    if (acc >> 31) return 0;
    const long long in = 2 + extra + static_cast<long long>(acc);
    return in <= room ? in : 0;
  }
  const int hdr = kind == 1 ? 2 : kind == 2 ? 3 : 5;
  const uint32_t b1 = (w >> 8) & 0xFF;
  const bool off_ok = kind == 1   ? ((tag >> 5) | b1) != 0
                      : kind == 2 ? ((w >> 8) & 0xFFFF) != 0
                                  : static_cast<int32_t>((w >> 8) | (b4 << 24)) > 0;
  return hdr <= room && off_ok ? hdr : 0;
}

// n <= 64 bytes of the row from s to dst (shared memory): where the row is
// 4-byte aligned, 32 bytes a round trip as nine aligned words (the last
// word read through byte() where it passes the row), else byte by byte,
// 16 loads at a time.
__device__ __forceinline__ void copy_short(uint8_t* dst, const Words& src, long long s, int n) {
  if ((reinterpret_cast<uintptr_t>(src.p) & 3) == 0) {
    for (int i0 = 0; i0 < n; i0 += 32) {
      const long long a = (s + i0) & ~3LL;
      uint32_t w[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const long long j = a + 4 * k;
        w[k] = j + 3 < src.n ? __ldg(reinterpret_cast<const uint32_t*>(src.p + j))
                             : src.byte(j) | (src.byte(j + 1) << 8) | (src.byte(j + 2) << 16) |
                                   (src.byte(j + 3) << 24);
      }
      const int sh = 8 * static_cast<int>((s + i0) & 3), m = min(32, n - i0);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t v = __funnelshift_r(w[k], w[k + 1], sh);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * k + t < m) dst[i0 + 4 * k + t] = static_cast<uint8_t>(v >> (8 * t));
      }
    }
    return;
  }
  for (int i0 = 0; i0 < n; i0 += 16) {
    uint32_t v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = i0 + k < n ? src.byte(s + i0 + k) : 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (i0 + k < n) dst[i0 + k] = static_cast<uint8_t>(v[k]);
  }
}

// Element e at output offset o, phase 5, after the element whose code is
// prev (updated to e's): a run's start marked (a bit in starts, and in
// srcpos the distance of its bytes' sources: the copy's offset, 0 for a
// literal; a copy at the offset of the copy before it continues that one's
// run: one longer copy), a short literal's bytes (read through src) into
// the window, a long literal's pieces onto the queue.
__device__ __forceinline__ void place(const Elem& e, int o, int& prev, const Words& src,
                                      uint16_t* srcpos, uint32_t* starts, uint8_t* win,
                                      uint32_t* queue, long long* misc) {
  const int n = static_cast<int>(e.out);
  const int code = e.lit < 0 ? static_cast<int>(e.off) : kLitCode;
  if (code == kLitCode || code != prev) {
    atomicOr(starts + (o >> 5), 1u << (o & 31));
    srcpos[o] = static_cast<uint16_t>(e.lit < 0 ? e.off : 0);
  }
  prev = code;
  if (e.lit < 0) return;
  if (n <= kShortLit) {
    copy_short(win + o, src, e.lit, n);
    return;
  }
  const int np = (n + kPiece - 1) / kPiece;
  const int q = atomicAdd(reinterpret_cast<int*>(misc + kQ), np);
  for (int k = 0; k < np; ++k) {
    const int len = min(kPiece, n - k * kPiece);
    queue[q + k] = static_cast<uint32_t>(o + k * kPiece) | (static_cast<uint32_t>(len - 1) << 17);
    queue[kQueue + q + k] = static_cast<uint32_t>(e.lit + k * kPiece);
  }
}

// The row's bytes: o < n the window's byte at o's source, then 0; single
// bytes to a 16-byte boundary, then 16 bytes a store.
__device__ __forceinline__ void flush(uint8_t* orow, int out_cap, int n, const uint8_t* win,
                                      const uint16_t* srcpos, int tid) {
  auto val = [&](int o) { return o < n ? static_cast<uint32_t>(win[srcpos[o]]) : 0u; };
  const int a =
      min(out_cap, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(orow) & 15)) & 15));
  if (tid < a) orow[tid] = static_cast<uint8_t>(val(tid));
  const int n16 = (out_cap - a) >> 4;
  for (int i = tid; i < n16; i += kPThreads) {
    const int o = a + 16 * i;
    uint32_t w[4];
    if ((a & 7) == 0 && o + 16 <= n) {  // the 16 sources in two 16-byte loads
      const uint4 s0 = *reinterpret_cast<const uint4*>(srcpos + o);
      const uint4 s1 = *reinterpret_cast<const uint4*>(srcpos + o + 8);
      const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = win[sw[2 * k] & 0xFFFF] | (win[sw[2 * k] >> 16] << 8) |
               (win[sw[2 * k + 1] & 0xFFFF] << 16) | (win[sw[2 * k + 1] >> 16] << 24);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = val(o + 4 * k) | (val(o + 4 * k + 1) << 8) | (val(o + 4 * k + 2) << 16) |
               (val(o + 4 * k + 3) << 24);
    }
    *reinterpret_cast<uint4*>(orow + o) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int b = a + 16 * n16;
  if (tid < out_cap - b) orow[b + tid] = static_cast<uint8_t>(val(b + tid));
}

__global__ void __launch_bounds__(kPThreads, 1)
snappy_parse_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes,
                    int comp_cap, uint8_t* __restrict__ out, int out_cap,
                    int32_t* __restrict__ out_sizes, int32_t* __restrict__ statuses) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* d4 = reinterpret_cast<uint32_t*>(smem + kSD4);
  uint8_t* ex = smem + kSE;
  uint8_t* sbytes = smem + kSBytes;
  uint8_t* entry = smem + kSEntry;
  uint16_t* srcpos = reinterpret_cast<uint16_t*>(smem + kSSrc);
  uint8_t* win = smem + kSWin;
  uint32_t* queue = reinterpret_cast<uint32_t*>(smem + kSQueue);
  uint32_t* marks = reinterpret_cast<uint32_t*>(smem + kSMarks);
  long long* scr = reinterpret_cast<long long*>(smem + kSScr);
  long long* misc = reinterpret_cast<long long*>(smem + kSMisc);
  uint32_t* starts = reinterpret_cast<uint32_t*>(smem + kSStarts);
  const int chunk = blockIdx.x, tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const uint8_t* row = comp + static_cast<size_t>(chunk) * comp_cap;
  const long long wpad = (max(comp_cap, 8) + 3LL) / 4 * 4;
  const Words src{row, comp_cap, wpad};
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const long long csize = comp_sizes[chunk];

  // ---- 1: the preamble
  const Preamble pre = preamble(src, csize);
  if (pre.err || pre.expected > out_cap) {
    lzp::zero_bytes(dst, 0, out_cap, tid);
    if (tid == 0) {
      out_sizes[chunk] = 0;
      statuses[chunk] = pre.err ? kCannotDecompress : kOutputTooSmall;
    }
    return;
  }

  // ---- 2: stage the bytes [0, ns) (the elements before np read no
  // further; past comp_cap they are 0), then d(x) for every x in
  // [pre.len, np), eight positions a thread and a word, and E(x)'s start
  // (3a below)
  const int np = static_cast<int>(min(csize, wpad));
  const int ns = static_cast<int>(min(wpad, csize + 8));
  const int nb = (np + kBlk - 1) / kBlk;
  lzp::stage_bytes(sbytes, row, min(ns, comp_cap), comp_cap, tid);
  for (int i = tid; i < kCWords; i += kPThreads) marks[i] = 0;
  for (int i = tid; i < kBlocks; i += kPThreads) entry[i] = kNoEntry;
  if (tid < 8) misc[tid] = 0;
  __syncthreads();
  const Words staged{sbytes, min(ns, comp_cap), wpad};
  for (int g = tid; 8 * g < np; g += kPThreads) {
    uint32_t word = 0;
    for (int k = 0; k < 8; ++k) {
      const int x = 8 * g + k;
      if (x < pre.len || x >= np) continue;
      const long long len = stream_len(staged, x, csize);
      word |= (len >= kLongD ? kLongD : static_cast<uint32_t>(len)) << (4 * k);
      // E(x): a leaver's exit (near or not), else its next element
      const int b0 = x & ~(kBlk - 1), end = b0 + kBlk;
      const long long y = x + len;
      ex[x] = len == 0 ? kEBad
              : y >= np ? x - b0
              : y < end ? static_cast<int>(y) - b0
              : y - end < kEBad - kNear ? kNear + static_cast<int>(y - end) : x - b0;
    }
    d4[g] = word;
  }
  // next(x) from d: -1 where x fails its check
  auto next = [&](int x) {
    const int v = (d4[x >> 3] >> (4 * (x & 7))) & 15;
    if (v == 0) return -1;
    return x + (v == kLongD ? static_cast<int>(min(stream_len(staged, x, csize), 1LL << 30)) : v);
  };

  // ---- 3: the chain from pre.len.  a. E(x) for every x: where the chain
  // from x leaves x's block of kBlk positions, as kNear + the exit's
  // distance past the block's end, or, where that is far or at or past np,
  // as its leaver's offset (the leaver: the chain's last element in the
  // block; a leaver's own E is itself).  E starts as above (a position
  // whose next stays inside points to it), then E(x) = E(E(x)) while E(x)
  // points inside, six times (a block holds at most 64 elements); a read of
  // an E another thread is moving gives one or the other element of the
  // same chain, both right
  for (int r = 0; r < 6; ++r) {
    __syncthreads();
    for (int x = pre.len + tid; x < np; x += kPThreads) {
      const int v = ex[x];
      if (v < kNear) ex[x] = ex[(x & ~(kBlk - 1)) + v];
    }
  }
  __syncthreads();
  // b. one lane goes from block to block: each block's entry, and where the
  // chain ends (its last element in [0, np), or one that fails)
  if (tid == 0 && np > pre.len) {
    int e = pre.len, kind = 1;
    while (true) {
      const int b = e / kBlk;
      entry[b] = static_cast<uint8_t>(e - b * kBlk);
      const int v = ex[e];
      if (v >= kNear && v != kEBad) {  // a load and an add a block
        e = (b + 1) * kBlk + v - kNear;
        continue;
      }
      if (v == kEBad) {
        kind = 0;
        break;
      }
      const int y = b * kBlk + v, z = next(y);
      if (z >= np) {
        e = y;
        break;
      }
      e = z;
    }
    misc[kEndPos] = e;
    misc[kEndKind] = kind;
  }
  __syncthreads();
  // c. each entered block's elements marked by its thread (its own four
  // bitmask words)
  for (int b = tid; b < nb; b += kPThreads) {
    if (entry[b] == kNoEntry) continue;
    const int end = min((b + 1) * kBlk, np);
    uint64_t lo = 0, hi = 0;  // the block's 128 positions
    for (int y = b * kBlk + entry[b]; y < end;) {
      const int z = next(y);
      if (z < 0) break;
      const int bit = y - b * kBlk;
      if (bit < 64)
        lo |= 1ull << bit;
      else
        hi |= 1ull << (bit - 64);
      y = z;
    }
    uint32_t* mw = marks + b * (kBlk / 32);
    mw[0] = static_cast<uint32_t>(lo), mw[1] = static_cast<uint32_t>(lo >> 32);
    mw[2] = static_cast<uint32_t>(hi), mw[3] = static_cast<uint32_t>(hi >> 32);
  }
  __syncthreads();

  // ---- 4: thread tid's elements (bitmask words [w0, w1)): their output
  // lengths, the block scan, each copy's offset against op
  const int nw = (np + 31) >> 5;
  const int per = (nw + kPThreads - 1) / kPThreads;
  const int w0 = min(nw, tid * per), w1 = min(nw, w0 + per);
  long long mine = 0;
  for (int w = w0; w < w1; ++w)
    for (uint32_t b = marks[w]; b; b &= b - 1)
      mine += element_staged(staged, 32 * w + __ffs(b) - 1, csize).out;
  const long long before = lzp::block_scan_excl<long long>(
      mine, 0LL, [](long long a, long long b) { return a + b; }, scr, lane, wi);
  bool bad = false;
  long long op = before;
  int last = kNoCode;  // this thread's last element: a copy's offset, or kLitCode
  for (int w = w0; w < w1; ++w) {
    for (uint32_t b = marks[w]; b; b &= b - 1) {
      const Elem e = element_staged(staged, 32 * w + __ffs(b) - 1, csize);
      bad = bad || (e.lit < 0 && e.off > op);
      op += e.out;
      last = e.lit < 0 ? static_cast<int>(min(e.off, 1LL << 30)) : kLitCode;
    }
  }
  // the element before each thread's first: the last one of the threads
  // before it (phase 5 merges a copy into the one before at its offset)
  const int prev_code = lzp::block_scan_excl<int>(
      last, kNoCode, [](int a, int b) { return b != kNoCode ? b : a; },
      reinterpret_cast<int*>(scr), lane, wi);
  if (tid == kPThreads - 1) misc[kTotal] = op, misc[kLast] = last != kNoCode ? last : prev_code;
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    long long total = misc[kTotal];
    bool ok = !bad;
    misc[kTail] = -1;
    if (np > pre.len) {
      const int ep = static_cast<int>(misc[kEndPos]);
      if (misc[kEndKind] == 0) {
        ok = false;  // the chain reaches an element that fails its check
      } else {
        const long long y = ep + element(staged, ep, csize).in;
        if (ok && y < csize) {
          misc[kTail] = y;
          ok = tail_walk(staged, y, csize, out_cap + 1LL, total);
        }
      }
    }
    misc[kErr] = !(ok && total == pre.expected);
  }
  __syncthreads();
  const bool err = misc[kErr] != 0;
  if (tid == 0) {
    out_sizes[chunk] = err ? 0 : static_cast<int32_t>(pre.expected);
    statuses[chunk] = err ? kCannotDecompress : kSuccess;
  }
  if (err) {
    lzp::zero_bytes(dst, 0, out_cap, tid);
    return;
  }

  // ---- 5: the bytes (over the staged bytes: the elements are read again
  // from global memory).  Each element's start marked, the short literals'
  // bytes, the long ones' pieces queued
  const int n = static_cast<int>(pre.expected);
  const long long tail = misc[kTail], row_total = misc[kTotal];
  int prev = prev_code, tail_prev = static_cast<int>(misc[kLast]);
  for (int i = tid; i < kMaxOut / 32; i += kPThreads) starts[i] = 0;
  __syncthreads();
  op = before;
  {  // four elements' bytes loaded at a time
    int w = w0;
    uint32_t b = w < w1 ? marks[w] : 0u;
    while (true) {
      int xs[4], k = 0;
      for (; k < 4; ++k) {
        while (!b && ++w < w1) b = marks[w];
        if (!b) break;
        xs[k] = 32 * w + __ffs(b) - 1;
        b &= b - 1;
      }
      if (k == 0) break;
      uint32_t t4[4], b4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < k) t4[u] = src.get4(xs[u]), b4[u] = src.getb(xs[u] + 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u >= k) break;
        const uint32_t b = b4[u];
        const Elem e = decode(t4[u], [b] { return b; }, xs[u], csize);
        place(e, static_cast<int>(op), prev, src, srcpos, starts, win, queue, misc);
        op += e.out;
      }
    }
  }
  if (tid == 0 && tail >= 0) {  // the tail's elements (at most n bytes)
    long long x = tail, o = row_total;
    while (x < csize) {
      const Elem e = element(src, x, csize);
      place(e, static_cast<int>(o), tail_prev, src, srcpos, starts, win, queue, misc);
      x += e.in;
      o += e.out;
    }
  }
  __syncthreads();
  const int nq = static_cast<int>(misc[kQ]);
  for (int q = wi; q < nq; q += lzp::kPWarps) {  // a warp a piece
    const int o = static_cast<int>(queue[q] & 0x1FFFF), len = static_cast<int>(queue[q] >> 17) + 1;
    const int s = static_cast<int>(queue[kQueue + q]);
    for (int i = lane; i < len; i += 32) win[o + i] = static_cast<uint8_t>(src.byte(s + i));
  }
  // each output byte's source, from the last run start s0 at or before it
  // and its distance d: o for a literal's byte, s0 - d + (o - s0) mod d for
  // a copied one (a run is one copy, periodic where d is below its length).
  // a. The (s0, d) carried into each starts word (thread tid takes words 2
  // tid and 2 tid + 1; a scan carries the last run start's across threads),
  // over the marks, which phase 5 reads no more
  uint32_t* carry = marks;
  {
    const int w = 2 * tid;
    const uint32_t m0 = 64 * tid < n ? starts[w] : 0u, m1 = 64 * tid + 32 < n ? starts[w + 1] : 0u;
    const int x0 = m0 ? 32 * w + 31 - __clz(m0) : -1, x1 = m1 ? 32 * w + 63 - __clz(m1) : -1;
    const long long l0 = x0 >= 0 ? (static_cast<long long>(x0) << 16) | srcpos[x0] : -1;
    const long long l1 = x1 >= 0 ? (static_cast<long long>(x1) << 16) | srcpos[x1] : -1;
    const long long cur = lzp::block_scan_excl<long long>(
        l1 >= 0 ? l1 : l0, -1LL, [](long long a, long long b) { return b >= 0 ? b : a; }, scr,
        lane, wi);
    carry[w] = static_cast<uint32_t>(cur);
    carry[w + 1] = static_cast<uint32_t>(l0 >= 0 ? l0 : cur);
  }
  __syncthreads();
  // b. a warp a word, a lane a byte: the last run start in the word at or
  // before the lane (read by every lane before any writes), else the
  // word's carry
  for (int w = wi; 32 * w < n; w += lzp::kPWarps) {
    const int o = 32 * w + lane;
    const uint32_t mk = starts[w] & (0xFFFFFFFFu >> (31 - lane));
    const int s0 = mk ? 32 * w + 31 - __clz(mk) : static_cast<int>(carry[w] >> 16);
    const int d = mk ? srcpos[s0] : static_cast<int>(carry[w] & 0xFFFF);
    __syncwarp();
    if (o < ((n + 3) & ~3)) {  // the bytes past n in the last four: their own sources
      const int i = o - s0;
      const int r = i < d ? i : (d & (d - 1)) == 0 ? i & (d - 1) : i % d;
      srcpos[o] = static_cast<uint16_t>(o < n && d > 0 ? s0 - d + r : o);
    }
  }
  // pointer jumping: src = src[src] until every source is a literal's
  // byte (its own source), four bytes a step (bytes 4 q to 4 q + 3 for q =
  // tid + k * kPThreads); reads of a source another thread is moving give
  // one or the other ancestor, both right.  Bit k of done: those four have
  // their literals
  {
    uint2* s4 = reinterpret_cast<uint2*>(srcpos);
    const int nq4 = (n + 3) / 4;
    uint32_t done = 0;
    bool again = true;
    while (__syncthreads_or(again)) {
      again = false;
#pragma unroll 4
      for (int k = 0; k < kMaxOut / 4 / kPThreads; ++k) {
        const int qd = tid + k * kPThreads;
        if (((done >> k) & 1) || qd >= nq4) continue;
        const uint2 v = s4[qd];
        const uint32_t q0 = srcpos[v.x & 0xFFFF], q1 = srcpos[v.x >> 16];
        const uint32_t q2 = srcpos[v.y & 0xFFFF], q3 = srcpos[v.y >> 16];
        const uint2 nv = make_uint2(q0 | (q1 << 16), q2 | (q3 << 16));
        if (nv.x == v.x && nv.y == v.y) {
          done |= 1u << k;
        } else {
          s4[qd] = nv;
          again = true;
        }
      }
    }
  }
  flush(dst, out_cap, n, win, srcpos, tid);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).  comp uint8[B, comp_cap], comp_sizes int32[B], out uint8[B,
// out_cap], out_sizes and statuses int32[B].

// The walk: any shape.
extern "C" int tpucomp_snappy_decode_walk(const uint8_t* comp, const int32_t* comp_sizes,
                                          int batch, int comp_cap, uint8_t* out, int out_cap,
                                          int32_t* out_sizes, int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  snappy_walk_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, batch, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

// The parse: out_cap <= 65536 and round_up(max(comp_cap, 8), 4) <= 81920
// (ops/cuda/snappy_decode.py's parse_fits); other shapes are refused.

extern "C" int tpucomp_snappy_decode_parse(const uint8_t* comp, const int32_t* comp_sizes,
                                           int batch, int comp_cap, uint8_t* out, int out_cap,
                                           int32_t* out_sizes, int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  if (out_cap > kMaxOut || (max(comp_cap, 8) + 3) / 4 * 4 > kMaxComp)
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long raised = 0;  // one bit a device
  const cudaError_t e = lzp::raise_smem_limit(snappy_parse_kernel, kSTotal, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  snappy_parse_kernel<<<batch, kPThreads, kSTotal, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}
