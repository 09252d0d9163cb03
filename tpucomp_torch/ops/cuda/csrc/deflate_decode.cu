// Batched raw Deflate (RFC 1951) decode, one CTA of two warps per chunk.
//
// Replaces the TPU kernel tpucomp/ops/pallas/deflate_decode.py::_kernel
// (called by decompress_batch at deflate_decode.py:420).  That kernel walks
// one chunk per grid step on the scalar core: stateless 32-bit peeks at any
// bit position of the SMEM words, two-level canonical tables built per block
// in SMEM scratch (tpucomp/ops/pallas/huffman.py), and literals and copies as
// 128-byte VPU wild stores.  What it computes, and what this kernel
// computes, is the RFC 1951 block loop over [start, csize):
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
//  * tables: the classic inflate two-level tables (root 9 / 6 / 7 bits),
//    an incomplete code accepted until an uncovered slot is hit, an
//    over-subscribed code and a table past its `enough` bound (852 / 592 /
//    128 entries) errors;
//  * in the symbol loop an invalid code, bp past 8 * csize, or dist > op is
//    an error; a literal or match past out_cap is not written but op still
//    advances; the status is too_big = !err && op > out_cap, and an error
//    wins over too_big;
//  * bits are read LSB-first from the row; bytes at and past comp_cap read
//    as 0.
// An error settles the status, so the walk stops at the first one (the
// reference walks on without effect).  The plain version is
// tpucomp_torch/ops/cuda/deflate_decode.py::_decode_chunk.
//
// Bound: bytes.  A call must read each compressed byte once and write each
// output byte once (B x out_cap, the zero tail included).  What holds a
// chunk back is its serial symbol walk, so the design takes everything else
// off the walk and makes the walk itself short:
//  * Roles.  Warp 0 decodes: every lane walks the same stream in step (the
//    same loads and stores, so no lane waits on another's branch), and the
//    lanes part only to build the tables.  It writes literal bytes into an
//    output window in shared memory and each match as a record (op, length,
//    distance) into a ring of 128; warp 1 executes the records.  The two are
//    paced by counters in shared memory (st.release / ld.acquire at CTA
//    scope, published every 8 records and before any wait; the waits are
//    out of line, so the symbol loop holds no waiting loop).
//  * Bit reader in registers: a 64-bit buffer topped up 32 bits at a time
//    from aligned words of the row, the next word loaded one word ahead
//    with __ldg; bytes past comp_cap come in as 0 at the row's edge (out of
//    line), not at every peek.  A literal's successor is looked up before
//    the literal is stored; a match tests every rare case (a bad distance
//    code, dist > op, bp > nbits, out_cap, a full ring) in one branch.
//  * Tables built by the warp: lanes zero them, count the lengths and place
//    every code of at most `root` bits (its canonical code from the
//    counts); lane 0 keeps the count pass and the subtable layout of the
//    longer codes, the reference's loop unchanged.  Leaves carry the length
//    or distance base and extra-bit count, so a match makes no table lookup
//    beyond the two codes.  A run of fixed blocks builds once.
//  * Output window: 32 KiB of history (every Deflate distance) plus a
//    2 KiB segment, 34 KiB as a ring, with byte v at slot v mod 34816 where
//    v = op + (row address mod 16).  Matches copy shared to shared, every
//    byte from the period [op - dist, op) (each lane's phase by a multiply,
//    kPhase), so no step waits for another; four short matches whose
//    periods lie before the first go at once, eight lanes each.  The
//    executor flushes whole segments to the row with 16-byte stores and
//    writes the zero tail the same way.  The decoder writes a literal at op
//    only while op < front + 2 KiB, where front is what the executor has
//    finished: the bytes it overwrites are flushed and no record still reads
//    them.
//  * Once op passes out_cap the row can only end all zeros (status 15, or
//    12 if an error comes later), so the decoder stops writing and walks on
//    for the status alone; the executor zero-fills the row at the end.
//  * Occupancy: 43,888 bytes of static shared memory and 64 threads a CTA,
//    with the shared-memory carveout at its maximum: 5 CTAs an SM (228 KB
//    less 1 KB a CTA), 660 chunks at once on 132 SMs.  chip_smoke.py prints
//    the registers, spills and the CTAs an SM that
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives
//    (tpucomp_deflate_decode_info).
// What is left, measured on an H100 80GB HBM3 at 700 W (PERF.md, row 9):
// the walk costs about 170 cycles a literal and 500 a match, almost all of
// it the issue latency of one dependent instruction stream; a chunk of
// 15,000 matches takes 4.5 ms alone, and bounds the call.
// The executor writes every byte of the output row (decoded bytes, then
// zeros), so the caller's buffer needs no clearing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
constexpr int kThreads = 64;       // warp 0 decodes, warp 1 executes
constexpr int kLitRoot = 9;
constexpr int kDistRoot = 6;
constexpr int kClRoot = 7;
constexpr int kEnoughLit = 852;    // proven bound for 288 symbols, 9-bit root
constexpr int kEnoughDist = 592;   // proven bound for 32 symbols, 6-bit root
constexpr int kTabDist = kEnoughLit;
constexpr uint32_t kSeg = 2048;            // flush unit, and the decoder's lead
constexpr uint32_t kWin = 32768 + kSeg;    // the window ring (a multiple of kSeg)
constexpr uint32_t kRing = 128;            // match records in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSaturate = 0xF0000000u;  // op once past out_cap (> any out_cap)

// Table entries: bits 0-3 the code's whole length (0: an uncovered slot),
// 4-7 the extra-bit count (a link: the subtable's index bits), 8-10 the
// kind, 11 a link, 16-31 the value (literal byte or symbol, length or
// distance base; a link: the subtable's offset).
constexpr uint32_t kLit = 1u << 8, kLen = 2u << 8, kEob = 3u << 8, kBad = 4u << 8;
constexpr uint32_t kKind = 7u << 8, kLink = 1u << 11;
enum { kTabLit, kTabDst, kTabCl };

// Records from the decoder to the executor: {kind, op, a, b}.
enum { kRecMatch, kRecStored, kRecMark, kRecEnd };  // a, b: length, distance /
                                                    // length, source byte /
                                                    // - / status
enum { kActEnd, kActNext, kActFixed, kActDynamic };  // what a block header asks of warp 0
enum { kSymEob, kSymErr, kSymOverflow };             // how a symbol loop ended

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
// ceil(1024 / d): (x * kPhase[d]) >> 10 == x / d for 0 <= x <= 32, 1 <= d < 32
// (kPhase[0] = 0 stands for distances of 32 and more).
__constant__ uint32_t kPhase[32] = {0,  1024, 512, 342, 256, 205, 171, 147, 128, 114, 103,
                                    94, 86,   79,  74,  69,  64,  61,  57,  54,  52,  49,
                                    47, 45,   43,  41,  40,  38,  37,  36,  35,  34};

struct __align__(16) Shared {
  uint8_t win[kWin];                       // the output window (a ring)
  int4 ring[kRing];                        // match records
  uint32_t tab[kEnoughLit + kEnoughDist];  // literal/length, then distance (or code-length)
  uint16_t work[320];                      // symbols in canonical order
  uint8_t lens[320];                       // code lengths (distance lengths at 288)
  int cnt[16], ofs[16], first[16], run[16];
  int maxl, bad;                           // a build's longest length and its error
  uint32_t wr, rd, front;                  // records written, records taken, executor's progress
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(smem(p)), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];" : "=r"(v) : "r"(smem(p)) : "memory");
  return v;
}
// The same for a whole warp in step: every lane takes lane 0's reading.
__device__ __forceinline__ uint32_t ld_acquire_warp(const uint32_t* p) {
  return __shfl_sync(kFull, ld_acquire(p), 0);
}

// The 4 bytes at row offset off, 0 outside [0, cap): the row's edges, out of
// line.
__device__ __noinline__ uint32_t edge_word(const uint8_t* row, uint32_t cap, long long off) {
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k) {
    const long long j = off + k;
    if (j >= 0 && j < cap) w |= static_cast<uint32_t>(row[j]) << (8 * k);
  }
  return w;
}

// The compressed row as a bit stream, LSB first: bytes at and past comp_cap
// read as 0.  buf holds cnt valid bits (the bits above them are 0); 32-bit
// words come from 4-byte aligned addresses, the next one (nxt, at row offset
// woff) loaded one word ahead with one __ldg.
struct Reader {
  const uint8_t* row;
  uint32_t cap;             // comp_cap
  long long nbits;          // 8 * csize
  uint64_t buf;
  int cnt;
  int over;                 // bits appended past nbits: bp > nbits <=> over > cnt
  uint32_t nxt;             // the word at row offset woff
  long long woff;

  __device__ __forceinline__ uint32_t word(long long off) const {
    return off >= 0 && off + 4 <= cap ? __ldg(reinterpret_cast<const uint32_t*>(row + off))
                                      : edge_word(row, cap, off);
  }
  // over = 8 * woff - nbits, clamped: exact at each 256 bytes, + 32 a word
  __device__ __forceinline__ void exact_over() {
    const long long o = woff * 8 - nbits;
    over = o > (1 << 30) ? (1 << 30) : o < -(1 << 30) ? -(1 << 30) : static_cast<int>(o);
  }
  // cnt < 32: 32 more bits.
  __device__ __forceinline__ void refill() {
    buf |= static_cast<uint64_t>(nxt) << cnt;
    cnt += 32;
    woff += 4;
    nxt = word(woff);
    over += 32;
    if (__builtin_expect((woff & 255) == 0, 0)) exact_over();
  }
  // The same where cnt < 32, else nothing.
  __device__ __forceinline__ void top_up() {
    if (cnt < 32) refill();
  }
  // bp = 8 * p; then cnt >= 32.
  __device__ __forceinline__ void seek(uint32_t p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row) + p;
    woff = static_cast<long long>(p) - static_cast<long long>(a & 3);
    nxt = word(woff);
    exact_over();
    buf = 0;
    cnt = 0;
    refill();
    skip(static_cast<int>(a & 3) * 8);
    if (cnt < 32) refill();
  }
  __device__ __forceinline__ uint32_t peek(int n) const {
    return static_cast<uint32_t>(buf) & ((1u << n) - 1u);
  }
  __device__ __forceinline__ void skip(int n) {
    buf >>= n;
    cnt -= n;
  }
  __device__ __forceinline__ bool past() const { return over > cnt; }  // bp > nbits
  __device__ __forceinline__ long long bit_pos() const { return woff * 8 - cnt; }  // bp
};

// The decoding warp's state (every lane holds the same).
struct Dec {
  Reader in;
  long long csize;
  uint32_t op;        // output position
  int wofs;           // op's window slot is op + wofs while op < lim
  uint32_t out_cap;
  uint32_t lim;       // literals below lim may be written now
  uint32_t wr, wr_lim;  // records written; the ring is full at wr_lim (as last seen)
  int hlit, hdist;
  bool write;         // false once op has passed out_cap: the status alone is left
  bool err, done;
};

__device__ __forceinline__ uint32_t saturate(uint32_t op) { return op < kSaturate ? op : kSaturate; }

__device__ __forceinline__ void publish(Shared& s, const Dec& d) { st_release(&s.wr, d.wr); }

// The same where wr is a multiple of 8, without a branch.
__device__ __forceinline__ void publish8(Shared& s, const Dec& d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %2, 0;\n @p st.release.cta.shared.u32 [%0], %1;\n}"
      ::"r"(smem(&s.wr)), "r"(d.wr), "r"(d.wr & 7) : "memory");
}

// Out of line, so the symbol loop holds no waiting loop: publish wr and wait
// until the ring has room; returns the new full mark.
__device__ __noinline__ uint32_t wait_ring(Shared& s, uint32_t wr) {
  st_release(&s.wr, wr);
  uint32_t rd = ld_acquire_warp(&s.rd);
  while (wr - rd >= kRing) {
    __nanosleep(32);
    rd = ld_acquire_warp(&s.rd);
  }
  return rd + kRing;
}

// The same for the window: wait until op < front + kSeg; returns front.
__device__ __noinline__ uint32_t wait_front(Shared& s, uint32_t op) {
  uint32_t f = ld_acquire_warp(&s.front);
  while (op >= f + kSeg) {
    __nanosleep(32);
    f = ld_acquire_warp(&s.front);
  }
  return f;
}

// One record into a ring with room; published in groups of 8.
__device__ __forceinline__ void put(Shared& s, Dec& d, int kind, uint32_t op, uint32_t a,
                                    uint32_t b) {
  s.ring[d.wr % kRing] = make_int4(kind, static_cast<int>(op), static_cast<int>(a),
                                   static_cast<int>(b));
  ++d.wr;
  publish8(s, d);
}

// The same, waiting for room first.
__device__ __forceinline__ void emit(Shared& s, Dec& d, int kind, uint32_t op, uint32_t a,
                                     uint32_t b) {
  if (d.wr == d.wr_lim) d.wr_lim = wait_ring(s, d.wr);
  put(s, d, kind, op, a, b);
}

// A literal at op >= lim: false once op reaches out_cap (the literal is not
// written), else moves the slot past the ring's end and waits until the
// window has room.
__device__ __forceinline__ bool make_room(Shared& s, Dec& d) {
  if (d.op >= d.out_cap) return false;
  const int v = static_cast<int>(d.op) + d.wofs;
  if (v >= static_cast<int>(kWin)) d.wofs -= static_cast<int>(kWin) * (v / static_cast<int>(kWin));
  uint32_t f = ld_acquire_warp(&s.front);
  if (d.op >= f + kSeg) {
    emit(s, d, kRecMark, d.op, 0, 0);  // the executor learns how far the literals reach
    publish(s, d);
    f = wait_front(s, d.op);
  }
  d.lim = min(min(d.out_cap, f + kSeg), static_cast<uint32_t>(static_cast<int>(kWin) - d.wofs));
  return true;
}

// The symbols of one Huffman block (the whole warp 0, in step).  kWrite:
// literals and match records go out; returns kSymOverflow (op already
// advanced) when one does not fit out_cap.  Otherwise only op is kept, for
// dist > op and the status.  Each literal's successor is looked up before
// the literal is stored, and each match's successor before the top-up.  The
// reference's bp > nbits check after a length code moves to after the
// match: nothing the walk does in between is seen when the status is an
// error.
template <bool kWrite>
__device__ __forceinline__ int symbols(Shared& s, Dec& d) {
  Reader& in = d.in;
  const uint32_t* lt = s.tab;
  const uint32_t* dt = s.tab + kTabDist;
  in.top_up();
  uint32_t e = lt[static_cast<uint32_t>(in.buf) & ((1u << kLitRoot) - 1)];
  for (;;) {  // cnt >= 32 here
#pragma unroll 2
    while ((e & (kKind | kLink)) == kLit) {
      in.skip(e & 15);
      const uint32_t en = lt[static_cast<uint32_t>(in.buf) & ((1u << kLitRoot) - 1)];
      if (kWrite) {
        if (__builtin_expect(d.op >= d.lim, 0) && !make_room(s, d)) {
          ++d.op;
          return kSymOverflow;
        }
        s.win[static_cast<int>(d.op) + d.wofs] = static_cast<uint8_t>(e >> 16);
        ++d.op;
      } else {
        d.op = saturate(d.op + 1);
      }
      if (__builtin_expect(in.past(), 0)) return kSymErr;
      in.top_up();
      e = en;
    }
    if (e & kLink) {  // the leaf in the subtable
      e = lt[(e >> 16) +
             (static_cast<uint32_t>(in.buf >> kLitRoot) & ((1u << ((e >> 4) & 15)) - 1))];
      continue;
    }
    const int nb = e & 15;
    if ((e & kKind) != kLen) {  // end of block, an uncovered slot, 286/287
      in.skip(nb);
      return (e & kKind) == kEob && !in.past() ? kSymEob : kSymErr;
    }
    const int lx = (e >> 4) & 15;
    const uint32_t mlen = (e >> 16) + (static_cast<uint32_t>(in.buf >> nb) & ((1u << lx) - 1));
    in.skip(nb + lx);
    uint32_t e2 = dt[static_cast<uint32_t>(in.buf) & ((1u << kDistRoot) - 1)];
    in.top_up();  // a distance code and its extra bits: 28
    const uint32_t i2 = (e2 >> 16) + (static_cast<uint32_t>(in.buf >> kDistRoot) &
                                      ((1u << ((e2 >> 4) & 15)) - 1));
    e2 = e2 & kLink ? dt[i2] : e2;
    const int dn = e2 & 15, dx = (e2 >> 4) & 15;
    const uint32_t dist = (e2 >> 16) + (static_cast<uint32_t>(in.buf >> dn) & ((1u << dx) - 1));
    in.skip(dn + dx);
    // one test for every rare case: a bad distance code (an uncovered slot,
    // 30/31), dist > op, bp > nbits, the output past out_cap, a full ring
    if (__builtin_expect(((e2 & kKind) != kLen) | (dist > d.op) | in.past() |
                             (kWrite && ((d.op + mlen > d.out_cap) | (d.wr == d.wr_lim))),
                         0)) {
      if ((e2 & kKind) != kLen || dist > d.op || in.past()) return kSymErr;
      if (d.op + mlen > d.out_cap) {
        d.op += mlen;
        return kSymOverflow;
      }
      d.wr_lim = wait_ring(s, d.wr);
    }
    if (kWrite) {
      put(s, d, kRecMatch, d.op, mlen, dist);
      d.op += mlen;
    } else {
      d.op = saturate(d.op + mlen);
    }
    // the next code's root entry, looked up before the top-up where its 9
    // bits are already in the buffer (the top-up only adds bits above)
    e = lt[static_cast<uint32_t>(in.buf) & ((1u << kLitRoot) - 1)];
    const bool short_root = in.cnt < kLitRoot;
    in.top_up();
    if (__builtin_expect(short_root, 0)) e = lt[static_cast<uint32_t>(in.buf) & ((1u << kLitRoot) - 1)];
  }
}

// A block header: returns what warp 0 does next.  A stored block
// is handled here whole (a record for the executor); a dynamic header leaves
// the code-length code's lengths in lens[0, 19).
__device__ __forceinline__ int block_head(Shared& s, Dec& d) {
  Reader& in = d.in;
  if (d.err || d.done || in.over + 3 > in.cnt) return kActEnd;  // !(bp + 3 <= nbits)
  if (in.cnt < 32) in.refill();
  d.done = (in.buf & 1) != 0;
  const int btype = static_cast<int>(in.buf >> 1) & 3;
  in.skip(3);
  if (btype == 0) {  // stored
    in.skip(in.cnt & 7);
    if (in.cnt < 32) in.refill();
    const long long src = in.bit_pos() >> 3;
    const uint32_t ln = in.peek(16), nlen = static_cast<uint32_t>(in.buf >> 16) & 0xFFFF;
    d.err = src + 4 + ln > d.csize || (ln ^ nlen) != 0xFFFF;
    if (d.err) return kActEnd;
    if (d.write && d.op + ln <= d.out_cap) {
      if (ln > 0) emit(s, d, kRecStored, d.op, ln, static_cast<uint32_t>(src + 4));
      d.op += ln;
    } else {
      d.write = false;
      d.op = saturate(d.op + ln);
    }
    in.seek(static_cast<uint32_t>(src + 4 + ln));
    d.err = in.past();
    return kActNext;
  }
  if (btype == 3) {
    d.err = true;
    return kActEnd;
  }
  if (btype == 1) return kActFixed;
  d.hlit = static_cast<int>(in.peek(5)) + 257;
  d.hdist = static_cast<int>(in.buf >> 5 & 31) + 1;
  const int hclen = static_cast<int>(in.buf >> 10 & 15) + 4;
  in.skip(14);
  if (d.hlit > 286 || d.hdist > 30) {
    d.err = true;
    return kActEnd;
  }
  for (int i = 0; i < 19; ++i) s.lens[i] = 0;
  for (int i = 0; i < hclen; ++i) {
    if (in.cnt < 3) in.refill();
    s.lens[kClOrder[i]] = static_cast<uint8_t>(in.peek(3));
    in.skip(3);
  }
  return kActDynamic;
}

// The HLIT + HDIST code lengths through the code-length table; true on error.
__device__ __forceinline__ bool read_lengths(Shared& s, Dec& d) {
  Reader& in = d.in;
  const uint32_t* ct = s.tab + kTabDist;
  const int n = d.hlit + d.hdist;
  int i = 0, prev = 0;
  while (i < n) {
    if (in.cnt < 32) in.refill();
    const uint32_t e = ct[in.buf & ((1u << kClRoot) - 1)];
    in.skip(e & 15);
    if ((e & 15) == 0 || in.past()) return true;
    const int sym = static_cast<int>(e >> 16);
    if (sym < 16) {
      s.lens[i++] = static_cast<uint8_t>(prev = sym);
      continue;
    }
    const int nb2 = sym == 16 ? 2 : sym == 17 ? 3 : 7;
    const int rep = (sym == 18 ? 11 : 3) + static_cast<int>(in.peek(nb2));
    in.skip(nb2);
    const int val = sym == 16 ? prev : 0;
    if ((sym == 16 && i == 0) || i + rep > n) return true;
    for (int k = 0; k < rep; ++k) s.lens[i + k] = static_cast<uint8_t>(val);
    i += rep;
    prev = val;
  }
  return false;
}

__device__ __forceinline__ uint32_t leaf(int kind, int sym, int ln) {
  const uint32_t l = static_cast<uint32_t>(ln);
  if (kind == kTabCl) return (static_cast<uint32_t>(sym) << 16) | kLit | l;
  if (kind == kTabDst)
    return sym < 30 ? (static_cast<uint32_t>(kDistBase[sym]) << 16) | kLen |
                          (static_cast<uint32_t>(kDistExtra[sym]) << 4) | l
                    : kBad | l;
  if (sym < 256) return (static_cast<uint32_t>(sym) << 16) | kLit | l;
  if (sym == 256) return kEob | l;
  if (sym < 286)
    return (static_cast<uint32_t>(kLenBase[sym - 257]) << 16) | kLen |
           (static_cast<uint32_t>(kLenExtra[sym - 257]) << 4) | l;
  return kBad | l;
}

// Lane 0: the codes longer than root, in canonical order from the first
// one, with the reference's subtable loop (csrc/huffman.cuh::build_table
// from that point: the same openings, sizes and `enough` check).
__device__ __forceinline__ bool long_codes(Shared& s, uint32_t* tab, int base, int root, int enough, int kind,
                           int maxl) {
  int ln = root + 1;
  while (s.cnt[ln] == 0) ++ln;
  int k = s.ofs[ln];
  int huff = static_cast<int>(__brev(static_cast<uint32_t>(s.first[ln])) >> (32 - ln));
  const int mask = (1 << root) - 1;
  int nxt = 0, curr = root, drop = 0, low = -1, used = 1 << root;
  while (ln <= maxl) {
    if ((huff & mask) != low) {
      drop = root;
      nxt += 1 << curr;
      curr = ln - drop;
      int lft = 1 << curr;
      while (curr + drop < maxl && lft > 0) {  // grow until the rest fits
        lft -= s.cnt[curr + drop];
        if (lft > 0) {
          ++curr;
          lft <<= 1;
        }
      }
      used += 1 << curr;
      if (used > enough) return true;
      low = huff & mask;
      tab[low] = kLink | (static_cast<uint32_t>(nxt) << 16) | (static_cast<uint32_t>(curr) << 4);
    }
    const uint32_t e = leaf(kind, s.work[k], ln);
    const int incr = 1 << (ln - drop);
    const int hofs = nxt + (huff >> drop);
    for (int f = (1 << curr) - incr; f >= 0; f -= incr)
      if (hofs + f < enough) tab[hofs + f] = e;  // only bounds the store
    int inc = 1 << (ln - 1);  // huff += 1, bit-reversed at width ln
    while (huff & inc) inc >>= 1;
    huff = inc ? (huff & (inc - 1)) + inc : 0;
    ++k;
    if (--s.cnt[ln] == 0) ln = ln == maxl ? 16 : s.lens[base + s.work[k]];
  }
  return false;
}

// The decode table of lens[base, base + nsym) into tab[tbase, tbase +
// enough), built by the whole warp 0; true on error (uniform).
__device__ __forceinline__ bool build(Shared& s, int base, int nsym, int root, int tbase, int enough, int kind,
                      int lane) {
  uint32_t* tab = s.tab + tbase;
  for (int i = lane; i < enough; i += 32) tab[i] = 0;
  if (lane < 16) s.cnt[lane] = 0;
  __syncwarp();
  for (int i = lane; i < nsym; i += 32) atomicAdd(&s.cnt[s.lens[base + i]], 1);
  __syncwarp();
  if (lane == 0) {  // the count and offset pass
    int left = 1, maxl = 0, ofs = 0, code = 0;
    bool err = false;
    for (int l = 1; l < 16; ++l) {
      const int c = s.cnt[l];
      if (c > 0) maxl = l;
      left = (left << 1) - c;
      err = err || left < 0;
      code = (code + (l > 1 ? s.cnt[l - 1] : 0)) << 1;
      s.first[l] = code;
      s.ofs[l] = s.run[l] = ofs;
      ofs += c;
    }
    s.maxl = maxl;
    s.bad = err;
  }
  __syncwarp();
  const int maxl = s.maxl;
  if (maxl == 0 || s.bad) return s.bad != 0;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < nsym; c += 32) {  // canonical positions; codes of <= root bits
    const int i = c + lane;
    const int l = i < nsym ? s.lens[base + i] : 0;
    const unsigned peers = __match_any_sync(kFull, l);
    if (l > 0) {
      const int pos = s.run[l] + __popc(peers & below);
      s.work[pos] = static_cast<uint16_t>(i);
      if (l <= root) {
        const uint32_t code = static_cast<uint32_t>(s.first[l] + pos - s.ofs[l]);
        const uint32_t e = leaf(kind, i, l);
        for (uint32_t f = __brev(code) >> (32 - l); f < (1u << root); f += 1u << l) tab[f] = e;
      }
    }
    __syncwarp();
    if (l > 0 && (peers & below) == 0) s.run[l] += __popc(peers);
    __syncwarp();
  }
  int err = 0;
  if (maxl > root && lane == 0) err = long_codes(s, tab, base, root, enough, kind, maxl);
  err = __shfl_sync(kFull, err, 0);
  __syncwarp();
  return err != 0;
}

// Warp 0: the block loop.  Every lane walks the same stream in step (the
// same loads, the same stores: no lane waits on another's branch); the lanes
// part only to build the tables.
__device__ __forceinline__ void decoder_warp(Shared& s, const uint8_t* row, uint32_t comp_cap,
                                             long long csize, long long start, uint32_t out_cap,
                                             uint32_t g, int lane) {
  Dec d;
  d.csize = csize;
  d.op = 0;
  d.wofs = static_cast<int>(g);
  d.out_cap = out_cap;
  d.lim = 0;
  d.wr = 0;
  d.wr_lim = kRing;
  d.write = true;
  d.err = csize <= start;
  d.done = false;
  d.in.row = row;
  d.in.cap = comp_cap;
  d.in.nbits = csize * 8;
  if (!d.err) d.in.seek(static_cast<uint32_t>(start));
  bool fixed_ready = false;  // the tables hold the fixed code
  for (;;) {
    __syncwarp();
    const int act = block_head(s, d);
    if (act == kActEnd) break;
    if (act == kActNext) continue;
    bool bad = false;
    __syncwarp();
    if (act == kActFixed) {
      if (!fixed_ready) {
        for (int i = lane; i < 320; i += 32)
          s.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
        __syncwarp();
        build(s, 0, 288, kLitRoot, 0, kEnoughLit, kTabLit, lane);
        build(s, 288, 32, kDistRoot, kTabDist, kEnoughDist, kTabDst, lane);
        fixed_ready = true;
      }
    } else {
      fixed_ready = false;
      bad = build(s, 0, 19, kClRoot, kTabDist, 128, kTabCl, lane) || read_lengths(s, d);
      if (!bad) {  // the distance lengths move to 288; the rest is zeroed
        __syncwarp();
        const int v = lane < d.hdist ? s.lens[d.hlit + lane] : 0;
        __syncwarp();
        s.lens[288 + lane] = static_cast<uint8_t>(v);
        for (int k = d.hlit + lane; k < 288; k += 32) s.lens[k] = 0;
        __syncwarp();
        bad = build(s, 0, 288, kLitRoot, 0, kEnoughLit, kTabLit, lane) ||
              build(s, 288, 32, kDistRoot, kTabDist, kEnoughDist, kTabDst, lane);
      }
    }
    if (bad) {
      d.err = true;
    } else {
      int r = kSymOverflow;
      if (d.write) r = symbols<true>(s, d);
      if (r == kSymOverflow) {
        d.write = false;
        d.op = saturate(d.op);
        r = symbols<false>(s, d);
      }
      d.err = r == kSymErr;
    }
    d.err = d.err || d.in.past();  // the block's end: bp > nbits
  }
  d.err = d.err || !d.done;
  const bool too_big = !d.err && d.op > d.out_cap;
  const int status = d.err ? kCannotDecompress : too_big ? kOutputTooSmall : kSuccess;
  emit(s, d, kRecEnd, d.op, static_cast<uint32_t>(status), 0);
  publish(s, d);
}

// dstv[v] = zero ? 0 : the window's byte v, for va <= v < vb (less than one
// ring apart): 16-byte stores where a whole aligned unit lies inside.
__device__ __forceinline__ void flush(const uint8_t* win, uint8_t* dstv, uint32_t va, uint32_t vb,
                                      bool zero, int lane) {
  for (uint32_t u = (va >> 4) + lane; u < (vb + 15) >> 4; u += 32) {
    const uint32_t lo = u << 4;
    const uint32_t slot = lo % kWin;  // kWin is a multiple of 16
    if (lo >= va && lo + 16 <= vb) {
      const uint4 x = zero ? make_uint4(0, 0, 0, 0) : *reinterpret_cast<const uint4*>(win + slot);
      *reinterpret_cast<uint4*>(dstv + lo) = x;
    } else {
      const uint32_t hi = min(lo + 16, vb);
      for (uint32_t v = max(lo, va); v < hi; ++v) dstv[v] = zero ? 0 : win[slot + (v - lo)];
    }
  }
  __syncwarp();
}

__device__ __forceinline__ uint32_t wrap(uint32_t x) { return x >= kWin ? x - kWin : x; }

// win[d0 + j] = win[d0 + j - dist] for 0 <= j < mlen, slots wrapping: every
// byte comes from the period [s0, s0 + dist), written before the match, so
// no step waits for another: byte j is the period's byte j mod dist (each
// lane's phase by a multiply, kPhase, where dist < 32).
__device__ __forceinline__ void match_copy(uint8_t* win, uint32_t d0, uint32_t dist,
                                           uint32_t mlen, uint32_t lane) {
  const uint32_t s0 = d0 >= dist ? d0 - dist : d0 + kWin - dist;
  const uint32_t m = kPhase[dist < 32 ? dist : 0];  // 0 from 32 on: r = lane, step 32
  uint32_t r = lane - dist * ((lane * m) >> 10);
  const uint32_t step = 32 - dist * ((32 * m) >> 10);
  if (__builtin_expect(mlen <= 32, 1)) {
    if (lane < mlen) win[wrap(d0 + lane)] = win[wrap(s0 + r)];
    return;
  }
  for (uint32_t j0 = 0; j0 < mlen; j0 += 128) {
    uint8_t x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[t] = win[wrap(s0 + r)];
      r += step;
      if (r >= dist) r -= dist;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t j = j0 + 32 * t + lane;
      if (j < mlen) win[wrap(d0 + j)] = x[t];
    }
  }
}

// Warp 1: executes the records, flushes the window to the row, writes the
// zero tail, the size and the status.
__device__ __forceinline__ void executor_warp(Shared& s, const uint8_t* row, uint32_t comp_cap,
                                              long long csize, long long start, uint8_t* dst,
                                              uint32_t out_cap, uint32_t g, uint32_t lane,
                                              int32_t* osz, int32_t* status) {
  {  // the compressed row into L2 ahead of lane 0's reads
    const long long hi = csize < comp_cap ? csize : comp_cap;
    const long long lo = start > 0 ? start & ~127LL : 0;
    for (long long o = lo + 128LL * lane; o < hi; o += 128LL * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + o));
  }
  uint8_t* dstv = dst - g;  // 16-byte aligned: row byte op is dstv[op + g]
  uint32_t rd = 0, n = 0, flushed = g, front = 0, told = 0;
  for (;;) {
    if (rd == n) {  // publish progress, then wait for more records
      __syncwarp();  // every lane's reads of the window are done
      st_release(&s.front, front);
      st_release(&s.rd, rd);
      told = rd;
      n = ld_acquire_warp(&s.wr);
      while (n == rd) {
        __nanosleep(20);
        n = ld_acquire_warp(&s.wr);
      }
    }
    if (n - rd >= 4) {  // four short matches whose periods lie before the first: at once
      const uint32_t sub = lane & 7;
      const int4 q = s.ring[(rd + (lane >> 3)) % kRing];
      const uint32_t qo = static_cast<uint32_t>(q.y), ql = static_cast<uint32_t>(q.z),
                     qd = static_cast<uint32_t>(q.w);
      const uint32_t op0 = __shfl_sync(kFull, qo, 0);
      if (__all_sync(kFull, q.x == kRecMatch && ql <= 32 && qo - qd + min(qd, ql) <= op0)) {
        const uint32_t seg = (op0 + g) & ~(kSeg - 1);
        if (__builtin_expect(seg > flushed, 0)) {
          flush(s.win, dstv, flushed, seg, false, lane);
          flushed = seg;
        }
        const uint32_t d0 = (qo + g) % kWin;
        const uint32_t s0 = d0 >= qd ? d0 - qd : d0 + kWin - qd;
        const uint32_t m = kPhase[qd < 32 ? qd : 0];  // eight lanes a match: phase and step
        uint32_t r = sub - qd * ((sub * m) >> 10);
        const uint32_t step = 8 - qd * ((8 * m) >> 10);
        for (uint32_t j = sub; j < ql; j += 8) {
          s.win[wrap(d0 + j)] = s.win[wrap(s0 + r)];
          r += step;
          if (r >= qd) r -= qd;
        }
        front = __shfl_sync(kFull, qo + ql, 24);
        rd += 4;
        __syncwarp();  // the next record may read these bytes
        if (rd - told >= 8) {
          st_release(&s.front, front);
          st_release(&s.rd, rd);
          told = rd;
        }
        continue;
      }
    }
    const int4 r = s.ring[rd % kRing];
    ++rd;
    const uint32_t op = static_cast<uint32_t>(r.y), v = op + g;
    if (__builtin_expect(r.x == kRecEnd, 0)) {  // op: past out_cap on 15
      if (r.z == kSuccess) {
        flush(s.win, dstv, flushed, v, false, lane);
        flush(s.win, dstv, v, out_cap + g, true, lane);
      } else {
        flush(s.win, dstv, g, out_cap + g, true, lane);
      }
      if (lane == 0) {
        *osz = r.z == kSuccess ? static_cast<int32_t>(op) : 0;
        *status = r.z;
      }
      return;
    }
    const uint32_t seg = v & ~(kSeg - 1);  // the whole segments below v go out
    if (__builtin_expect(seg > flushed, 0)) {
      flush(s.win, dstv, flushed, seg, false, lane);
      flushed = seg;
    }
    if (__builtin_expect(r.x == kRecMatch, 1)) {
      match_copy(s.win, v % kWin, static_cast<uint32_t>(r.w), static_cast<uint32_t>(r.z), lane);
      front = op + static_cast<uint32_t>(r.z);
      __syncwarp();  // the next record may read these bytes
    } else if (r.x == kRecStored) {  // up to a segment at a time, publishing each
      const uint32_t end = op + static_cast<uint32_t>(r.z);
      uint32_t a = op, src = static_cast<uint32_t>(r.w);
      while (a < end) {
        const uint32_t va = a + g, sg = va & ~(kSeg - 1);
        if (sg > flushed) {
          flush(s.win, dstv, flushed, sg, false, lane);
          flushed = sg;
        }
        const uint32_t piece = min(end - a, kSeg - (va - sg));
        const uint32_t slot = va % kWin;
#pragma unroll 8
        for (uint32_t j = lane; j < piece; j += 32) {
          const uint32_t sj = src + j;
          s.win[wrap(slot + j)] = sj < comp_cap ? __ldg(row + sj) : 0;
        }
        a += piece;
        src += piece;
        __syncwarp();
        st_release(&s.front, a);
      }
      front = end;
    } else {
      front = op;  // a mark: the literals before op are in the window
    }
    if (rd - told >= 8) {
      __syncwarp();
      st_release(&s.front, front);
      st_release(&s.rd, rd);
      told = rd;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
deflate_decode_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes,
                      const int32_t* __restrict__ starts, int comp_cap, uint8_t* __restrict__ out,
                      int out_cap, int32_t* __restrict__ out_sizes,
                      int32_t* __restrict__ statuses) {
  __shared__ Shared s;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s.wr = 0;
    s.rd = 0;
    s.front = 0;
  }
  __syncthreads();
  const uint8_t* row = comp + static_cast<size_t>(chunk) * comp_cap;
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const uint32_t g = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(dst) & 15);
  const long long csize = comp_sizes[chunk];
  const long long start = starts[chunk];
  if (threadIdx.x < 32)
    decoder_warp(s, row, static_cast<uint32_t>(comp_cap), csize, start,
                 static_cast<uint32_t>(out_cap), g, lane);
  else
    executor_warp(s, row, static_cast<uint32_t>(comp_cap), csize, start, dst,
                  static_cast<uint32_t>(out_cap), g, static_cast<uint32_t>(lane),
                  out_sizes + chunk, statuses + chunk);
}

cudaError_t configure() {  // the largest shared-memory carveout: 5 CTAs an SM
  return cudaFuncSetAttribute(deflate_decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int tpucomp_deflate_decode(const uint8_t* comp, const int32_t* comp_sizes,
                                      const int32_t* starts, int batch, int comp_cap,
                                      uint8_t* out, int out_cap, int32_t* out_sizes,
                                      int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const cudaError_t e = configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  deflate_decode_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, starts, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

// info[0..4): CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// static shared bytes, registers a thread, local (spill) bytes a thread.
extern "C" int tpucomp_deflate_decode_info(int* info) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, deflate_decode_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], deflate_decode_kernel, kThreads, 0);
  info[1] = static_cast<int>(a.sharedSizeBytes);
  info[2] = a.numRegs;
  info[3] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
