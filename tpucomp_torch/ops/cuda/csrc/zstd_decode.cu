// Batched Zstandard (RFC 8878) frame decode, one warp per chunk.
//
// Replaces the TPU kernel tpucomp/ops/pallas/zstd_decode.py::_kernel behind
// both of its wrappers: decompress_batch (zstd_decode.py:1231, the chunk held
// in VMEM) and decompress_batch_big (:1296, input and output windowed over HBM
// for chunks up to 16 MiB).  That kernel walks one frame per grid step on the
// scalar core: FSE and Huffman tables in SMEM scratch, literals regenerated
// into a VMEM scratch, literal runs and matches as 128-byte VPU wild copies,
// and in the big regime a sliding output window with DMA flushes and far
// matches staged back from HBM.  On the card the output row lives in device
// memory and a match reads it at any offset, so the window machinery has no
// counterpart and the two wrappers are one kernel that differs only in
// lit_cap, the bound on a block's regenerated literals (the wrapper passes
// it).  What it computes, and what this kernel computes:
//
//   frame header: magic, reserved bit, no dictionary, Frame_Content_Size
//                 skipped, content checksum not read;
//   the predefined LL/OF/ML tables built before the first block, so repeat
//   mode in block 1 reads them;
//   blocks (at most 128 KiB): raw, RLE, compressed; type 3 is an error;
//   literals: raw, RLE, Huffman with a tree (weights direct or FSE-coded in
//             two interleaved states), treeless (the previous tree); one or
//             four backward streams;
//   sequences: tables predefined / RLE / FSE (normalized counts) / repeat;
//              three interleaved FSE states; repeat offsets with the ll == 0
//              shift; literal runs and matches into the output row.
//
// Semantics kept exactly (statuses included) from the reference:
//  * regenerated literals above lit_cap, a block past csize, literals past the
//    block, a corrupt table, Huffman stream or sequence stream, an offset of
//    0 or past the output, and a frame that ends before its last block are
//    ERROR_CANNOT_DECOMPRESS;
//  * output that would pass out_cap is not written but op advances, so an
//    error later in the frame wins over ERROR_OUTPUT_BUFFER_TOO_SMALL;
//  * backward streams zero-pad from the bottom on underflow, and a stream
//    must end with exactly 0 bits left;
//  * bytes at and past comp_cap read as 0; a negative index reads byte i & 3
//    of the row (the reference's clamped word read).
// An error settles the status, so the walk stops at the first one (the
// reference walks on without effect).  Positions and op are 64-bit; the
// reference's int32 op would wrap only after 2 GiB of output in one frame.
//
// Bound: bytes.  A call must read each compressed byte once and write each
// output byte once (B x out_cap, the zero tail included).  Design: frames are
// independent and their walks serial, so each chunk gets a warp and the batch
// fills the card.  Lane 0 builds the FSE tables (3 x 512 + 64 entries) and
// the Huffman table (2048 entries, 16 bits each) in the warp's shared memory
// (10.9 KB a warp, 43.6 KB a block of four warps) between two __syncwarp()s.
// One lane decodes a single literal stream, lanes 0-3 the four streams at
// once, into a per-chunk scratch of lit_cap bytes in device memory.  All 32
// lanes then decode the sequences in lockstep (broadcast reads of the row
// and the tables; each lane keeps the same 8-byte window of the backward
// stream in registers), and the warp copies each literal run and match
// (csrc/bytecopy.cuh: warp_copy, and warp_match_copy, which equals the
// byte-serial copy for every offset).  The kernel writes every byte of the
// output row (decoded bytes, then zeros), so the caller's buffer needs no
// clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
constexpr int kWarpsPerBlock = 4;
constexpr int kFseCap = 512;  // 2^9: sequence accuracy logs <= 9
constexpr int kTabLL = 0, kTabOF = kFseCap, kTabML = 2 * kFseCap, kTabW = 3 * kFseCap;
constexpr int kFseTotal = 3 * kFseCap + 64;  // + the Huffman-weight table (acc <= 6)
constexpr int kHufCap = 2048;                // 2^11: Huffman max_bits <= 11
constexpr long long kBlockCap = 1 << 17;     // RFC 8878 Block_Maximum_Size
constexpr uint32_t kMagic = 0xFD2FB528u;

__constant__ int kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,   8,   9,   10,   11,
                                12, 13, 14, 15, 16, 18, 20, 22,  24,  28,  32,   40,
                                48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
__constant__ int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                                1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int kMLBase[53] = {3,   4,   5,    6,    7,    8,    9,    10,    11,    12,   13,
                                14,  15,  16,   17,   18,   19,   20,   21,    22,    23,   24,
                                25,  26,  27,   28,   29,   30,   31,   32,    33,    34,   35,
                                37,  39,  41,   43,   47,   51,   59,   67,    83,    99,   131,
                                259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
__constant__ int kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  1,  1,  1,  1,
                                2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
// predefined normalized counts (RFC 8878 3.1.1.3.2.2)
__constant__ int8_t kLLDef[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,  1,  2,  2,
                                  2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
__constant__ int8_t kOFDef[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                  1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
__constant__ int8_t kMLDef[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};

// The reference's bitlen(x, hi): how many k < hi have x >= 2^k.
__device__ __forceinline__ int bitlen(long long x, int hi) {
  if (x <= 0) return 0;
  const int b = 64 - __clzll(x);
  return b < hi ? b : hi;
}

// The compressed row: bytes at and past comp_cap read as 0, a negative index
// reads byte i & 3.
struct Row {
  const uint8_t* p;
  long long cap;
  __device__ __forceinline__ uint32_t getb(long long i) const {
    if (i >= 0) return i < cap ? p[i] : 0u;
    const long long j = i & 3;
    return j < cap ? p[j] : 0u;
  }
  // n <= 30 bits at bit position pos >= 0, LSB first.
  __device__ __forceinline__ uint32_t bits(long long pos, int n) const {
    const long long b = pos >> 3;
    uint64_t w = 0;
    for (int k = 0; k < 5; ++k) w |= static_cast<uint64_t>(getb(b + k)) << (8 * k);
    return static_cast<uint32_t>(w >> (pos & 7)) & ((1u << n) - 1u);
  }
};

// A backward bit stream: base bit, bits left above it, and an 8-byte window
// of the row in registers (the stream reads downward, so a reload puts the
// wanted byte near the window's top).
struct Bwd {
  long long base, left;
  long long lo = -1;  // first byte of the window; -1: none loaded
  uint64_t w = 0;

  // -> true on error: no bytes, or a last byte of 0 (no padding marker).
  __device__ bool init(const Row& in, long long start, long long nbytes) {
    const uint32_t last = in.getb(start + nbytes - 1);
    base = start * 8;
    left = (nbytes - 1) * 8 + bitlen(last, 8) - 1;
    return nbytes <= 0 || last == 0;
  }
  // n <= 30 bits at bit position pos >= 0.
  __device__ __forceinline__ uint32_t bits(const Row& in, long long pos, int n) {
    const long long b = pos >> 3;
    if (lo < 0 || b < lo || b > lo + 3) {
      lo = b > 3 ? b - 3 : 0;
      w = 0;
      if (lo + 8 <= in.cap) {
        for (int k = 0; k < 8; ++k) w |= static_cast<uint64_t>(in.p[lo + k]) << (8 * k);
      } else {
        for (int k = 0; k < 8; ++k) w |= static_cast<uint64_t>(in.getb(lo + k)) << (8 * k);
      }
    }
    return static_cast<uint32_t>(w >> ((b - lo) * 8 + (pos & 7))) & ((1u << n) - 1u);
  }
  // The top n (<= 30) bits below `left`; on underflow zeros pad from the bottom.
  __device__ __forceinline__ uint32_t read(const Row& in, int n) {
    const long long left2 = left - n;
    uint32_t v = 0;
    if (n > 0) {
      if (left2 >= 0) {
        v = bits(in, base + left2, n);
      } else if (left > 0) {
        v = bits(in, base, static_cast<int>(left)) << static_cast<int>(-left2);
      }
    }
    left = left2;
    return v;
  }
};

// The warp's tables in shared memory; written by lane 0 only.
struct Scratch {
  int32_t* tab;   // kFseTotal FSE entries: base << 16 | nbits << 8 | symbol
  uint16_t* huf;  // kHufCap Huffman entries: symbol << 8 | nbits
  int16_t* norm;  // 64 normalized counts, then per-symbol state counters
  uint8_t* w;     // 288 Huffman weights
};

// FSE decode table from norm[0:nsym] (summing to 2^acc) into t[0:2^acc].
__device__ void fse_build(int32_t* t, int16_t* norm, int nsym, int acc) {
  const int size = 1 << acc;
  int high = size - 1;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) t[high--] = s;
  const int step = (size >> 1) + (size >> 3) + 3;
  int p = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int k = 0; k < norm[s]; ++k) {
      t[p] = s;
      p = (p + step) & (size - 1);
      for (int g = 0; p > high && g < size; ++g) p = (p + step) & (size - 1);
    }
  }
  for (int s = 0; s < nsym; ++s) norm[s] = norm[s] == -1 ? 1 : (norm[s] > 0 ? norm[s] : 0);
  for (int i = 0; i < size; ++i) {
    const int s = t[i];
    const int x = norm[s]++;
    const int nb = acc - (bitlen(x, 11) - 1);
    t[i] = (((x << nb) - size) << 16) | (nb << 8) | s;
  }
}

// Normalized counts at bit bp into norm[0:64] (tail zeroed) -> true on error;
// acc, the next bit and the symbol count by reference.
__device__ bool read_ncount(int16_t* norm, const Row& in, long long& bp, int max_sym, int& acc,
                            int& nsym) {
  acc = static_cast<int>(in.bits(bp, 4)) + 5;
  for (int s = 0; s < 64; ++s) norm[s] = 0;
  bp += 4;
  int rem = (1 << acc) + 1, n = 0;
  bool prev0 = false;
  while (acc <= 9 && rem > 1 && n <= max_sym) {
    if (prev0) {
      uint32_t r = 3;
      while (r == 3) {
        r = in.bits(bp, 2);
        n = min(n + static_cast<int>(r), 63);
        bp += 2;
      }
      prev0 = false;
      if (n > max_sym) break;
    }
    const int nbb = bitlen(rem, 11);
    const int thr = 1 << (nbb > 1 ? nbb - 1 : 0);
    const int mx = 2 * thr - 1 - rem;
    const int v = static_cast<int>(in.bits(bp, nbb));
    const int low = v & (thr - 1);
    int cnt;
    if (low < mx) {
      cnt = low - 1;
      bp += nbb - 1;
    } else {
      cnt = (v >= thr ? v - mx : v) - 1;
      bp += nbb;
    }
    rem -= cnt < 0 ? -cnt : cnt;
    norm[min(n, 63)] = static_cast<int16_t>(cnt);
    ++n;
    prev0 = cnt == 0;
  }
  nsym = n;
  return acc > 9 || rem != 1;
}

// Lane 0: the Huffman weights of the tree at tree_pos, then the table ->
// true on error; the tree's bytes and max_bits by reference.
__device__ bool huf_tables(const Scratch& sc, const Row& in, long long tree_pos,
                           long long& tree_bytes, int& max_bits) {
  const int thdr = static_cast<int>(in.getb(tree_pos));
  uint8_t* w = sc.w;
  int n = 0;
  if (thdr >= 128) {  // direct 4-bit weights
    n = thdr - 127;
    for (int i = 0; i < n; ++i) {
      const uint32_t by = in.getb(tree_pos + 1 + (i >> 1));
      w[i] = static_cast<uint8_t>((i & 1) ? by & 0xF : by >> 4);
    }
    tree_bytes = 1 + ((n + 1) >> 1);
  } else {  // FSE-coded weights, two interleaved states
    int acc, nsym;
    long long bp = (tree_pos + 1) * 8;
    if (read_ncount(sc.norm, in, bp, 32, acc, nsym) || acc > 6) return true;
    int32_t* t = sc.tab + kTabW;
    fse_build(t, sc.norm, nsym, acc);
    const long long start = (bp + 7) >> 3;
    Bwd st;
    const bool e = st.init(in, start, tree_pos + 1 + thdr - start);
    uint32_t s0 = st.read(in, acc), s1 = st.read(in, acc);
    if (e || st.left < 0) return true;
    while (n < 255) {
      int32_t ent = t[s0];
      w[n++] = static_cast<uint8_t>(ent & 0xFF);
      uint32_t v = st.read(in, (ent >> 8) & 0xFF);
      if (st.left < 0) {  // emit the other state and stop
        w[n++] = static_cast<uint8_t>(t[s1] & 0xFF);
        break;
      }
      s0 = ((ent >> 16) & 0xFFFF) + v;
      ent = t[s1];
      w[n++] = static_cast<uint8_t>(ent & 0xFF);
      v = st.read(in, (ent >> 8) & 0xFF);
      if (st.left < 0) {
        w[n++] = static_cast<uint8_t>(t[s0] & 0xFF);
        break;
      }
      s1 = ((ent >> 16) & 0xFFFF) + v;
    }
    tree_bytes = 1 + thdr;
  }
  n = min(n, 255);
  long long total = 0;
  for (int i = 0; i < n; ++i)
    if (w[i] > 0) total += 1LL << (min(static_cast<int>(w[i]), 12) - 1);
  const long long rest = (1LL << bitlen(total, 20)) - total;
  if (total <= 0 || rest <= 0 || (rest & (rest - 1)) != 0) return true;
  w[n] = static_cast<uint8_t>(bitlen(rest, 20));
  const int nw = n + 1;
  // the table: ascending weight, then ascending symbol
  total = 0;
  for (int i = 0; i < nw; ++i)
    if (w[i] > 0) total += 1LL << (min(static_cast<int>(w[i]), 12) - 1);
  max_bits = bitlen(total, 20) - 1;
  if (max_bits < 1 || max_bits > 11) return true;
  const int size = 1 << max_bits;
  for (int i = 0; i < kHufCap; ++i) sc.huf[i] = 0;
  long long p = 0;
  for (int wt = 1; wt <= 12; ++wt) {
    const int run = 1 << (wt - 1);
    for (int s = 0; s < nw; ++s) {
      if (w[s] != wt) continue;
      if (p + run <= size) {
        const uint16_t ent = static_cast<uint16_t>((s << 8) | (max_bits + 1 - wt));
        for (int k = 0; k < run; ++k) sc.huf[p + k] = ent;
      }
      p += run;
    }
  }
  return p != size;
}

// One backward Huffman stream of `count` symbols into lit[0:count] -> true
// on error.
__device__ bool huf_stream(const uint16_t* huf, const Row& in, long long start, long long nbytes,
                           long long count, uint8_t* lit, int mb) {
  Bwd st;
  if (st.init(in, start, nbytes)) return true;
  for (long long i = 0; i < count; ++i) {
    const int nn = static_cast<int>(st.left < 0 ? 0 : (st.left < mb ? st.left : mb));
    const long long at = st.base + (st.left > mb ? st.left - mb : 0);
    const uint32_t ent = huf[st.bits(in, at, nn) << (mb - nn)];
    const int nb = ent & 0xFF;
    if (nb == 0) return true;
    lit[i] = static_cast<uint8_t>(ent >> 8);
    st.left -= nb;
    if (st.left < 0) return true;
  }
  return st.left != 0;
}

// Lane 0: the three sequence tables of a block (modes of scm) from sq on ->
// true on error; sq and the accuracy logs (LL, OF, ML) by reference.
__device__ bool seq_tables(const Scratch& sc, const Row& in, int scm, long long& sq, int* accs) {
  for (int t = 0; t < 3; ++t) {
    const int mode = (scm >> (6 - 2 * t)) & 3;
    const int tbase = t == 0 ? kTabLL : t == 1 ? kTabOF : kTabML;
    const int msym = t == 0 ? 35 : t == 1 ? 31 : 52;
    if (mode == 0) {
      const int8_t* def = t == 0 ? kLLDef : t == 1 ? kOFDef : kMLDef;
      const int n = t == 0 ? 36 : t == 1 ? 29 : 53;
      for (int s = 0; s < n; ++s) sc.norm[s] = def[s];
      accs[t] = t == 1 ? 5 : 6;
      fse_build(sc.tab + tbase, sc.norm, n, accs[t]);
    } else if (mode == 1) {
      const int sym = static_cast<int>(in.getb(sq));
      if (sym > msym) return true;
      sc.tab[tbase] = sym;
      ++sq;
      accs[t] = 0;
    } else if (mode == 2) {
      int acc, nsym;
      long long bp = sq * 8;
      if (read_ncount(sc.norm, in, bp, msym, acc, nsym)) return true;
      fse_build(sc.tab + tbase, sc.norm, nsym, acc);
      sq = (bp + 7) >> 3;
      accs[t] = acc;
    }
  }
  return false;
}

// The frame walk; every lane calls it and leaves it together.  -> true on
// error; op (the bytes the frame regenerates) by reference.
__device__ bool walk(const Scratch& sc, const Row& in, long long csize, uint8_t* dst,
                     long long out_cap, uint8_t* lit, long long lit_cap, int lane, long long& op) {
  using tpucomp::kFullMask;
  const uint32_t magic = in.getb(0) | (in.getb(1) << 8) | (in.getb(2) << 16) | (in.getb(3) << 24);
  const uint32_t fhd = in.getb(4);
  if (csize < 5 || magic != kMagic || ((fhd >> 3) & 1) || (fhd & 3)) return true;
  const int single = (fhd >> 5) & 1;
  const int fcs_flag = fhd >> 6;
  long long pos = 5 + (1 - single) + (fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8);
  if (lane == 0) {  // the predefined tables, so that repeat mode in block 1 reads them
    int dummy[3];
    long long sq = 0;
    seq_tables(sc, in, 0, sq, dummy);
  }
  __syncwarp();
  int accs[3] = {6, 5, 6};
  long long r0 = 1, r1 = 4, r2 = 8;
  int hbits = 0;
  bool done = false;
  op = 0;
  while (!done && pos + 3 <= csize) {
    const uint32_t bh = in.getb(pos) | (in.getb(pos + 1) << 8) | (in.getb(pos + 2) << 16);
    done = bh & 1;
    const int btype = (bh >> 1) & 3;
    const long long bsize = bh >> 3;
    pos += 3;
    if (btype == 3 || bsize > kBlockCap) return true;
    if (btype == 0) {  // raw
      if (pos + bsize > csize) return true;
      if (op + bsize <= out_cap)
        tpucomp::warp_copy_bounded(dst + op, in.p, pos, in.cap, bsize, lane);
      pos += bsize;
      op += bsize;
      continue;
    }
    if (btype == 1) {  // RLE
      if (pos + 1 > csize) return true;
      if (op + bsize <= out_cap)
        tpucomp::warp_fill(dst, op, op + bsize, static_cast<uint8_t>(in.getb(pos)), lane);
      pos += 1;
      op += bsize;
      continue;
    }
    // ---- compressed block: literals section
    const long long block_end = pos + bsize;
    if (block_end > csize) return true;
    const uint32_t lsh = in.getb(pos);
    const int lit_type = lsh & 3, fmt = (lsh >> 2) & 3;
    long long regen, lit_end;
    if (lit_type <= 1) {  // raw or RLE literals
      const int hdr = fmt == 1 ? 2 : fmt == 3 ? 3 : 1;
      regen = fmt == 1   ? (lsh >> 4) | (in.getb(pos + 1) << 4)
              : fmt == 3 ? (lsh >> 4) | (in.getb(pos + 1) << 4) | (in.getb(pos + 2) << 12)
                         : lsh >> 3;
      lit_end = pos + hdr + (lit_type == 0 ? regen : 1);
      if (regen > lit_cap || lit_end > block_end) return true;
      if (lit_type == 0)
        tpucomp::warp_copy_bounded(lit, in.p, pos + hdr, in.cap, regen, lane);
      else
        tpucomp::warp_fill(lit, 0, regen, static_cast<uint8_t>(in.getb(pos + hdr)), lane);
    } else {  // Huffman-coded, with a tree or treeless
      const int hdr = fmt <= 1 ? 3 : fmt == 2 ? 4 : 5;
      const int nbits = fmt <= 1 ? 10 : fmt == 2 ? 14 : 18;
      uint64_t w40 = 0;
      for (int k = 0; k < 5; ++k) w40 |= static_cast<uint64_t>(in.getb(pos + k)) << (8 * k);
      const uint64_t mask = (1ull << nbits) - 1;
      regen = static_cast<long long>((w40 >> 4) & mask);
      const long long cs = static_cast<long long>((w40 >> (4 + nbits)) & mask);
      lit_end = pos + hdr + cs;
      long long spos = pos + hdr;
      if (regen > lit_cap || lit_end > block_end) return true;
      if (lit_type == 3) {
        if (hbits == 0) return true;
      } else {
        bool e = false;
        long long tree_bytes = 0;
        int mb = 0;
        if (lane == 0) e = huf_tables(sc, in, spos, tree_bytes, mb);
        __syncwarp();  // the table is complete before any lane reads it
        e = __shfl_sync(kFullMask, static_cast<int>(e), 0) != 0;
        if (e) return true;
        tree_bytes = __shfl_sync(kFullMask, tree_bytes, 0);
        hbits = __shfl_sync(kFullMask, mb, 0);
        spos += tree_bytes;
      }
      bool e = false;
      if (fmt >= 1) {  // four streams, one per lane 0-3
        const long long j1 = in.getb(spos) | (in.getb(spos + 1) << 8);
        const long long j2 = in.getb(spos + 2) | (in.getb(spos + 3) << 8);
        const long long j3 = in.getb(spos + 4) | (in.getb(spos + 5) << 8);
        const long long sbase = spos + 6;
        const long long j4 = lit_end - sbase - j1 - j2 - j3;
        const long long per = (regen + 3) >> 2;
        const long long cl = regen - 3 * per;
        if (j4 <= 0 || cl < 0) return true;
        if (lane < 4) {
          const long long start = sbase + (lane > 0 ? j1 : 0) + (lane > 1 ? j2 : 0) +
                                  (lane > 2 ? j3 : 0);
          const long long nb = lane == 0 ? j1 : lane == 1 ? j2 : lane == 2 ? j3 : j4;
          e = huf_stream(sc.huf, in, start, nb, lane < 3 ? per : cl, lit + lane * per, hbits);
        }
      } else if (lane == 0) {
        e = huf_stream(sc.huf, in, spos, lit_end - spos, regen, lit, hbits);
      }
      __syncwarp();  // the literals are visible to every lane
      if (__any_sync(kFullMask, e)) return true;
    }
    // ---- sequences section
    const long long b0 = in.getb(lit_end);
    long long nseq, sq;
    if (b0 < 128) {
      nseq = b0;
      sq = lit_end + 1;
    } else if (b0 < 255) {
      nseq = ((b0 - 128) << 8) + in.getb(lit_end + 1);
      sq = lit_end + 2;
    } else {
      nseq = in.getb(lit_end + 1) + (in.getb(lit_end + 2) << 8) + 0x7F00;
      sq = lit_end + 3;
    }
    long long lit_pos = 0;
    if (nseq > 0) {
      const int scm = static_cast<int>(in.getb(sq));
      ++sq;
      if (scm & 3) return true;
      bool e = false;
      __syncwarp();  // every lane is done reading the previous block's tables
      if (lane == 0) e = seq_tables(sc, in, scm, sq, accs);
      __syncwarp();
      e = __shfl_sync(kFullMask, static_cast<int>(e), 0) != 0;
      if (e) return true;
      sq = __shfl_sync(kFullMask, sq, 0);
      for (int t = 0; t < 3; ++t) accs[t] = __shfl_sync(kFullMask, accs[t], 0);
      Bwd st;
      e = st.init(in, sq, block_end - sq);
      uint32_t ll_s = st.read(in, accs[0]);
      uint32_t of_s = st.read(in, accs[1]);
      uint32_t ml_s = st.read(in, accs[2]);
      if (e || st.left < 0) return true;
      for (long long i = 0; i < nseq; ++i) {
        const int32_t ll_e = sc.tab[kTabLL + (ll_s & (kFseCap - 1))];
        const int32_t of_e = sc.tab[kTabOF + (of_s & (kFseCap - 1))];
        const int32_t ml_e = sc.tab[kTabML + (ml_s & (kFseCap - 1))];
        const int of_sym = of_e & 0xFF;
        if (of_sym > 30) return true;
        const long long ofv = (1LL << of_sym) + st.read(in, of_sym);
        const int mls = min(ml_e & 0xFF, 52);
        const long long ml = kMLBase[mls] + st.read(in, kMLBits[mls]);
        const int lls = min(ll_e & 0xFF, 35);
        const long long ll = kLLBase[lls] + st.read(in, kLLBits[lls]);
        if (st.left < 0) return true;
        long long off;
        if (ofv <= 3) {  // repeat offsets
          const long long ridx = ofv - 1 + (ll == 0 ? 1 : 0);
          off = ridx == 0 ? r0 : ridx == 1 ? r1 : ridx == 2 ? r2 : r0 - 1;
          if (ridx > 0) {
            r2 = ridx >= 2 ? r1 : r2;
            r1 = r0;
            r0 = off;
          }
        } else {
          off = ofv - 3;
          r2 = r1;
          r1 = r0;
          r0 = off;
        }
        if (off <= 0 || lit_pos + ll > regen) return true;
        if (op + ll <= out_cap) tpucomp::warp_copy(dst + op, lit + lit_pos, ll, lane);
        lit_pos += ll;
        op += ll;
        if (off > op) return true;
        if (op + ml <= out_cap) tpucomp::warp_match_copy(dst, op, static_cast<int>(off), ml, lane);
        op += ml;
        if (i + 1 < nseq) {  // state updates, read in the order ll, ml, of
          const int lnb = (ll_e >> 8) & 0xFF, mnb = (ml_e >> 8) & 0xFF, onb = (of_e >> 8) & 0xFF;
          const uint32_t v = st.read(in, lnb + mnb + onb);
          ll_s = ((ll_e >> 16) & 0xFFFF) + (v >> (mnb + onb));
          ml_s = ((ml_e >> 16) & 0xFFFF) + ((v >> onb) & ((1u << mnb) - 1u));
          of_s = ((of_e >> 16) & 0xFFFF) + (v & ((1u << onb) - 1u));
          if (st.left < 0) return true;
        }
      }
      if (st.left != 0) return true;
    }
    const long long rest = regen - lit_pos;  // trailing literals
    if (op + rest <= out_cap) tpucomp::warp_copy(dst + op, lit + lit_pos, rest, lane);
    op += rest;
    pos = block_end;
  }
  return !done;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zstd_decode_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes,
                   int batch, int comp_cap, uint8_t* __restrict__ out, int out_cap,
                   uint8_t* __restrict__ lits, int lit_cap, int32_t* __restrict__ out_sizes,
                   int32_t* __restrict__ statuses) {
  __shared__ int32_t s_tab[kWarpsPerBlock][kFseTotal];
  __shared__ uint16_t s_huf[kWarpsPerBlock][kHufCap];
  __shared__ int16_t s_norm[kWarpsPerBlock][64];
  __shared__ uint8_t s_w[kWarpsPerBlock][288];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const Scratch sc{s_tab[wi], s_huf[wi], s_norm[wi], s_w[wi]};
  const Row in{comp + static_cast<size_t>(chunk) * comp_cap, comp_cap};
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  uint8_t* lit = lits + static_cast<size_t>(chunk) * lit_cap;
  long long op = 0;
  const bool err = walk(sc, in, comp_sizes[chunk], dst, out_cap, lit, lit_cap, lane, op);
  const bool too_big = !err && op > out_cap;
  const long long osz = (err || too_big) ? 0 : op;
  tpucomp::warp_fill(dst, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = static_cast<int32_t>(osz);
    statuses[chunk] = err ? kCannotDecompress : (too_big ? kOutputTooSmall : kSuccess);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// lits: batch x lit_cap bytes of scratch for the regenerated literals.
extern "C" int tpucomp_zstd_decode(const uint8_t* comp, const int32_t* comp_sizes, int batch,
                                   int comp_cap, uint8_t* out, int out_cap, uint8_t* lits,
                                   int lit_cap, int32_t* out_sizes, int32_t* statuses,
                                   void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  zstd_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, batch, comp_cap, out, out_cap, lits, lit_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}
