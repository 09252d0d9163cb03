// Zstandard (RFC 8878) frame building blocks shared by the frame walk
// (zstd_decode.cu) and the block-parallel passes (zstd_passes.cu): the code
// tables, the reference's row reads, backward bit streams, FSE and Huffman
// table builds, and the header parses.  Their plain versions are
// tpucomp_torch/ops/cuda/zstd_decode.py::Row and its helpers.
//
// Reads of the compressed row keep the reference's semantics: bytes at and
// past comp_cap read as 0, a negative index reads byte i & 3.  Inside the
// row a bit window is refilled with two aligned 8-byte read-only loads
// (Row::load8); only a window that touches the row's edges goes byte by byte.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tpucomp_zstd {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
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
  // Bytes b .. b+7, little-endian.  Inside the row: two aligned read-only
  // loads (the second word holds byte b+7, so it lies inside the row too).
  __device__ __forceinline__ uint64_t load8(long long b) const {
    if (b >= 0 && b + 8 <= cap) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(p + b);
      const uint64_t* w = reinterpret_cast<const uint64_t*>(a & ~uintptr_t(7));
      const int sh = static_cast<int>(a & 7) * 8;
      const uint64_t lo = __ldg(w);
      return sh == 0 ? lo : (lo >> sh) | (__ldg(w + 1) << (64 - sh));
    }
    uint64_t w = 0;
    for (int k = 0; k < 8; ++k) w |= static_cast<uint64_t>(getb(b + k)) << (8 * k);
    return w;
  }
  // n <= 30 bits at bit position pos >= 0, LSB first.
  __device__ __forceinline__ uint32_t bits(long long pos, int n) const {
    return static_cast<uint32_t>(load8(pos >> 3) >> (pos & 7)) & ((1u << n) - 1u);
  }
};

// A backward bit stream: its first byte in the row, the bits left above its
// first bit, and an 8-byte window of the stream in registers (the stream
// reads downward, so a reload puts the wanted byte near the window's top).
// Positions inside the stream are 32-bit: a stream is at most a block.
struct Bwd {
  long long start;
  int left;
  int lo = -1;  // the window's first byte, from start; -1: none loaded
  uint64_t w = 0;

  // -> true on error: no bytes, or a last byte of 0 (no padding marker).
  __device__ bool init(const Row& in, long long first, long long nbytes) {
    const uint32_t last = in.getb(first + nbytes - 1);
    start = first;
    left = static_cast<int>((nbytes - 1) * 8 + bitlen(last, 8) - 1);
    return nbytes <= 0 || last == 0;
  }
  // n <= 30 bits at bit p >= 0 of the stream.
  __device__ __forceinline__ uint32_t bits(const Row& in, int p, int n) {
    const int b = p >> 3;
    if (lo < 0 || b < lo || b > lo + 3) {
      lo = b > 3 ? b - 3 : 0;
      w = in.load8(start + lo);
    }
    return static_cast<uint32_t>(w >> ((b - lo) * 8 + (p & 7))) & ((1u << n) - 1u);
  }
  // The top n (<= 30) bits below `left`; on underflow zeros pad from the bottom.
  __device__ __forceinline__ uint32_t read(const Row& in, int n) {
    const int left2 = left - n;
    uint32_t v = 0;
    if (n > 0) {
      if (left2 >= 0) {
        v = bits(in, left2, n);
      } else if (left > 0) {
        v = bits(in, 0, left) << -left2;
      }
    }
    left = left2;
    return v;
  }
};

// Tables in shared memory, written by one thread at a time.
struct Scratch {
  int32_t* tab;   // kFseTotal FSE entries: base << 16 | nbits << 8 | symbol
  uint16_t* huf;  // kHufCap Huffman entries: symbol << 8 | nbits
  int16_t* norm;  // 64 normalized counts, then per-symbol state counters
  uint8_t* w;     // 288 Huffman weights
};

// FSE decode table from norm[0:nsym] (summing to 2^acc) into t[0:2^acc].
__device__ inline void fse_build(int32_t* t, int16_t* norm, int nsym, int acc) {
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
__device__ inline bool read_ncount(int16_t* norm, const Row& in, long long& bp, int max_sym,
                                   int& acc, int& nsym) {
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

// The Huffman weights of the tree at tree_pos, then the table -> true on
// error; the tree's bytes and max_bits by reference.
__device__ inline bool huf_tables(const Scratch& sc, const Row& in, long long tree_pos,
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

// One backward Huffman stream of `count` symbols into lit[0:count] (with
// kStore false, checked only: nothing is written) -> true on error.
template <bool kStore = true>
__device__ inline bool huf_stream(const uint16_t* huf, const Row& in, long long start,
                                  long long nbytes, long long count, uint8_t* lit, int mb) {
  Bwd st;
  if (st.init(in, start, nbytes)) return true;
  for (int i = 0; i < count; ++i) {
    const int nn = st.left < 0 ? 0 : (st.left < mb ? st.left : mb);
    const int at = st.left > mb ? st.left - mb : 0;
    const uint32_t ent = huf[st.bits(in, at, nn) << (mb - nn)];
    const int nb = ent & 0xFF;
    if (nb == 0) return true;
    if (kStore) lit[i] = static_cast<uint8_t>(ent >> 8);
    st.left -= nb;
    if (st.left < 0) return true;
  }
  return st.left != 0;
}

// Huffman-coded literals into lit[0:regen]: one stream (lane 0), or four
// (lanes 0-3) behind the jump table at spos.  -> true on error in this
// lane's stream, or on every lane for a bad jump table.  With kStore false
// the streams are checked and lit is not touched.
template <bool kStore = true>
__device__ inline bool huf_literals(const uint16_t* huf, const Row& in, int fmt, long long regen,
                                    long long spos, long long lit_end, uint8_t* lit, int hbits,
                                    int lane) {
  if (fmt == 0)
    return lane == 0 && huf_stream<kStore>(huf, in, spos, lit_end - spos, regen, lit, hbits);
  const long long j1 = in.getb(spos) | (in.getb(spos + 1) << 8);
  const long long j2 = in.getb(spos + 2) | (in.getb(spos + 3) << 8);
  const long long j3 = in.getb(spos + 4) | (in.getb(spos + 5) << 8);
  const long long sbase = spos + 6;
  const long long j4 = lit_end - sbase - j1 - j2 - j3;
  const long long per = (regen + 3) >> 2;
  const long long cl = regen - 3 * per;
  if (j4 <= 0 || cl < 0) return true;
  if (lane >= 4) return false;
  const long long start = sbase + (lane > 0 ? j1 : 0) + (lane > 1 ? j2 : 0) + (lane > 2 ? j3 : 0);
  const long long nb = lane == 0 ? j1 : lane == 1 ? j2 : lane == 2 ? j3 : j4;
  return huf_stream<kStore>(huf, in, start, nb, lane < 3 ? per : cl,
                           kStore ? lit + lane * per : lit, hbits);
}

// Sequence table t (0 LL, 1 OF, 2 ML) of `mode` (0 predefined, 1 RLE,
// 2 FSE; 3, repeat, reads nothing) from byte sq -> true on error; sq and the
// accuracy log (left as it is for a repeat) by reference.  RLE writes entry 0
// only, at accuracy 0.
__device__ inline bool seq_table(const Scratch& sc, const Row& in, int t, int mode, long long& sq,
                                 int& acc) {
  const int tbase = t == 0 ? kTabLL : t == 1 ? kTabOF : kTabML;
  const int msym = t == 0 ? 35 : t == 1 ? 31 : 52;
  if (mode == 0) {
    const int8_t* def = t == 0 ? kLLDef : t == 1 ? kOFDef : kMLDef;
    const int n = t == 0 ? 36 : t == 1 ? 29 : 53;
    for (int s = 0; s < n; ++s) sc.norm[s] = def[s];
    acc = t == 1 ? 5 : 6;
    fse_build(sc.tab + tbase, sc.norm, n, acc);
  } else if (mode == 1) {
    const int sym = static_cast<int>(in.getb(sq));
    if (sym > msym) return true;
    sc.tab[tbase] = sym;
    ++sq;
    acc = 0;
  } else if (mode == 2) {
    int nacc, nsym;
    long long bp = sq * 8;
    if (read_ncount(sc.norm, in, bp, msym, nacc, nsym)) return true;
    fse_build(sc.tab + tbase, sc.norm, nsym, nacc);
    sq = (bp + 7) >> 3;
    acc = nacc;
  }
  return false;
}

// The first block's position, or -1 for a header the decoder refuses (size,
// magic, reserved bit, dictionary ID).
__device__ inline long long frame_start(const Row& in, long long csize) {
  const uint32_t magic = in.getb(0) | (in.getb(1) << 8) | (in.getb(2) << 16) | (in.getb(3) << 24);
  const uint32_t fhd = in.getb(4);
  if (csize < 5 || magic != kMagic || ((fhd >> 3) & 1) || (fhd & 3)) return -1;
  const int single = (fhd >> 5) & 1;
  const int fcs_flag = fhd >> 6;
  return 5 + (1 - single) + (fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8);
}

// The literals section header at pos: type, size format, regenerated size,
// the first byte after the header and the section's end.
struct Literals {
  int type, fmt;
  long long regen, spos, end;
};

__device__ inline Literals literals(const Row& in, long long pos) {
  const uint32_t lsh = in.getb(pos);
  Literals l;
  l.type = lsh & 3;
  l.fmt = (lsh >> 2) & 3;
  if (l.type <= 1) {  // raw or RLE
    const int hdr = l.fmt == 1 ? 2 : l.fmt == 3 ? 3 : 1;
    l.regen = l.fmt == 1   ? (lsh >> 4) | (in.getb(pos + 1) << 4)
              : l.fmt == 3 ? (lsh >> 4) | (in.getb(pos + 1) << 4) | (in.getb(pos + 2) << 12)
                           : lsh >> 3;
    l.spos = pos + hdr;
    l.end = l.spos + (l.type == 0 ? l.regen : 1);
  } else {  // Huffman-coded, with a tree or treeless
    const int hdr = l.fmt <= 1 ? 3 : l.fmt == 2 ? 4 : 5;
    const int nbits = l.fmt <= 1 ? 10 : l.fmt == 2 ? 14 : 18;
    uint64_t w40 = 0;
    for (int k = 0; k < 5; ++k) w40 |= static_cast<uint64_t>(in.getb(pos + k)) << (8 * k);
    const uint64_t mask = (1ull << nbits) - 1;
    l.regen = static_cast<long long>((w40 >> 4) & mask);
    l.spos = pos + hdr;
    l.end = l.spos + static_cast<long long>((w40 >> (4 + nbits)) & mask);
  }
  return l;
}

// The sequence count at lit_end; the byte after it by reference.
__device__ inline long long nseq_at(const Row& in, long long lit_end, long long& sq) {
  const long long b0 = in.getb(lit_end);
  if (b0 < 128) {
    sq = lit_end + 1;
    return b0;
  }
  if (b0 < 255) {
    sq = lit_end + 2;
    return ((b0 - 128) << 8) + in.getb(lit_end + 1);
  }
  sq = lit_end + 3;
  return in.getb(lit_end + 1) + (in.getb(lit_end + 2) << 8) + 0x7F00;
}

}  // namespace tpucomp_zstd
