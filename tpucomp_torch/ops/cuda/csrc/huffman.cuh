// Canonical Huffman decode tables, shared by the Deflate-family decoders.
//
// Replaces tpucomp/ops/pallas/huffman.py (make_table_builder,
// make_code_reader), the helpers of the TPU kernels deflate_decode.py::_kernel
// and the GDeflate decoders; it has no pallas_call of its own.  The serial
// GDeflate decoder (csrc/gdeflate_decode.cu) includes it; the Deflate decoder
// (csrc/deflate_decode.cu) builds the same tables with a warp, keeping this
// loop for the codes longer than the root.  The plain
// version is tpucomp_torch/ops/cuda/huffman.py, step for step the same.
//
// build_table fills a two-level table for the code lengths lens[base, base +
// nsym) with the classic inflate algorithm: codes in canonical (length,
// symbol) order, filled incrementally; a code longer than `root` whose low
// `root` bits are new opens a subtable sized by the counts that remain.
// Entries: a leaf is (sym << 8) | bits, a link kSubFlag | (offset << 8) |
// sub_bits, an uncovered slot 0 (read_code reports it as invalid, so an
// incomplete code is accepted until such a slot is hit).  Errors, as the
// reference's: an over-subscribed code (left < 0 at some length) and a table
// of more than `enough` entries.
//
// One thread builds (the caller's lane 0); the scratch is that warp's shared
// memory, and the caller syncs the warp before other lanes read the table.
#pragma once

#include <cstdint>

namespace tpucomp {

constexpr int32_t kSubFlag = 1 << 30;

struct HuffScratch {
  int32_t* tab;   // the tables, tbase-relative
  int32_t* lens;  // 320 code lengths
  int32_t* work;  // 320: symbols in canonical order
  int32_t* cnt;   // 16: codes per length
  int32_t* ofs;   // 16: offsets per length
};

// Returns true on error.  Single thread.
__device__ inline bool build_table(const HuffScratch& s, int base, int nsym, int root,
                                   int tbase, int enough) {
  for (int i = 0; i < enough; ++i) s.tab[tbase + i] = 0;
  for (int i = 0; i < 16; ++i) s.cnt[i] = 0;
  for (int i = 0; i < nsym; ++i) ++s.cnt[s.lens[base + i]];
  int maxl = 0, minl = 16, left = 1;
  bool err = false;
  for (int l = 1; l < 16; ++l) {
    const int c = s.cnt[l];
    if (c > 0) {
      maxl = l;
      if (minl == 16) minl = l;
    }
    left = (left << 1) - c;
    err = err || left < 0;
  }
  s.ofs[1] = 0;
  for (int l = 1; l < 15; ++l) s.ofs[l + 1] = s.ofs[l] + s.cnt[l];
  for (int i = 0; i < nsym; ++i) {
    const int l = s.lens[base + i];
    if (l > 0) s.work[s.ofs[l]++] = i;
  }
  if (maxl == 0 || err) return err;

  const int mask = (1 << root) - 1;
  int sym = 0, ln = minl, huff = 0, nxt = tbase, curr = root, drop = 0, low = -1;
  int used = 1 << root;
  const int tend = tbase + enough;
  while (ln <= maxl) {
    if (ln > root && (huff & mask) != low) {
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
      s.tab[tbase + low] = kSubFlag | ((nxt - tbase) << 8) | curr;
    }
    const int entry = (s.work[sym] << 8) | (ln - drop);
    const int incr = 1 << (ln - drop);
    const int hofs = nxt + (huff >> drop);
    for (int f = (1 << curr) - incr; f >= 0; f -= incr) {
      // a code that is not over-subscribed always lands inside its table;
      // the check only keeps the store in bounds whatever the input
      if (hofs + f >= tbase && hofs + f < tend) s.tab[hofs + f] = entry;
    }
    int inc = 1 << (ln - 1);  // huff += 1, bit-reversed at width ln
    while (huff & inc) inc >>= 1;
    huff = inc ? (huff & (inc - 1)) + inc : 0;
    ++sym;
    if (--s.cnt[ln] == 0) ln = ln == maxl ? 16 : s.lens[base + s.work[sym]];
  }
  return false;
}

// Decode one symbol.  peek(n) gives the next n unconsumed bits, LSB first.
template <class Peek>
__device__ __forceinline__ void read_code(const int32_t* tab, const Peek& peek, int tbase,
                                          int root, int& sym, int& nbits, bool& invalid) {
  int e = tab[tbase + static_cast<int>(peek(root))];
  int drop = 0;
  if (e & kSubFlag) {
    const int v2 = static_cast<int>(peek(root + (e & 0xFF))) >> root;
    e = tab[tbase + ((e >> 8) & 0xFFFF) + v2];
    drop = root;
  }
  const int nb = e & 0xFF;
  sym = static_cast<int>(static_cast<uint32_t>(e) >> 8);
  nbits = drop + nb;
  invalid = nb == 0;
}

}  // namespace tpucomp
