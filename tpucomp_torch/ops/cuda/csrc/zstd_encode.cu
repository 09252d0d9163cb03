// Batched Zstandard encode: the token walk, one warp per chunk, in two modes
// (hist, full) of one kernel body.
//
// Replaces the TPU kernel tpucomp/ops/pallas/zstd_encode.py::_kernel in its
// two trace-time modes: "hist" (called by compress_batch at
// zstd_encode.py:864, exact entropy only) and "full" (compress_batch at
// :932).  Match finding is not in here: the caller first runs the sort-based
// candidate pass (tpucomp_torch/ops/match.py::candidates2 with the 64 KiB
// window), which gives for every position the nearest previous 4-byte match
// `cand`, an 8-byte-prefix sort neighbour `cand8`, and `nxt`, the next
// position that has either.  The walk is the same in both modes, so hist and
// full see the same sequences:
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
// then the literals [anchor, size).
//  * hist: the literal bytes' histogram into int32[B, 256] and the kept
//    sequences' LL/ML/OF code counts into int32[B, 121] (LL at 0, ML at 36,
//    OF at 89); no output row.
//  * full: the literals go to a scratch row and the sequences (ll | (ml - 3)
//    << 16, offset value) to a scratch list, both in device memory; then one
//    complete frame: header (magic, FHD 0x80, window byte, 4-byte content
//    size, block header); the literal section, 4-stream Huffman (Size_Format
//    3, the tree description given, a 6-byte jump table, each stream written
//    backward with a 1-bit sentinel) when huf_ok, n_lit >= 64 and 5 + csize
//    < 3 + n_lit, else raw (a 3-byte header with a 20-bit size); the
//    sequence count (2-byte form), the symbol compression modes byte, the
//    custom tables' descriptions and the backward FSE bitstream: the last
//    sequence sets the three states; every earlier one appends the OF, ML
//    and LL transitions (fse_tab packs state | nb << 10 | base << 14, LL and
//    ML 512 columns, OF 256), then every sequence its LL, ML and OF extra
//    bits; then the ML, OF and LL states and the padding bit.  A frame not
//    shorter than 13 + size bytes is rewritten as one raw block.
// The streams are LSB first; a 64-bit accumulator writes 4 bytes whenever
// it holds 32 bits and ceil(bits / 8) bytes at the end, the same bytes as the
// TPU kernel's (lo, hi, nbits) triple.  A frame longer than out_cap ends as
// OUTPUT_BUFFER_TOO_SMALL with size 0: the TPU kernel writes into a row of
// max(out_cap, 16 + cap + 64 + 11 cap / 8 + 9 cap_seq + 192) bytes (its
// Huffman streams in a scratch region past the literals, then moved down)
// and drops the excess; here each stream's byte count is known before it is
// written (the sum of its code lengths), so the streams go straight to their
// place, and bytes at or past out_cap are counted, never stored.  The TPU
// kernel's 4096-byte slabs over a second grid dimension only pipeline the
// candidate arrays through SMEM: a match that runs past a slab resumes in
// the next, and a walk that stops ends every later slab, so here the walk is
// one loop over the chunk.
//
// Bound: bytes.  A call must read each input byte once and write each output
// byte once (B x out_cap, the zero tail included; hist writes B x 377
// counts); it reads the candidate arrays only where the walk lands, and the
// full walk reads fse_tab (216 KB a chunk) only at the sequences' states.
// Design: a warp per chunk, all lanes carrying the same walk state
// (broadcast loads, uniform branches), lane 0 storing the header and the
// sequence bitstream; forward extension compares 32 bytes a step with a
// ballot (warp_match_len); literal copies, the tree, the raw rewrite and the
// zero tail use the whole warp; lanes 0-3 write the four Huffman streams at
// once.  The histograms (hist) and the Huffman codes (full) live in the
// warp's shared memory.  The kernel writes every byte of the output row, so
// the caller's buffer needs no clearing.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kOutputTooSmall = 15;
constexpr int kMinMatch = 4;
constexpr int kWarpsPerBlock = 4;
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

enum Mode { kHistMode = 0, kFullMode = 1 };

// floor(log2 v) for v >= 1
__device__ __forceinline__ int hibit(int v) { return 31 - __clz(v); }

__device__ __forceinline__ int ll_code(const int32_t* cst, int ll) {
  return ll < 64 ? cst[kOLLC + ll] : 19 + hibit(ll);
}

__device__ __forceinline__ int ml_code(const int32_t* cst, int mlv) {
  return mlv < 128 ? cst[kOMLC + mlv] : 36 + hibit(max(mlv, 1));
}

// The LSB-first bit stream into one output row; every lane holds the same
// state, lane 0 stores (through OutRow, which drops stores past the row).
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

// One lane's own bit stream (a Huffman literal stream): the same bytes as
// BitOut, stored by the lane that owns it.
struct LaneBits {
  uint8_t* p;
  int cap;
  int op;
  uint64_t acc;
  int nb;
  __device__ __forceinline__ void byte(int v) {
    if (op < cap) p[op] = static_cast<uint8_t>(v);
    ++op;
  }
  __device__ __forceinline__ void put(uint32_t v, int n) {
    acc |= static_cast<uint64_t>(v) << nb;
    nb += n;
    if (nb >= 32) {
      for (int k = 0; k < 4; ++k) byte(static_cast<int>((acc >> (8 * k)) & 0xFF));
      acc >>= 32;
      nb -= 32;
    }
  }
  __device__ __forceinline__ void flush() {
    for (; nb > 0; nb = max(nb - 8, 0)) {
      byte(static_cast<int>(acc & 0xFF));
      acc >>= 8;
    }
  }
};

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(tpucomp::kFullMask, v); }

template <int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zstd_encode_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                   const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
                   const int32_t* __restrict__ nxt, int batch, int cap, int cap_seq,
                   const int32_t* __restrict__ cst, const int32_t* __restrict__ huf_meta,
                   const uint8_t* __restrict__ tree, const int32_t* __restrict__ fse_tab,
                   const uint8_t* __restrict__ nc, int32_t* __restrict__ seq_scratch,
                   uint8_t* __restrict__ lit_scratch, int32_t* __restrict__ freq_out,
                   int32_t* __restrict__ sch_out, uint8_t* __restrict__ out, int out_cap,
                   int32_t* __restrict__ out_sizes, int32_t* __restrict__ statuses) {
  __shared__ int32_t s_tab[kWarpsPerBlock][kHist];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  const int size = min(max(sizes[chunk], 0), cap);
  int32_t* t = s_tab[wi];  // hist: byte counts, then code counts; full: the Huffman codes
  for (int i = lane; i < kHist; i += 32)
    t[i] = M == kFullMode ? (i < 256 ? huf_meta[static_cast<size_t>(chunk) * kHufMeta + i] : 0)
                          : 0;
  __syncwarp();
  // full: the sequences (ll | (ml - 3) << 16, then the offset values) and the literals
  int32_t* seqa = M == kFullMode ? seq_scratch + static_cast<size_t>(chunk) * 2 * cap_seq : nullptr;
  int32_t* seqb = M == kFullMode ? seqa + cap_seq : nullptr;
  uint8_t* lit = M == kFullMode ? lit_scratch + row : nullptr;

  // ---- the walk ----
  const int32_t* c4 = cand + row;
  const int32_t* c8 = cand8 + row;
  const int32_t* nx = nxt + row;
  const int mflimit = size - kMinMatch + 1;
  int anchor = 0, scan = 0, litcnt = 0, nseq = 0;
  int r0 = 1, r1 = 4, r2 = 8;  // the repeat-offset stack, RFC 8878's initial values
  while (scan < mflimit) {
    const int nm = nx[scan];
    if (nm >= mflimit || nseq >= cap_seq) break;  // the rest is literal
    const int c4p = c4[nm], c8p = c8[nm];
    const int p4 = c4p >= 0 ? c4p : c8p;
    const int p8 = c8p >= 0 ? c8p : p4;
    const int fcap = size - (nm + kMinMatch);
    const int l4 = tpucomp::warp_match_len(in, nm + kMinMatch, p4 + kMinMatch, fcap, lane);
    const int l8 =
        p8 != p4 ? tpucomp::warp_match_len(in, nm + kMinMatch, p8 + kMinMatch, fcap, lane) : l4;
    const bool use8 = l8 > l4;
    const int src = use8 ? p8 : p4;
    const int c = nm - src;
    int nm2 = nm, src2 = src;
    while (nm2 > anchor && src2 > 0 && in[nm2 - 1] == in[src2 - 1]) {
      --nm2;
      --src2;
    }
    const int ml = nm - nm2 + kMinMatch + (use8 ? l8 : l4);
    const int ll = nm2 - anchor;
    const bool is_rep = c == r0 || c == r1 || c == r2;
    if (!(is_rep || ml * 5 >= hibit(c) + 18)) {  // the cost gate
      scan = nm + 1;
      continue;
    }
    if (M == kHistMode) {
      for (int i = anchor + lane; i < nm2; i += 32) atomicAdd(&t[in[i]], 1);
    } else {
      tpucomp::warp_copy(lit + litcnt, in + anchor, ll, lane);
    }
    const bool with_lit = ll > 0;
    const int ofv = with_lit ? (c == r0 ? 1 : c == r1 ? 2 : c == r2 ? 3 : c + 3)
                             : (c == r1 ? 1 : c == r2 ? 2 : c + 3);
    const bool keep = with_lit && ofv == 1;
    const bool swap = (with_lit && ofv <= 2) || (!with_lit && ofv == 1);
    const int n0 = keep ? r0 : c, n1 = keep ? r1 : r0, n2 = swap ? r2 : r1;
    r0 = n0, r1 = n1, r2 = n2;
    if (lane == 0) {
      if (M == kHistMode) {
        ++t[256 + ll_code(cst, ll)];
        ++t[256 + 36 + ml_code(cst, ml - 3)];
        ++t[256 + 89 + min(hibit(ofv), 31)];
      } else {
        seqa[nseq] = static_cast<int32_t>(static_cast<uint32_t>(ll) |
                                          (static_cast<uint32_t>(ml - 3) << 16));
        seqb[nseq] = ofv;
      }
    }
    ++nseq;
    litcnt += ll;
    anchor = scan = nm2 + ml;
  }

  if (M == kHistMode) {
    for (int i = anchor + lane; i < size; i += 32) atomicAdd(&t[in[i]], 1);
    __syncwarp();
    for (int i = lane; i < kHist; i += 32) {
      if (i < 256)
        freq_out[static_cast<size_t>(chunk) * 256 + i] = t[i];
      else
        sch_out[static_cast<size_t>(chunk) * 121 + i - 256] = t[i];
    }
    return;
  }

  // ---- full: the literal section ----
  tpucomp::warp_copy(lit + litcnt, in + anchor, size - anchor, lane);
  __syncwarp();  // lane 0's sequence stores land before lane 0 reads them all back
  const int n_lit = litcnt + size - anchor;
  const int32_t* meta = huf_meta + static_cast<size_t>(chunk) * kHufMeta;
  const int tree_b = meta[256];
  uint8_t* orow = out + static_cast<size_t>(chunk) * out_cap;
  const tpucomp::OutRow w{orow, out_cap, lane};
  bool use_huf = false;
  int sb[4] = {0, 0, 0, 0};
  const int per = (n_lit + 3) >> 2;
  if (meta[257] > 0 && n_lit >= 64) {
    int s_total = 0;
    for (int k = 0; k < 4; ++k) {  // each stream's bytes: its code lengths and the sentinel
      const int lo = k * per, hi = k < 3 ? lo + per : n_lit;
      int bits = 0;
      for (int i = lo + lane; i < hi; i += 32) bits += t[lit[i]] >> 12;
      sb[k] = (warp_sum(bits) + 1 + 7) >> 3;
      s_total += sb[k];
    }
    const int csize = tree_b + 6 + s_total;
    use_huf = 5 + csize < 3 + n_lit;
    if (use_huf) {
      w.copy(18, tree + static_cast<size_t>(chunk) * kTreeCap, min(tree_b, kTreeCap));
      const int jo = 18 + tree_b;
      if (lane < 4) {  // lanes 0-3: the four streams, each backward from its end
        int op = jo + 6;
        for (int k = 0; k < lane; ++k) op += sb[k];
        LaneBits s{orow, out_cap, op, 0, 0};
        const int lo = lane * per, cnt = lane < 3 ? per : n_lit - 3 * per;
        for (int i = lo + cnt - 1; i >= lo; --i) {
          const int pk = t[lit[i]];
          s.put(pk & 0xFFF, pk >> 12);
        }
        s.put(1, 1);
        s.flush();
      }
      if (lane == 0) {
        for (int k = 0; k < 3; ++k) {
          w.put(jo + 2 * k, sb[k] & 0xFF);
          w.put(jo + 2 * k + 1, (sb[k] >> 8) & 0xFF);
        }
        // the 5-byte header: type 2 (compressed), Size_Format 3 (18 + 18 bits)
        const uint32_t lo = 2u | (3u << 2) | ((static_cast<uint32_t>(n_lit) & 0x3FFFF) << 4) |
                            ((static_cast<uint32_t>(csize) & 0x3FF) << 22);
        for (int k = 0; k < 4; ++k) w.put(13 + k, (lo >> (8 * k)) & 0xFF);
        w.put(17, (csize >> 10) & 0xFF);
      }
      __syncwarp();
    }
  }
  int o1;
  if (use_huf) {
    o1 = 18 + tree_b + 6 + sb[0] + sb[1] + sb[2] + sb[3];
  } else {  // raw literals, the 3-byte header (Size_Format 3: a 20-bit size)
    if (lane == 0) {
      w.put(13, (3 << 2) | ((n_lit & 0xF) << 4));
      w.put(14, (n_lit >> 4) & 0xFF);
      w.put(15, (n_lit >> 12) & 0xFF);
    }
    w.copy(16, lit, n_lit);
    o1 = 16 + n_lit;
  }

  // ---- the sequences section ----
  const int32_t* fse = fse_tab + static_cast<size_t>(chunk) * kFseTT;
  auto tab = [fse](int i) { return fse[min(max(i, 0), kFseTT - 1)]; };
  int total;
  if (nseq > 0) {
    const int nc_len = min(tab(kO2Meta + 4), kNcCap);
    if (nc_len > 0) w.copy(o1 + 3, nc + static_cast<size_t>(chunk) * kNcCap, nc_len);
    BitOut bits{w, o1 + 3 + nc_len, 0, 0};
    int s_ll = 0, s_ml = 0, s_of = 0;
    for (int j = 0; j < nseq; ++j) {
      const int i = nseq - 1 - j;
      const uint32_t a = static_cast<uint32_t>(seqa[i]);
      const int ofv = seqb[i];
      const int ll = a & 0xFFFF;
      const int mlv = (a >> 16) & 0xFFFF;
      const int llc = ll_code(cst, ll), mlc = ml_code(cst, mlv), ofc = hibit(ofv);
      const int ofr = min(ofc, 31);
      if (j == 0) {  // the last sequence: the initial states, no bits
        s_ll = tab(kO2LLF + llc);
        s_ml = tab(kO2MLF + mlc);
        s_of = tab(kO2OFF + ofr);
      } else {
        int pk = tab(kO2OF + ofr * 256 + s_of);
        bits.put(s_of - static_cast<int>(static_cast<uint32_t>(pk) >> 14), (pk >> 10) & 0xF);
        const int n_of = pk & 0x3FF;
        pk = tab(kO2ML + mlc * 512 + s_ml);
        bits.put(s_ml - static_cast<int>(static_cast<uint32_t>(pk) >> 14), (pk >> 10) & 0xF);
        const int n_ml = pk & 0x3FF;
        pk = tab(kO2LL + llc * 512 + s_ll);
        bits.put(s_ll - static_cast<int>(static_cast<uint32_t>(pk) >> 14), (pk >> 10) & 0xF);
        s_ll = pk & 0x3FF;
        s_ml = n_ml;
        s_of = n_of;
      }
      const int llpk = cst[kOLLX + llc], mlpk = cst[kOMLX + mlc];
      bits.put(ll - static_cast<int>(static_cast<uint32_t>(llpk) >> 8), llpk & 0xFF);
      bits.put(mlv + 3 - static_cast<int>(static_cast<uint32_t>(mlpk) >> 8), mlpk & 0xFF);
      bits.put(ofv - (1 << ofc), ofc);
    }
    bits.put(s_ml, tab(kO2Meta + 1));
    bits.put(s_of, tab(kO2Meta + 2));
    bits.put(s_ll, tab(kO2Meta));
    bits.put(1, 1);  // the padding bit
    bits.flush();
    total = bits.op;
  } else {
    total = o1 + 1;
  }

  // ---- the block: compressed, or raw when that is not longer ----
  __syncwarp();  // lane 0's stream bytes land before the whole warp rewrites
  int bh;
  if (total >= 13 + size) {
    w.copy(13, in, size);
    total = 13 + size;
    bh = 1 | (size << 3);
  } else {
    if (lane == 0) {
      w.put(o1, nseq == 0 ? 0 : 128 + (nseq >> 8));
      if (nseq > 0) {
        w.put(o1 + 1, nseq & 0xFF);
        w.put(o1 + 2, tab(kO2Meta + 3));
      }
    }
    bh = 1 | (2 << 1) | ((total - 13) << 3);
  }
  if (lane == 0) {  // the frame header: magic, FHD (4-byte FCS), window, FCS, block
    const int bl = 32 - __clz(max(size - 1, 1));
    const int wl = size <= 1024 ? 10 : max(bl, 10);
    const int head[13] = {0x28, 0xB5, 0x2F, 0xFD, 0x80, (wl - 10) << 3,
                          size & 0xFF, (size >> 8) & 0xFF, (size >> 16) & 0xFF,
                          (size >> 24) & 0xFF, bh & 0xFF, (bh >> 8) & 0xFF, (bh >> 16) & 0xFF};
    for (int k = 0; k < 13; ++k) w.put(k, head[k]);
  }
  const bool too_big = total > out_cap;
  const int osz = too_big ? 0 : total;
  __syncwarp();  // order lane 0's stores before the zero fill
  tpucomp::warp_fill(orow, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = osz;
    statuses[chunk] = too_big ? kOutputTooSmall : kSuccess;
  }
}

template <int M>
int launch(const uint8_t* data, const int32_t* sizes, const int32_t* cand, const int32_t* cand8,
           const int32_t* nxt, int batch, int cap, int cap_seq, const int32_t* cst,
           const int32_t* huf_meta, const uint8_t* tree, const int32_t* fse_tab,
           const uint8_t* nc, int32_t* seq_scratch, uint8_t* lit_scratch, int32_t* freq,
           int32_t* sch, uint8_t* out, int out_cap, int32_t* out_sizes, int32_t* statuses,
           void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  zstd_encode_kernel<M><<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, batch, cap, cap_seq, cst, huf_meta, tree, fse_tab, nc,
      seq_scratch, lit_scratch, freq, sch, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).  cst is ops/cuda/zstd_encode.py's CONST; cap_seq the sequence
// slots a chunk may fill (cap / 4 + 8).
extern "C" int tpucomp_zstd_encode_hist(const uint8_t* data, const int32_t* sizes,
                                        const int32_t* cand, const int32_t* cand8,
                                        const int32_t* nxt, int batch, int cap, int cap_seq,
                                        const int32_t* cst, int32_t* freq, int32_t* sch,
                                        void* stream) {
  return launch<kHistMode>(data, sizes, cand, cand8, nxt, batch, cap, cap_seq, cst, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr, freq, sch, nullptr, 0,
                           nullptr, nullptr, stream);
}

// huf_meta int32[B, 258] (code | nbits << 12 per byte, tree bytes, huf_ok),
// tree uint8[B, 176], fse_tab int32[B, 54016], nc uint8[B, 512]; scratch:
// seq_scratch int32[B, 2 * cap_seq], lit_scratch uint8[B, cap].
extern "C" int tpucomp_zstd_encode_full(const uint8_t* data, const int32_t* sizes,
                                        const int32_t* cand, const int32_t* cand8,
                                        const int32_t* nxt, int batch, int cap, int cap_seq,
                                        const int32_t* cst, const int32_t* huf_meta,
                                        const uint8_t* tree, const int32_t* fse_tab,
                                        const uint8_t* nc, int32_t* seq_scratch,
                                        uint8_t* lit_scratch, uint8_t* out, int out_cap,
                                        int32_t* out_sizes, int32_t* statuses, void* stream) {
  return launch<kFullMode>(data, sizes, cand, cand8, nxt, batch, cap, cap_seq, cst, huf_meta,
                           tree, fse_tab, nc, seq_scratch, lit_scratch, nullptr, nullptr, out,
                           out_cap, out_sizes, statuses, stream);
}
