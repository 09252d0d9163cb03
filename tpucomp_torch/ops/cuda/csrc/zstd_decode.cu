// Batched Zstandard (RFC 8878) frame walk, one warp per chunk, for the
// status alone.  Both decode wrappers run the block-parallel passes of
// zstd_passes.cu.  Their chain pass gives no block records to a frame whose
// smallest output (raw and RLE sizes, regenerated literals, 3 bytes a
// sequence) already passes out_cap, since such a frame can only end
// ERROR_CANNOT_DECOMPRESS or ERROR_OUTPUT_BUFFER_TOO_SMALL, and its scratch
// is not bounded by out_cap.  This walk settles which of the two: it decodes
// the frame as the reference's kernel does and writes nothing but the status
// (no output row, no literal scratch).
//
// Follows the TPU kernel tpucomp/ops/pallas/zstd_decode.py::_kernel (:109)
// behind both of its wrappers, decompress_batch (:1231) and
// decompress_batch_big (:1296), which differ only in lit_cap, the bound on a
// block's regenerated literals (the caller passes it).  The statuses it
// keeps from the reference:
//  * regenerated literals above lit_cap, a block past csize, literals past the
//    block, a corrupt table, Huffman stream or sequence stream, an offset of
//    0 or past the output, and a frame that ends before its last block are
//    ERROR_CANNOT_DECOMPRESS;
//  * output past out_cap is never written but op advances, so an error later
//    in the frame wins over ERROR_OUTPUT_BUFFER_TOO_SMALL;
//  * backward streams zero-pad from the bottom on underflow, and a stream
//    must end with exactly 0 bits left;
//  * bytes at and past comp_cap read as 0; a negative index reads byte i & 3
//    of the row (the reference's clamped word read).
// The walk stops at the first error (the reference walks on without effect).
// Positions and op are 64-bit.
//
// Bound: bytes; the walk reads each compressed byte of its frames once and
// writes a status.  Frames are independent and their walks serial, so each
// chunk gets a warp.  Lane 0 builds the FSE tables (3 x 512 + 64 entries)
// and the Huffman table (2048 entries) in the warp's shared memory (10.9 KB
// a warp); lanes 0-3 check the four literal streams at once; the sequences
// are decoded by all lanes in lockstep (broadcast reads of the row and the
// tables).  A 16 MiB frame still takes its 128 or more blocks in turn.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "zstd_frame.cuh"

namespace {

using namespace tpucomp_zstd;

constexpr int kWarpsPerBlock = 4;
constexpr int kOverflow = 1;  // the chain pass's mark (zstd_passes.cu): walk this frame

// Lane 0: the three sequence tables of a block (modes of scm) from sq on ->
// true on error; sq and the accuracy logs (LL, OF, ML) by reference.
__device__ bool seq_tables(const Scratch& sc, const Row& in, int scm, long long& sq, int* accs) {
  for (int t = 0; t < 3; ++t)
    if (seq_table(sc, in, t, (scm >> (6 - 2 * t)) & 3, sq, accs[t])) return true;
  return false;
}

// The frame walk; every lane calls it and leaves it together.  -> true on
// error; op (the bytes the frame regenerates) by reference.
__device__ bool walk(const Scratch& sc, const Row& in, long long csize, long long lit_cap, int lane,
                     long long& op) {
  using tpucomp::kFullMask;
  long long pos = frame_start(in, csize);
  if (pos < 0) return true;
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
      pos += bsize;
      op += bsize;
      continue;
    }
    if (btype == 1) {  // RLE
      if (pos + 1 > csize) return true;
      pos += 1;
      op += bsize;
      continue;
    }
    // ---- compressed block: literals section
    const long long block_end = pos + bsize;
    if (block_end > csize) return true;
    const Literals L = literals(in, pos);
    const int lit_type = L.type, fmt = L.fmt;
    const long long regen = L.regen, lit_end = L.end;
    if (regen > lit_cap || lit_end > block_end) return true;
    if (lit_type >= 2) {  // Huffman-coded, with a tree or treeless (raw and RLE need no check)
      long long spos = L.spos;
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
      const bool e = huf_literals<false>(sc.huf, in, fmt, regen, spos, lit_end, nullptr, hbits,
                                         lane);
      __syncwarp();  // every lane is done reading the table before a later block rewrites it
      if (__any_sync(kFullMask, e)) return true;
    }
    // ---- sequences section
    long long sq;
    const long long nseq = nseq_at(in, lit_end, sq);
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
        lit_pos += ll;
        op += ll;
        if (off > op) return true;
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
    op += regen - lit_pos;  // trailing literals
    pos = block_end;
  }
  return !done;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zstd_settle_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes,
                   int batch, int comp_cap, int out_cap, int lit_cap,
                   int32_t* __restrict__ statuses) {
  __shared__ int32_t s_tab[kWarpsPerBlock][kFseTotal];
  __shared__ uint16_t s_huf[kWarpsPerBlock][kHufCap];
  __shared__ int16_t s_norm[kWarpsPerBlock][64];
  __shared__ uint8_t s_w[kWarpsPerBlock][288];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch || statuses[chunk] != kOverflow) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const Scratch sc{s_tab[wi], s_huf[wi], s_norm[wi], s_w[wi]};
  const Row in{comp + static_cast<size_t>(chunk) * comp_cap, comp_cap};
  long long op = 0;
  const bool err = walk(sc, in, comp_sizes[chunk], lit_cap, lane, op);
  if (lane == 0)
    statuses[chunk] = err ? kCannotDecompress : (op > out_cap ? kOutputTooSmall : kSuccess);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// statuses int32[batch], in and out: each frame whose status is kOverflow
// (1) is walked and gets its status; the others are left as they are.
extern "C" int tpucomp_zstd_settle(const uint8_t* comp, const int32_t* comp_sizes, int batch,
                                   int comp_cap, int out_cap, int lit_cap, int32_t* statuses,
                                   void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  zstd_settle_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, batch, comp_cap, out_cap, lit_cap, statuses);
  return static_cast<int>(cudaGetLastError());
}
