// Batched Zstandard (RFC 8878) frame decode as block-parallel passes.
//
// Replaces the TPU kernel tpucomp/ops/pallas/zstd_decode.py::_kernel (:109)
// behind both of its wrappers: decompress_batch (:1231, lit_cap
// min(128 KiB, round_up(out_cap, 128))) and decompress_batch_big (:1296, the
// 16 MiB regime, lit_cap 128 KiB).  That kernel walks one frame per grid step
// on the scalar core, with the output in a sliding VMEM window flushed to HBM
// by DMA and far matches staged back from HBM.  On the card the output row
// lives in device memory and any CTA reads it at any offset, so the window
// machinery has no counterpart; what the card lacks is the TPU's one fast
// serial core, so a frame's blocks are decoded side by side instead of in
// line.  The plain version of each pass is
// tpucomp_torch/ops/cuda/zstd_passes.py; run together they equal the frame
// walk (zstd_decode.cu, which settles the frames that cannot fit), statuses
// included.
//
// Bound: bytes.  A call must read each compressed byte once and write each
// output byte once (B x out_cap, the zero tail included).  What each pass
// does about it:
//   chain   (one thread a frame) reads only the 3-byte block headers and the
//           literals/sequences headers, a few bytes a block; run twice (count,
//           then fill the block records).  The last CTA to finish counting
//           sums the counts into each frame's bases and the totals, and one
//           host read of the totals between the two runs sizes the scratch.
//           Raw and RLE blocks of size 0 get no record.  A frame whose
//           smallest output (raw and RLE sizes, regenerated literals, 3 bytes
//           a sequence) already passes out_cap can only end 12 or 15 and gets
//           no record: the status-only walk (zstd_decode.cu) settles it.  So
//           the scratch of a frame stays below its out_cap.
//   entropy (one CTA of two warps a compressed block; all blocks of all
//           frames at once: 4 x 16 MiB is 512 blocks, about four CTAs an SM)
//           builds the block's tables in shared memory, rebuilt from the
//           block the chain named for a repeat mode or a treeless block.
//           Warp 0 decodes the literals (lanes 0-3 the four Huffman streams)
//           straight into the literal scratch, while lane 0 of warp 1 decodes
//           the sequences into (lit_pos, out_pos, ll, ml, offset code), with
//           repeat offsets kept symbolic: a concrete offset, or code
//           -1 - (j + 4 d) for "incoming r_j minus d".  The compressed bytes
//           are read once, through Row::load8's aligned 8-byte loads, and the
//           bit readers keep 32-bit positions.  A block in error leaves its
//           scratch zero.  The literals are not staged in shared memory:
//           128 KiB a CTA would hold one CTA an SM, and the serial streams
//           need many CTAs an SM to hide their latency.
//   scan    (one thread a frame) composes the blocks in order: output starts
//           (an exclusive sum of block sizes), incoming repeat offsets from
//           (1, 4, 8), the frame's size and status.
//   resolve (one CTA a block) makes every offset concrete and checks it
//           against the frame-global output position (12 if an offset is
//           not positive or reaches before the frame).
//   zero    writes sizes and statuses, and zeroes each row past its size
//           (16-byte stores).
//   execute (one CTA a block) writes every output byte of a frame that
//           succeeded, once, in coalesced stores.  The
//           literal runs go first, a lane a sequence.  Then the matches, 16 KiB
//           of output at a time: each match byte p gets a pointer to the
//           byte it copies, (p - d) mod off into the window before the match
//           (so an overlapping match is no chain), the pointers jump to their
//           roots in a few rounds (a literal, or a byte before the chunk,
//           already final), and every byte takes its root's value.  The
//           block's output (at most 128 KiB) is staged in shared memory
//           beside the pointers, so reads inside the block stay on the SM.
//           Where frames have more than one block, a root in an earlier
//           block is read from device memory once that block's progress,
//           published after each chunk (release store, acquire load), covers
//           it.  CTAs then take blocks by ticket in the order (block index in
//           the frame, frame), so a block only waits on lower tickets, whose
//           CTAs already run: no deadlock.  Chained frames (libzstd's matches
//           reach across blocks) run their blocks in turn, so each block runs
//           on the wide shape (16 warps, 16 KiB a round: 64 KiB of pointers);
//           the port's own frames (block-local matches) never wait.  Where
//           every frame is one block (64 KiB chunks) nothing waits or is
//           published, and the narrow shape (8 warps, 8 KiB a round) lets
//           two CTAs share an SM.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "zstd_frame.cuh"

namespace {

using namespace tpucomp_zstd;
using tpucomp::kFullMask;

// a block record (int64 fields; zstd_passes.py names them the same)
enum {
  F_FRAME, F_TYPE, F_POS, F_BSIZE, F_REGEN, F_SPOS, F_LIT_END, F_NSEQ, F_SQ, F_SRC_LL, F_SRC_OF,
  F_SRC_ML, F_SRC_HUF, F_LIT_OFF, F_SEQ_OFF, F_LOCAL, NF
};
// a sequence (int32 fields)
enum { S_LPOS, S_OPOS, S_LL, S_ML, S_OFF, NS };
constexpr int kOverflow = 1;  // chain status: the walk settles the frame
constexpr long long kInt32Max = 2147483647LL;
constexpr int kChainThreads = 128;
constexpr int kEntropyThreads = 64;
constexpr int kResolveThreads = 256;
constexpr int kZeroThreads = 256;
constexpr long long kZeroSeg = 1 << 16;
constexpr int kStageMax = 1 << 17;  // a block's output staged in shared memory up to this
constexpr int kShort = 16;          // longer literal runs go to a warp, match parts to the CTA
// execute's two shapes (output bytes a match round resolves, threads): the
// wide one where blocks wait on earlier blocks of their frame, since such a
// chain of blocks runs one after another and a block's own speed sets it; the
// narrow one where no frame has a second block, so that more CTAs share an SM
constexpr int kWideChunk = 16384, kWideThreads = 512;
constexpr int kNarrowChunk = 8192, kNarrowThreads = 256;

__device__ __forceinline__ int msym_of(int t) { return t == 0 ? 35 : t == 1 ? 31 : 52; }

// The offset of code c given the incoming repeat offsets r0, r1, r2.
__device__ __forceinline__ long long value_of(int c, long long r0, long long r1, long long r2) {
  if (c > 0) return c;
  const int k = -1 - c;
  const long long r = (k & 3) == 0 ? r0 : (k & 3) == 1 ? r1 : r2;
  return r - (k >> 2);
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A byte of device memory through L2 (another CTA, or this warp, wrote it).
__device__ __forceinline__ uint8_t ld_cg(const uint8_t* p) {
  unsigned v;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return static_cast<uint8_t>(v);
}

// ------------------------------------------------------------------ 1 chain

// The block chain of one frame: res = (blocks, sequences, literals, status:
// 0, kOverflow or 12).  With blk, the records go to blk from the frame's
// base = (first block, first sequence, first literal).
__device__ void chain_frame(const Row& in, long long csize, long long out_cap, long long lit_cap,
                            long long f, const long long* base, long long* blk, long long* res) {
  res[0] = res[1] = res[2] = 0;
  res[3] = kCannotDecompress;
  long long pos = frame_start(in, csize);
  if (pos < 0) return;
  const long long b0 = base ? base[0] : 0, s0 = base ? base[1] : 0, l0 = base ? base[2] : 0;
  long long nblk = 0, nseq_t = 0, nlit = 0, minout = 0, tree = -1;
  long long src[3] = {-1, -1, -1};
  bool done = false;
  while (!done && pos + 3 <= csize) {
    const uint32_t bh = in.getb(pos) | (in.getb(pos + 1) << 8) | (in.getb(pos + 2) << 16);
    done = bh & 1;
    const int btype = (bh >> 1) & 3;
    const long long bsize = bh >> 3;
    pos += 3;
    if (btype == 3 || bsize > kBlockCap) return;
    long long rec[NF];
    bool have = false;
    if (btype <= 1) {  // raw, RLE
      const long long adv = btype == 0 ? bsize : 1;
      if (pos + adv > csize) return;
      if (bsize) {
        have = true;
        for (int k = 0; k < NF; ++k) rec[k] = (k >= F_SRC_LL && k <= F_SRC_HUF) ? -1 : 0;
        rec[F_FRAME] = f;
        rec[F_TYPE] = btype;
        rec[F_POS] = pos;
        rec[F_BSIZE] = bsize;
        rec[F_LOCAL] = nblk;
      }
      minout += bsize;
      pos += adv;
    } else {  // compressed
      const long long block_end = pos + bsize;
      if (block_end > csize) return;
      const Literals L = literals(in, pos);
      if (L.regen > lit_cap || L.end > block_end || (L.type == 3 && tree < 0)) return;
      const long long me = b0 + nblk;
      if (L.type == 2) tree = me;
      long long sq;
      const long long nseq = nseq_at(in, L.end, sq);
      long long srcs[3] = {-1, -1, -1};
      if (nseq > 0) {
        const int scm = static_cast<int>(in.getb(sq));
        if (scm & 3) return;
        for (int t = 0; t < 3; ++t) {
          if (((scm >> (6 - 2 * t)) & 3) == 3) {
            srcs[t] = src[t];
          } else {
            srcs[t] = src[t] = me;
          }
        }
      }
      have = true;
      rec[F_FRAME] = f;
      rec[F_TYPE] = 2 | (L.type << 2);
      rec[F_POS] = pos;
      rec[F_BSIZE] = bsize;
      rec[F_REGEN] = L.regen;
      rec[F_SPOS] = L.spos;
      rec[F_LIT_END] = L.end;
      rec[F_NSEQ] = nseq;
      rec[F_SQ] = sq;
      rec[F_SRC_LL] = srcs[0];
      rec[F_SRC_OF] = srcs[1];
      rec[F_SRC_ML] = srcs[2];
      rec[F_SRC_HUF] = L.type >= 2 ? tree : -1;
      rec[F_LIT_OFF] = l0 + nlit;
      rec[F_SEQ_OFF] = s0 + nseq_t;
      rec[F_LOCAL] = nblk;
      minout += L.regen + 3 * nseq;
      nlit += L.regen;
      nseq_t += nseq;
      pos = block_end;
    }
    if (have) {
      if (blk) {
        long long* dst = blk + (b0 + nblk) * NF;
        for (int k = 0; k < NF; ++k) dst[k] = rec[k];
      }
      ++nblk;
    }
  }
  if (!done) return;
  if (minout > out_cap) {
    res[3] = kOverflow;
    return;
  }
  res[0] = nblk;
  res[1] = nseq_t;
  res[2] = nlit;
  res[3] = kSuccess;
}

// One CTA, after every frame is counted: each frame's first block, sequence
// and literal (an exclusive sum of the counts: each thread sums a run of
// frames, thread 0 sums the runs), and tally[1..5] = blocks, sequences,
// literals, frames to settle, the most blocks a frame has.
__device__ void tally_counts(const long long* fcount, int batch, long long* bases,
                             long long* tally) {
  __shared__ long long s_run[kChainThreads][5];
  const int t = threadIdx.x, per = (batch + kChainThreads - 1) / kChainThreads;
  const int lo = t * per < batch ? t * per : batch, hi = lo + per < batch ? lo + per : batch;
  long long a[5] = {0, 0, 0, 0, 0};
  for (int f = lo; f < hi; ++f) {
    for (int k = 0; k < 3; ++k) a[k] += __ldcg(fcount + f * 4 + k);
    a[3] += __ldcg(fcount + f * 4 + 3) == kOverflow;
    const long long nb = __ldcg(fcount + f * 4);
    a[4] = nb > a[4] ? nb : a[4];
  }
  for (int k = 0; k < 5; ++k) s_run[t][k] = a[k];
  __syncthreads();
  if (t == 0) {
    long long acc[5] = {0, 0, 0, 0, 0};
    for (int u = 0; u < kChainThreads; ++u) {
      for (int k = 0; k < 3; ++k) {
        const long long v = s_run[u][k];
        s_run[u][k] = acc[k];
        acc[k] += v;
      }
      acc[3] += s_run[u][3];
      acc[4] = s_run[u][4] > acc[4] ? s_run[u][4] : acc[4];
    }
    for (int k = 0; k < 5; ++k) tally[1 + k] = acc[k];
  }
  __syncthreads();
  long long run[3] = {s_run[t][0], s_run[t][1], s_run[t][2]};
  for (int f = lo; f < hi; ++f) {
    for (int k = 0; k < 3; ++k) {
      bases[f * 3 + k] = run[k];
      run[k] += __ldcg(fcount + f * 4 + k);
    }
  }
}

__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes, int batch,
             int comp_cap, int out_cap, int lit_cap, long long* __restrict__ fcount,
             long long* __restrict__ bases, long long* __restrict__ blk,
             long long* __restrict__ tally) {
  __shared__ bool s_last;
  const int f = blockIdx.x * kChainThreads + threadIdx.x;
  if (f < batch) {
    const Row in{comp + static_cast<size_t>(f) * comp_cap, comp_cap};
    long long res[4];
    if (blk == nullptr) {
      chain_frame(in, comp_sizes[f], out_cap, lit_cap, f, nullptr, nullptr, res);
      for (int k = 0; k < 4; ++k) fcount[f * 4 + k] = res[k];
    } else if (fcount[f * 4 + 3] == kSuccess) {
      chain_frame(in, comp_sizes[f], out_cap, lit_cap, f, bases + f * 3, blk, res);
    }
  }
  if (blk != nullptr) return;
  // the last CTA to finish counting tallies (tally[0] counts the CTAs done)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(reinterpret_cast<unsigned long long*>(tally), 1ULL) == gridDim.x - 1;
  __syncthreads();
  if (s_last) tally_counts(fcount, batch, bases, tally);
}

// ---------------------------------------------------------------- 2 entropy

// Table t as block srec defined it: its descriptions before t skipped, then t
// built -> true on error; acc by reference.
__device__ bool source_table(const Scratch& sc, const Row& in, const long long* srec, int t,
                             int& acc) {
  long long sq = srec[F_SQ];
  const int scm = static_cast<int>(in.getb(sq));
  ++sq;
  for (int u = 0; u < t; ++u) {
    const int mode = (scm >> (6 - 2 * u)) & 3;
    if (mode == 1) {
      ++sq;
    } else if (mode == 2) {
      int a, ns;
      long long bp = sq * 8;
      if (read_ncount(sc.norm, in, bp, msym_of(u), a, ns)) return true;
      sq = (bp + 7) >> 3;
    }
  }
  return seq_table(sc, in, t, (scm >> (6 - 2 * t)) & 3, sq, acc);
}

// One thread: the tables and the sequences of block r -> true on error;
// writes out[nseq][NS], the match lengths' sum and the outgoing codes.
__device__ bool sequences(const Scratch& sc, const Row& in, const long long* blk,
                          const long long* r, int32_t* out, long long& mlsum, int* sym) {
  const long long nseq = r[F_NSEQ], regen = r[F_REGEN];
  const long long block_end = r[F_POS] + r[F_BSIZE];
  mlsum = 0;
  if (nseq == 0) return false;
  long long sq = r[F_SQ];
  const int scm = static_cast<int>(in.getb(sq));
  ++sq;
  int accs[3];
  for (int t = 0; t < 3; ++t) {
    const int mode = (scm >> (6 - 2 * t)) & 3;
    if (mode == 3) {
      const long long s = r[F_SRC_LL + t];
      if (s < 0) {
        long long z = 0;
        seq_table(sc, in, t, 0, z, accs[t]);
      } else if (source_table(sc, in, blk + s * NF, t, accs[t])) {
        return true;
      }
    } else if (seq_table(sc, in, t, mode, sq, accs[t])) {
      return true;
    }
  }
  Bwd st;
  const bool e = st.init(in, sq, block_end - sq);
  uint32_t ll_s = st.read(in, accs[0]);
  uint32_t of_s = st.read(in, accs[1]);
  uint32_t ml_s = st.read(in, accs[2]);
  if (e || st.left < 0) return true;
  int r0 = -1, r1 = -2, r2 = -3;
  long long lit_pos = 0, op = 0;
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
    int off;
    if (ofv <= 3) {  // repeat offsets, as codes
      const long long ridx = ofv - 1 + (ll == 0 ? 1 : 0);
      off = ridx == 0 ? r0 : ridx == 1 ? r1 : ridx == 2 ? r2 : (r0 > 0 ? r0 - 1 : r0 - 4);
      if (ridx > 0) {
        r2 = ridx >= 2 ? r1 : r2;
        r1 = r0;
        r0 = off;
      }
    } else {
      off = static_cast<int>(ofv - 3);
      r2 = r1;
      r1 = r0;
      r0 = off;
    }
    if (off == 0 || lit_pos + ll > regen) return true;  // a concrete offset of 0
    int32_t* q = out + i * NS;
    q[S_LPOS] = static_cast<int32_t>(lit_pos);
    q[S_OPOS] = static_cast<int32_t>(op < kInt32Max ? op : kInt32Max);
    q[S_LL] = static_cast<int32_t>(ll);
    q[S_ML] = static_cast<int32_t>(ml);
    q[S_OFF] = off;
    lit_pos += ll;
    op += ll + ml;
    mlsum += ml;
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
  sym[0] = r0;
  sym[1] = r1;
  sym[2] = r2;
  return false;
}

__global__ void __launch_bounds__(kEntropyThreads)
entropy_kernel(const uint8_t* __restrict__ comp, int comp_cap, const long long* __restrict__ blk,
               uint8_t* __restrict__ lits, int32_t* __restrict__ seqs,
               long long* __restrict__ bout, int32_t* __restrict__ bsym,
               int32_t* __restrict__ berr) {
  __shared__ int32_t s_tab[kFseTotal];
  __shared__ uint16_t s_huf[kHufCap];
  __shared__ int16_t s_norm[2][64];
  __shared__ uint8_t s_w[288];
  __shared__ int s_err[2];
  __shared__ long long s_mlsum;
  __shared__ int s_sym[3];
  const int b = blockIdx.x;
  const long long* r = blk + static_cast<size_t>(b) * NF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if ((r[F_TYPE] & 3) != 2) {  // raw, RLE: their size, no offsets
    if (tid == 0) {
      bout[b] = r[F_BSIZE];
      berr[b] = 0;
      for (int k = 0; k < 3; ++k) bsym[b * 3 + k] = -1 - k;
    }
    return;
  }
  const int lit_type = (r[F_TYPE] >> 2) & 3;
  const long long regen = r[F_REGEN], spos = r[F_SPOS], nseq = r[F_NSEQ];
  const Row in{comp + static_cast<size_t>(r[F_FRAME]) * comp_cap, comp_cap};
  uint8_t* lit = lits + r[F_LIT_OFF];
  int32_t* sq = seqs + r[F_SEQ_OFF] * NS;
  if (warp == 0) {  // the literals
    bool e = false;
    if (lit_type == 0) {
      tpucomp::warp_copy_bounded(lit, in.p, spos, in.cap, regen, lane);
    } else if (lit_type == 1) {
      tpucomp::warp_fill(lit, 0, regen, static_cast<uint8_t>(in.getb(spos)), lane);
    } else {
      const Scratch sc{s_tab, s_huf, s_norm[0], s_w};
      long long tree_bytes = 0;
      int mb = 0;
      if (lane == 0) e = huf_tables(sc, in, blk[r[F_SRC_HUF] * NF + F_SPOS], tree_bytes, mb);
      __syncwarp();  // the table is complete before any lane reads it
      e = __shfl_sync(kFullMask, static_cast<int>(e), 0) != 0;
      tree_bytes = __shfl_sync(kFullMask, tree_bytes, 0);
      mb = __shfl_sync(kFullMask, mb, 0);
      if (!e) {
        const int fmt = (in.getb(r[F_POS]) >> 2) & 3;
        e = huf_literals(s_huf, in, fmt, regen, spos + (lit_type == 2 ? tree_bytes : 0),
                         r[F_LIT_END], lit, mb, lane);
      }
      e = __any_sync(kFullMask, e);
    }
    if (lane == 0) s_err[0] = e;
  } else if (lane == 0) {  // the sequences
    const Scratch sc{s_tab, s_huf, s_norm[1], s_w};
    int sym[3] = {-1, -2, -3};
    long long mlsum = 0;
    s_err[1] = sequences(sc, in, blk, r, sq, mlsum, sym);
    s_mlsum = mlsum;
    for (int k = 0; k < 3; ++k) s_sym[k] = sym[k];
  }
  __syncthreads();
  const bool err = s_err[0] || s_err[1];
  if (err) {  // a block in error leaves its scratch zero
    for (long long i = tid; i < regen; i += kEntropyThreads) lit[i] = 0;
    for (long long i = tid; i < nseq * NS; i += kEntropyThreads) sq[i] = 0;
  }
  if (tid == 0) {
    bout[b] = err ? 0 : regen + s_mlsum;
    berr[b] = err;
    for (int k = 0; k < 3; ++k) bsym[b * 3 + k] = err ? -1 - k : s_sym[k];
  }
}

// ------------------------------------------------------------------- 3 scan

__global__ void __launch_bounds__(kChainThreads)
scan_kernel(const long long* __restrict__ fcount, const long long* __restrict__ bases, int batch,
            const long long* __restrict__ bout, const int32_t* __restrict__ bsym,
            const int32_t* __restrict__ berr, int out_cap, long long* __restrict__ bstart,
            long long* __restrict__ bin, long long* __restrict__ fsize,
            int32_t* __restrict__ fstat) {
  const int f = blockIdx.x * kChainThreads + threadIdx.x;
  if (f >= batch) return;
  const long long st = fcount[f * 4 + 3];
  if (st != kSuccess) {
    fsize[f] = 0;
    fstat[f] = static_cast<int32_t>(st);
    return;
  }
  const long long b0 = bases[f * 3], nb = fcount[f * 4];
  long long s = 0, r0 = 1, r1 = 4, r2 = 8;
  bool err = false;
  for (long long b = b0; b < b0 + nb; ++b) {
    bstart[b] = s;
    bin[b * 3] = r0;
    bin[b * 3 + 1] = r1;
    bin[b * 3 + 2] = r2;
    s += bout[b];
    err |= berr[b] != 0;
    const long long n0 = value_of(bsym[b * 3], r0, r1, r2);
    const long long n1 = value_of(bsym[b * 3 + 1], r0, r1, r2);
    const long long n2 = value_of(bsym[b * 3 + 2], r0, r1, r2);
    r0 = n0;
    r1 = n1;
    r2 = n2;
  }
  fsize[f] = s;
  fstat[f] = err ? kCannotDecompress : (s > out_cap ? kOutputTooSmall : kSuccess);
}

// ---------------------------------------------------------------- 4 resolve

__global__ void __launch_bounds__(kResolveThreads)
resolve_kernel(const long long* __restrict__ blk, const int32_t* __restrict__ seqs,
               const long long* __restrict__ bstart, const long long* __restrict__ bin,
               const int32_t* __restrict__ fstat_in, int32_t* __restrict__ fstat_out,
               int32_t* __restrict__ offs) {
  const int b = blockIdx.x;
  const long long* r = blk + static_cast<size_t>(b) * NF;
  const long long f = r[F_FRAME], nseq = r[F_NSEQ], so = r[F_SEQ_OFF];
  const int st = fstat_in[f];
  const bool skip = st != kSuccess && st != kOutputTooSmall;
  const long long base = bstart[b], r0 = bin[b * 3], r1 = bin[b * 3 + 1], r2 = bin[b * 3 + 2];
  for (long long s = threadIdx.x; s < nseq; s += kResolveThreads) {
    if (skip) {
      offs[so + s] = 0;
      continue;
    }
    const int32_t* q = seqs + (so + s) * NS;
    const long long off = value_of(q[S_OFF], r0, r1, r2);
    if (off <= 0 || off > base + q[S_OPOS] + q[S_LL]) atomicExch(fstat_out + f, kCannotDecompress);
    offs[so + s] = static_cast<int32_t>(off > 0 ? off : 0);
  }
}

// ------------------------------------------------------------------- 6 zero

__global__ void __launch_bounds__(kZeroThreads)
zero_kernel(const int32_t* __restrict__ fstat, const long long* __restrict__ fsize, int out_cap,
            uint8_t* __restrict__ out, int32_t* __restrict__ out_sizes,
            int32_t* __restrict__ statuses) {
  const int f = blockIdx.x, tid = threadIdx.x;
  const int st = fstat[f];
  const long long size = st == kSuccess ? fsize[f] : 0;
  if (blockIdx.y == 0 && tid == 0) {
    out_sizes[f] = static_cast<int32_t>(size);
    statuses[f] = st;
  }
  const long long seg = static_cast<long long>(blockIdx.y) * kZeroSeg;
  const long long lo = size > seg ? size : seg;
  const long long hi = seg + kZeroSeg < out_cap ? seg + kZeroSeg : out_cap;
  if (lo >= hi) return;
  uint8_t* p = out + static_cast<size_t>(f) * out_cap;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p + lo);
  const long long head = lo + static_cast<long long>(((a + 15) & ~uintptr_t(15)) - a);
  const long long h = head < hi ? head : hi;
  for (long long i = lo + tid; i < h; i += kZeroThreads) p[i] = 0;
  const long long nvec = (hi - h) >> 4;
  uint4* v = reinterpret_cast<uint4*>(p + h);
  for (long long j = tid; j < nvec; j += kZeroThreads) v[j] = make_uint4(0, 0, 0, 0);
  for (long long i = h + nvec * 16 + tid; i < hi; i += kZeroThreads) p[i] = 0;
}

// ---------------------------------------------------------------- 6 execute

// Lane 0 of the matching warp: wait until the bytes [g0, g1) of the frame
// (all in blocks fb .. b-1) are final.  wm: the frame's bytes [0, wm) are
// known final; wj: the next block the watermark checks.
__device__ void wait_range(const long long* bstart, const long long* bout, const int* progress,
                           long long fb, long long b, long long g0, long long g1, long long& wm,
                           long long& wj) {
  while (wj < b && ld_acquire(progress + wj) >= bout[wj]) {
    wm = bstart[wj] + bout[wj];
    ++wj;
  }
  if (g1 <= wm) return;
  long long lo = fb, hi = b - 1;  // the last block that starts at or before g0
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (bstart[mid] <= g0) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  for (long long j = lo; j < b && bstart[j] < g1; ++j) {
    const long long need = g1 - bstart[j] < bout[j] ? g1 - bstart[j] : bout[j];
    while (ld_acquire(progress + j) < need) __nanosleep(64);
  }
}

// A part of a match, [lo, hi) of the output, that every thread of the CTA
// points (more than kShort bytes): byte p points at base + ((p - d) mod off)
// with base = d - off.  rr0 = (lo - d) mod off, step = threads mod off and
// magic = floor((2^64 - 1) / off) + 1 let each thread find its first
// residue with one multiply: (rr0 + t) mod off = x - umulhi(x, magic) * off
// for x = rr0 + t < 2^32 and 1 < off < 2^31 (off = 1: every residue is 0).
struct LongPart {
  int lo, hi, base, off, rr0, step;
  unsigned long long magic;
};

__device__ __forceinline__ LongPart long_part(int lo, int hi, int d, int off, int threads) {
  const unsigned long long magic = off > 1 ? ~0ULL / static_cast<unsigned>(off) + 1 : 0;
  return LongPart{lo, hi, d - off, off, (lo - d) % off, threads % off, magic};
}

__device__ __forceinline__ int residue(const LongPart& m, unsigned x) {
  if (m.off == 1) return 0;
  return static_cast<int>(x - static_cast<unsigned>(__umul64hi(x, m.magic)) *
                                  static_cast<unsigned>(m.off));
}

// One block's output: device memory and, where the block fits the stage,
// its copy in shared memory, which reads inside the block take.  Negative
// positions are earlier blocks' bytes.
struct BlockOut {
  uint8_t* dst;    // the block's first byte in the output row
  uint8_t* stage;  // nullptr: no stage
  __device__ __forceinline__ void put(long long p, uint8_t v) const {
    dst[p] = v;
    if (stage) stage[p] = v;
  }
  __device__ __forceinline__ uint8_t get(long long p) const {
    return (stage && p >= 0) ? stage[p] : ld_cg(dst + p);
  }
};

template <int kChunk, int kExecThreads>
__global__ void __launch_bounds__(kExecThreads)
execute_kernel(const uint8_t* __restrict__ comp, int comp_cap, const long long* __restrict__ blk,
               int n, const int32_t* __restrict__ order, const uint8_t* __restrict__ lits,
               const int32_t* __restrict__ seqs, const int32_t* __restrict__ offs,
               const long long* __restrict__ bstart, const long long* __restrict__ bout,
               const int32_t* __restrict__ fstat, uint8_t* out, int out_cap, int* sync,
               int stage_cap) {
  extern __shared__ int32_t s_ptr[];  // kChunk pointers, then the stage
  uint8_t* stage = reinterpret_cast<uint8_t*>(s_ptr + kChunk);
  __shared__ LongPart s_long[kExecThreads];  // this window's long match parts
  __shared__ int s_b, s_min, s_max, s_nlong;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* progress = sync;  // sync[n] is the ticket counter
  const bool publish = order != nullptr;  // other blocks of the frame may wait on this one
  if (tid == 0) {
    s_b = publish ? order[atomicAdd(sync + n, 1)] : static_cast<int>(blockIdx.x);
    s_nlong = 0;
  }
  __syncthreads();
  const int b = s_b;
  const long long* r = blk + static_cast<size_t>(b) * NF;
  const long long f = r[F_FRAME];
  if (fstat[f] != kSuccess) return;  // no block of this frame is written or waited on
  const long long base = bstart[b], nb = bout[b];
  uint8_t* dst = out + static_cast<size_t>(f) * out_cap + base;  // the block's first byte
  const int btype = r[F_TYPE] & 3;
  if (btype <= 1) {  // raw, RLE
    const Row in{comp + static_cast<size_t>(f) * comp_cap, comp_cap};
    const long long pos = r[F_POS];
    const uint8_t v = static_cast<uint8_t>(in.getb(pos));
    for (long long i = tid; i < nb; i += kExecThreads)
      dst[i] = btype == 0 ? static_cast<uint8_t>(in.getb(pos + i)) : v;
  } else {
    const BlockOut o{dst, nb <= stage_cap ? stage : nullptr};
    const uint8_t* L = lits + r[F_LIT_OFF];
    const int32_t* S = seqs + r[F_SEQ_OFF] * NS;
    const int32_t* O = offs + r[F_SEQ_OFF];
    const long long nseq = r[F_NSEQ], regen = r[F_REGEN];
    // the literal runs, a lane a sequence (the long ones by the warp), then
    // the trailing literals
    for (long long s0 = static_cast<long long>(warp) * 32; s0 < nseq; s0 += kExecThreads) {
      const long long s = s0 + lane;
      int lpos = 0, opos = 0, ll = 0;
      if (s < nseq) {
        const int32_t* q = S + s * NS;
        lpos = q[S_LPOS];
        opos = q[S_OPOS];
        ll = q[S_LL];
      }
      if (ll <= kShort) {  // the loads all in flight, then the stores
        uint8_t v[kShort];
#pragma unroll
        for (int i = 0; i < kShort; ++i) v[i] = i < ll ? __ldg(L + lpos + i) : 0;
#pragma unroll
        for (int i = 0; i < kShort; ++i)
          if (i < ll) o.put(opos + i, v[i]);
      }
      for (unsigned m = __ballot_sync(kFullMask, ll > kShort); m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const int lp = __shfl_sync(kFullMask, lpos, k), op = __shfl_sync(kFullMask, opos, k);
        const int len = __shfl_sync(kFullMask, ll, k);
        for (int i = lane; i < len; i += 32) o.put(op + i, __ldg(L + lp + i));
      }
    }
    const long long lp = nseq ? S[(nseq - 1) * NS + S_LPOS] + S[(nseq - 1) * NS + S_LL] : 0;
    const long long rest = regen - lp, at = nb - rest;
    for (long long i = tid; i < rest; i += kExecThreads) o.put(at + i, __ldg(L + lp + i));
    if (publish) __threadfence();
    __syncthreads();
    // the matches, kChunk output bytes at a time: each byte of a match points
    // at its source, the pointers jump to their roots (a literal, or a byte
    // before the chunk, final), then every byte takes its root's value
    const long long fb = b - r[F_LOCAL];
    long long wm = 0, wj = fb, s_lo = 0;
    for (int c = 0; c < nb; c += kChunk) {
      const int ce = nb - c < kChunk ? static_cast<int>(nb) : c + kChunk;
      for (int i = tid; i < ce - c; i += kExecThreads) s_ptr[i] = c + i;  // itself: a literal
      __syncthreads();
      while (true) {  // the sequences whose match meets [c, ce), kExecThreads at a time
        const long long s = s_lo + tid;
        int d = 0, e = 0, off = 1;
        if (s < nseq) {
          const int32_t* q = S + s * NS;
          d = q[S_OPOS] + q[S_LL];
          e = d + q[S_ML];
          off = O[s];
        }
        // byte p of a match copies byte (p - d) mod off of the window before
        // it, so it points there: an overlapping match makes no chain
        const int lo = d > c ? d : c, hi = e < ce ? e : ce;
        if (hi - lo <= kShort) {
          int rr = hi > lo ? (lo - d) % off : 0;  // a sequence outside [c, ce) divides nothing
          for (int p = lo; p < hi; ++p) {
            s_ptr[p - c] = d - off + rr;
            if (++rr == off) rr = 0;
          }
        } else {
          const int k = atomicAdd(&s_nlong, 1);
          s_long[k] = long_part(lo, hi, d, off, kExecThreads);
        }
        __syncthreads();
        for (int k = 0; k < s_nlong; ++k) {  // the long ones by every thread
          const LongPart& m = s_long[k];
          int p = m.lo + tid;
          if (p >= m.hi) continue;
          int rr = residue(m, static_cast<unsigned>(m.rr0 + tid));
          for (; p < m.hi; p += kExecThreads) {
            s_ptr[p - c] = m.base + rr;
            rr += m.step;
            if (rr >= m.off) rr -= m.off;
          }
        }
        // the sequences done with: a prefix of the window (their ends increase)
        const int fin = __syncthreads_count(s < nseq && e <= ce);
        if (tid == 0) s_nlong = 0;
        s_lo += fin;
        if (fin < kExecThreads) break;
        __syncthreads();
      }
      __syncthreads();
      bool changed;
      do {  // pointer jumping: a pointer into the chunk at a non-literal takes its pointer
        changed = false;
        for (int i = tid; i < ce - c; i += kExecThreads) {
          const int q = s_ptr[i];
          if (q >= c && q != c + i) {
            const int q2 = s_ptr[q - c];
            if (q2 != q) {
              s_ptr[i] = q2;
              changed = true;
            }
          }
        }
      } while (__syncthreads_or(changed));
      // bytes of earlier blocks (only where a frame has more than one): wait
      // for their range, then every byte's value
      if (publish) {
        int mn = INT_MAX, mx = INT_MIN;
        for (int i = tid; i < ce - c; i += kExecThreads) {
          const int q = s_ptr[i];
          if (q < 0) {
            mn = q < mn ? q : mn;
            mx = q > mx ? q : mx;
          }
        }
        if (tid == 0) {
          s_min = INT_MAX;
          s_max = INT_MIN;
        }
        __syncthreads();
        if (mn <= mx) {
          atomicMin(&s_min, mn);
          atomicMax(&s_max, mx);
        }
        __syncthreads();
        if (s_min <= s_max) {
          if (tid == 0)
            wait_range(bstart, bout, progress, fb, b, base + s_min, base + s_max + 1, wm, wj);
          __syncthreads();
        }
      }
      uint8_t v[kChunk / kExecThreads];  // the loads all in flight, then the stores
#pragma unroll
      for (int k = 0; k < kChunk / kExecThreads; ++k) {
        const int i = tid + k * kExecThreads, q = i < ce - c ? s_ptr[i] : c + i;
        v[k] = q != c + i ? o.get(q) : 0;
      }
#pragma unroll
      for (int k = 0; k < kChunk / kExecThreads; ++k) {
        const int i = tid + k * kExecThreads;
        if (i < ce - c && s_ptr[i] != c + i) o.put(c + i, v[k]);
      }
      if (publish) __threadfence();
      __syncthreads();
      if (publish && tid == 0) st_release(progress + b, ce);  // its bytes before ce are final
    }
  }
  if (publish) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(progress + b, static_cast<int>(nb));
  }
}

template <int kChunk, int kExecThreads>
int launch_execute(const uint8_t* comp, int comp_cap, const long long* blk, int n,
                   const int32_t* order, const uint8_t* lits, const int32_t* seqs,
                   const int32_t* offs, const long long* bstart, const long long* bout,
                   const int32_t* fstat, uint8_t* out, int out_cap, int* sync,
                   cudaStream_t stream) {
  const int stage_cap = out_cap < kStageMax ? out_cap : kStageMax;
  const int smem = kChunk * 4 + stage_cap;
  const cudaError_t e = cudaFuncSetAttribute(execute_kernel<kChunk, kExecThreads>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  execute_kernel<kChunk, kExecThreads><<<n, kExecThreads, smem, stream>>>(
      comp, comp_cap, blk, n, order, lits, seqs, offs, bstart, bout, fstat, out, out_cap, sync,
      stage_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() after
// the launch (0 = ok).

// Pass 1: with blk null, count (fcount int64[batch][4]), then the bases
// (int64[batch][3], written) and tally (int64[6], tally[0] zeroed by the
// caller; tally[1..5] written); else fill the records of the frames whose
// count status is 0 from the bases (read; tally unused).
extern "C" int tpucomp_zstd_chain(const uint8_t* comp, const int32_t* comp_sizes, int batch,
                                  int comp_cap, int out_cap, int lit_cap, long long* fcount,
                                  long long* bases, long long* blk, long long* tally,
                                  void* stream) {
  if (batch <= 0) return 0;
  chain_kernel<<<(batch + kChainThreads - 1) / kChainThreads, kChainThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(comp, comp_sizes, batch, comp_cap, out_cap,
                                                      lit_cap, fcount, bases, blk, tally);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 over the n block records.
extern "C" int tpucomp_zstd_entropy(const uint8_t* comp, int comp_cap, const long long* blk, int n,
                                    uint8_t* lits, int32_t* seqs, long long* bout, int32_t* bsym,
                                    int32_t* berr, void* stream) {
  if (n <= 0) return 0;
  entropy_kernel<<<n, kEntropyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_cap, blk, lits, seqs, bout, bsym, berr);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3 over the batch.
extern "C" int tpucomp_zstd_scan(const long long* fcount, const long long* bases, int batch,
                                 const long long* bout, const int32_t* bsym, const int32_t* berr,
                                 int out_cap, long long* bstart, long long* bin, long long* fsize,
                                 int32_t* fstat, void* stream) {
  if (batch <= 0) return 0;
  scan_kernel<<<(batch + kChainThreads - 1) / kChainThreads, kChainThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(fcount, bases, batch, bout, bsym, berr,
                                                     out_cap, bstart, bin, fsize, fstat);
  return static_cast<int>(cudaGetLastError());
}

// Pass 4 over the n block records; fstat_out starts as a copy of fstat_in.
extern "C" int tpucomp_zstd_resolve(const long long* blk, int n, const int32_t* seqs,
                                    const long long* bstart, const long long* bin,
                                    const int32_t* fstat_in, int32_t* fstat_out, int32_t* offs,
                                    void* stream) {
  if (n <= 0) return 0;
  resolve_kernel<<<n, kResolveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blk, seqs, bstart, bin, fstat_in, fstat_out, offs);
  return static_cast<int>(cudaGetLastError());
}

// Pass 6a: sizes, statuses, and zero rows past each size.
extern "C" int tpucomp_zstd_zero(const int32_t* fstat, const long long* fsize, int batch,
                                 int out_cap, uint8_t* out, int32_t* out_sizes, int32_t* statuses,
                                 void* stream) {
  if (batch <= 0) return 0;
  const long long segs = (out_cap + kZeroSeg - 1) / kZeroSeg;
  const dim3 grid(batch, static_cast<unsigned>(segs > 0 ? segs : 1));
  zero_kernel<<<grid, kZeroThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fstat, fsize, out_cap, out, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

// Pass 6b over the n block records.  order: the block of each ticket, and
// sync: n + 1 zeroed ints (each block's published progress, then the ticket
// counter); both null when no frame has a second block (CTA b takes block b,
// and nothing waits or is published).
extern "C" int tpucomp_zstd_execute(const uint8_t* comp, int comp_cap, const long long* blk,
                                    int n, const int32_t* order, const uint8_t* lits,
                                    const int32_t* seqs, const int32_t* offs,
                                    const long long* bstart, const long long* bout,
                                    const int32_t* fstat, uint8_t* out, int out_cap, int* sync,
                                    void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return order ? launch_execute<kWideChunk, kWideThreads>(comp, comp_cap, blk, n, order, lits,
                                                          seqs, offs, bstart, bout, fstat, out,
                                                          out_cap, sync, st)
               : launch_execute<kNarrowChunk, kNarrowThreads>(comp, comp_cap, blk, n, order, lits,
                                                              seqs, offs, bstart, bout, fstat, out,
                                                              out_cap, sync, st);
}
