// Batched GDeflate tile decode, the serial walk: one warp per tile.
//
// Replaces the TPU kernel tpucomp/ops/pallas/gdeflate_decode.py::_kernel
// (called by decompress_batch at gdeflate_decode.py:402; kernel row 15), the
// reference's serial tile decoder, which no dispatch table reaches (the
// dispatched decoder is gdeflate_vdecode.cu, rows 13-14).  That kernel
// replays the tile's 32-lane bitstream on the scalar core, the lane bit
// buffers as (lo, hi, nbits) int32 triples in SMEM, and stores decoded bytes
// through 128-byte wild copies.
//
// The walk, kept step for step because the statuses of corrupt tiles depend
// on it (they differ from rows 13-14's):
//  * header (lane 0): err when csize < 12, btype > 2, the version byte > 1,
//    raw < 0 or n_tokens < 0; too_big when raw > out_cap, decided here
//    before any parse; err when a Huffman tile has n_tokens > raw.  A
//    stored tile is err when 12 + raw > csize, else its raw bytes are copied.
//  * tables (lane 0, in the warp's shared memory, csrc/huffman.cuh): err
//    when csize < 76 or the description passes csize; fixed lengths, or the
//    description's 5+5+4-bit counts, its CL lengths in CL_ORDER, a CL table
//    (root 7, 128 entries) and hlit + hdist CL codes, symbols 0-15 only,
//    none of them past the description's bits; then the litlen (root 9, 852
//    entries) and distance tables (GDeflate's 32 codes, root 6, 640).
//  * rounds of 32 tokens, warp lane j on GDeflate lane j, whose bit buffer
//    is one uint64 of at most 63 bits.  Four passes a round (litlen symbol,
//    length extra, distance symbol, distance extra), each opening with the
//    refill: a lane with fewer than 32 bits and DWORDs left takes the
//    stream's next DWORD, in lane order (ballot rank), and a lane that read
//    past its bits (its count negative) takes the DWORD but keeps none of
//    it, as the reference's out-of-range shifts give 0.  A miss, symbol 256
//    or a symbol above 285, or a distance code that misses, is err.  Then
//    the round's tokens are emitted in order: a distance past the output is
//    err; a literal is stored below out_cap, a match copied when it ends
//    within out_cap.
//  * end: err when the DWORDs taken pass the tile's ((csize - stream + 3)
//    >> 2) or the output is not raw bytes long.
// Reads within the row past csize return the row's own bytes; past the row
// they return 0 (the reference reads its zero padding there).  The output
// position is 64-bit here; the reference's int32 cannot wrap on a valid
// tile (n_tokens <= raw <= out_cap).
//
// Bound: bytes.  A call must read each tile's bytes once and write B x
// out_cap output bytes.  The walk is serial within a tile (a round of 32
// lanes at a time) and parallel across tiles: one warp a tile, four a block,
// each warp's tables and lengths (8.5 KiB) in shared memory.  A round's
// literals store in parallel at positions from a shuffle scan; its matches
// copy in order with the overlap-safe warp copy (csrc/bytecopy.cuh).

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "huffman.cuh"

namespace {

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kOutputTooSmall = 15;
constexpr int kWarpsPerBlock = 4;
constexpr int kLanes = 32;
constexpr int kHdr = 12;
constexpr int kPayload = 76;
constexpr int kLitRoot = 9, kDistRoot = 6, kClRoot = 7;
constexpr int kEnoughLit = 852, kEnoughDist = 640;
constexpr int kTabDist = kEnoughLit;

__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDistBase[32] = {1,    2,    3,    4,    5,    7,     9,     13,
                                  17,   25,   33,   49,   65,   97,    129,   193,
                                  257,  385,  513,  769,  1025, 1537,  2049,  3073,
                                  4097, 6145, 8193, 12289, 16385, 24577, 32769, 49153};
__constant__ int kDistExtra[32] = {0, 0, 0, 0, 1, 1, 2, 2, 3,  3,  4,  4,  5,  5,  6,  6,
                                   7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14};

struct Scratch {  // one warp's
  int32_t tab[kEnoughLit + kEnoughDist];
  int32_t lens[320];
  int32_t work[320];
  int32_t cnt[16];
  int32_t ofs[16];
};

// The compressed row: bytes past the row read as 0.
struct Row {
  const uint8_t* p;
  long long n;
  __device__ __forceinline__ uint32_t byte(long long i) const {
    return (i >= 0 && i < n) ? p[i] : 0u;
  }
  __device__ __forceinline__ uint32_t u32(long long i) const {
    return byte(i) | (byte(i + 1) << 8) | (byte(i + 2) << 16) | (byte(i + 3) << 24);
  }
};

// Lane 0: the description of a dynamic tile into s.lens (litlen at 0,
// distance at 288); true on error (gdeflate_decode.py:156-216).
__device__ bool dynamic_lens(const Row& in, int hdrb, const tpucomp::HuffScratch& h,
                             Scratch& s) {
  auto peek = [&](long long pos, int n) {
    return static_cast<int>((in.u32(pos >> 3) >> (pos & 7)) & ((1u << n) - 1u));
  };
  long long bp = kPayload * 8;
  const long long bits_end = kPayload * 8 + static_cast<long long>(hdrb) * 8;
  const int hlit = peek(bp, 5) + 257, hdist = peek(bp + 5, 5) + 1, hclen = peek(bp + 10, 4) + 4;
  bp += 14;
  if (hlit > 286) return true;
  for (int i = 0; i < 19; ++i) s.lens[i] = 0;
  for (int i = 0; i < hclen; ++i, bp += 3) s.lens[kClOrder[i]] = peek(bp, 3);
  if (tpucomp::build_table(h, 0, 19, kClRoot, kTabDist, 128)) return true;
  for (int i = 0; i < hlit + hdist; ++i) {
    int sym, nb;
    bool inv;
    const long long at = bp;
    tpucomp::read_code(s.tab, [&](int n) { return static_cast<uint32_t>(peek(at, n)); },
                       kTabDist, kClRoot, sym, nb, inv);
    bp += nb;
    if (inv || sym > 15 || bp > bits_end) return true;
    s.lens[i] = sym;
  }
  for (int k = hdist - 1; k >= 0; --k) s.lens[288 + k] = s.lens[hlit + k];
  for (int k = hlit; k < 288; ++k) s.lens[k] = 0;
  for (int k = 288 + hdist; k < 320; ++k) s.lens[k] = 0;
  return false;
}

// Lane 0: the tables of a Huffman tile; true on error.
__device__ bool build_tables(const Row& in, int btype, int hdrb, Scratch& s) {
  const tpucomp::HuffScratch h{s.tab, s.lens, s.work, s.cnt, s.ofs};
  if (btype == 1) {
    for (int i = 0; i < 320; ++i) s.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
  } else if (dynamic_lens(in, hdrb, h, s)) {
    return true;
  }
  return tpucomp::build_table(h, 0, 288, kLitRoot, 0, kEnoughLit) ||
         tpucomp::build_table(h, 288, 32, kDistRoot, kTabDist, kEnoughDist);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gdeflate_decode_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_sizes,
                       int batch, int comp_cap, uint8_t* __restrict__ out, int out_cap,
                       int32_t* __restrict__ out_sizes, int32_t* __restrict__ statuses) {
  __shared__ Scratch s_scratch[kWarpsPerBlock];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  Scratch& s = s_scratch[wi];
  const Row in{comp + static_cast<size_t>(chunk) * comp_cap, comp_cap};
  uint8_t* dst = out + static_cast<size_t>(chunk) * out_cap;
  const long long csize = comp_sizes[chunk];

  // ---- header (every lane reads the same bytes)
  const int btype = static_cast<int>(in.byte(0));
  const int n_tok = static_cast<int>(in.u32(2));
  const int raw = static_cast<int>(in.u32(6));
  const int hdrb = static_cast<int>(in.byte(10) | (in.byte(11) << 8));
  bool err = csize < kHdr || btype > 2 || in.byte(1) > 1 || raw < 0 || n_tok < 0;
  const bool too_big = !err && raw > out_cap;
  err = err || (btype > 0 && n_tok > raw);
  long long op = 0;

  if (!(err || too_big) && btype == 0) {
    err = kHdr + static_cast<long long>(raw) > csize;
    if (!err) tpucomp::warp_copy_bounded(dst, in.p, kHdr, in.n, raw, lane);
    op = raw;
  } else if (!(err || too_big)) {
    // ---- tables
    const long long stream_off = kPayload + (btype == 2 ? (hdrb + 3) & ~3 : 0);
    err = csize < kPayload || stream_off > csize;
    if (!err) {
      bool terr = false;
      if (lane == 0) terr = build_tables(in, btype, hdrb, s);
      err = __shfl_sync(tpucomp::kFullMask, terr, 0);
      __syncwarp();
    }
    // ---- rounds
    const int dj = static_cast<int>(in.byte(kHdr + 2 * lane) | (in.byte(kHdr + 2 * lane + 1) << 8));
    const long long sw = stream_off >> 2;
    const long long max_sp = (csize - stream_off + 3) >> 2;
    const unsigned below = (1u << lane) - 1u;
    uint64_t bb = 0;
    int nb = 0, tk = 0;
    long long sp = 0;
    auto refill = [&](bool act) {
      const bool need = act && nb < 32 && tk < dj;
      const unsigned m = __ballot_sync(tpucomp::kFullMask, need);
      if (need) {
        const uint32_t dw = in.u32(4 * (sw + sp + __popc(m & below)));
        if (nb >= 0) bb |= static_cast<uint64_t>(dw) << nb;
        nb += 32;
        ++tk;
      }
      sp += __popc(m);
    };
    auto take = [&](int n) {
      const int v = static_cast<int>(static_cast<uint32_t>(bb) & ((1u << n) - 1u));
      bb >>= n;
      nb -= n;
      return v;
    };
    auto peek = [&](int n) { return static_cast<uint32_t>(bb) & ((1u << n) - 1u); };
    const int rounds = err ? 0 : static_cast<int>((static_cast<unsigned>(n_tok) + 31u) >> 5);
    for (int r = 0; r < rounds; ++r) {
      const bool act = r * kLanes + lane < n_tok;
      bool bad = false;
      int sym = 0, nbits;
      bool inv;
      refill(act);                                  // litlen symbol
      if (act) {
        tpucomp::read_code(s.tab, peek, 0, kLitRoot, sym, nbits, inv);
        take(nbits);
        bad = inv || sym == 256 || sym - 257 >= 29;
      }
      const bool is_m = act && sym >= 257;
      const int li = min(max(sym - 257, 0), 28);
      refill(act);                                  // length extra
      int mlen = 0;
      if (act) mlen = kLenBase[li] + take(is_m ? kLenExtra[li] : 0);
      refill(act);                                  // distance symbol
      int ds = 0;
      if (act) {
        int dsym;
        tpucomp::read_code(s.tab, peek, kTabDist, kDistRoot, dsym, nbits, inv);
        if (is_m) {
          take(nbits);
          bad = bad || inv || dsym >= 32;
        }
        ds = min(dsym, 31);
      }
      refill(act);                                  // distance extra
      int dist = 0;
      if (act) dist = kDistBase[ds] + take(is_m ? kDistExtra[ds] : 0);
      // ---- emit the round in token order
      const int len = !act ? 0 : is_m ? mlen : 1;
      int inc = len;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(tpucomp::kFullMask, inc, d);
        if (lane >= d) inc += y;
      }
      const long long pos = op + inc - len;
      bad = bad || (is_m && dist > pos);
      if (__any_sync(tpucomp::kFullMask, bad)) {
        err = true;
        break;
      }
      if (act && !is_m && pos < out_cap) dst[pos] = static_cast<uint8_t>(sym);
      __syncwarp();
      unsigned mm = __ballot_sync(tpucomp::kFullMask, is_m && pos + mlen <= out_cap);
      while (mm) {
        const int k = __ffs(mm) - 1;
        mm &= mm - 1;
        const long long mpos = __shfl_sync(tpucomp::kFullMask, pos, k);
        const int ml = __shfl_sync(tpucomp::kFullMask, mlen, k);
        const int md = __shfl_sync(tpucomp::kFullMask, dist, k);
        tpucomp::warp_match_copy(dst, mpos, md, ml, lane);
      }
      op += __shfl_sync(tpucomp::kFullMask, inc, 31);
    }
    err = err || sp > max_sp || op != raw;
  }
  const long long osz = (err || too_big) ? 0 : raw;
  __syncwarp();
  tpucomp::warp_fill(dst, osz, out_cap, 0, lane);
  if (lane == 0) {
    out_sizes[chunk] = static_cast<int32_t>(osz);
    statuses[chunk] = err ? kCannotDecompress : (too_big ? kOutputTooSmall : kSuccess);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int tpucomp_gdeflate_decode(const uint8_t* comp, const int32_t* comp_sizes, int batch,
                                       int comp_cap, uint8_t* out, int out_cap,
                                       int32_t* out_sizes, int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gdeflate_decode_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, comp_sizes, batch, comp_cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}
