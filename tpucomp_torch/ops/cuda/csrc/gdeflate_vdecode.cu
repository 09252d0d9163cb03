// Batched GDeflate tile decode: the 32-lane parse and the token replay, one
// warp per tile each.
//
// Replaces the two TPU kernels of tpucomp/ops/pallas/gdeflate_vdecode.py:
// _parse_kernel (called at :359) and _exec_kernel (called at :410), and the
// table builder that feeds the first, tpucomp/formats/gdeflate.py::tile_tables
// (XLA ops there, vmapped over the batch).
//
// parse (kernel row 13).  Lane 0 reads the tile's header and builds its
// canonical tables in the warp's shared memory: the version gate, the
// 5+5+4-bit counts, the 19 CL lengths in CL_ORDER, the 318-step CL decode
// from bit 71 (a run code or a miss is an error wherever it falls; dynamic
// tiles only), then count/first/offset/sym_of_rank of the litlen (288) and
// distance (32) lengths, fixed or dynamic, with the reference's quirks (a
// length above 15 counts as 15, the later of two symbols on one rank stays).
// They go out as one int32 row per tile (layout in gdeflate_vdecode.py).
// Then 32 tokens a round, warp lane j on GDeflate lane j, each lane's bit
// buffer one uint64 (the TPU's (lo, hi, nbits) int32 triple).  Each of the
// four fields of a round (litlen symbol, length extra, distance symbol,
// distance extra) begins with the refill:
//   need = act && nb < 32 && taken < D[j]; rank = needing lanes below j;
//   word = dwords[min(dw0 + sp, max_dw) + rank]; sp += needing lanes,
// where dwords are the row's little-endian dwords, zero at and past the row,
// and max_dw the reference's clamp from its padded width.  A symbol is the
// first of the 15 canonical range compares that matches (no lookup table);
// a miss, symbol 256 or a symbol above 285 is a code error (err bit 0).
// Length and distance bases are closed form; distance symbols clip to 31.
// A token is its byte (literal) or 1 << 25 | (mlen - 3) << 17 | dist.
// Rounds stop at ceil(n_tokens / 32) or R_cap = out_cap / 32 + 1; tokens of
// idle lanes and later rounds are 0.  err bit 1: a lane took another number
// of dwords than its D (an ok-level condition, not an error).
//
// exec (kernel row 14).  The tokens of a tile replay in one pass (the TPU's
// 4096-token SMEM slabs are not needed): op advances on every token; a
// literal is written while op < out_cap, a match copied when its distance
// is in 1..op and op + mlen <= out_cap; a bad distance sets derr, and after
// the first token not written nothing is written.  The warp takes 32 tokens
// a step: a shuffle scan gives each token's position, the literals before
// the first unwritten token store in parallel, then the matches copy in
// order (overlap-safe, csrc/bytecopy.cuh).  Bytes no token wrote are 0.
//
// Bound: bytes.  parse reads each tile once (its header, description and
// the dwords its lanes take) and writes B x (456 + 4 x R_cap x 32) bytes of
// tables and tokens; exec reads the tokens and writes B x out_cap bytes.
// Both are serial within a tile (a round of 32 lanes, one token group) and
// parallel across tiles: one warp a tile, four warps a block.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMatchFlag = 1 << 25;
constexpr int kHdr = 12;
constexpr int kPayload = 76;
constexpr int kDescCap = 384;
constexpr int kClSteps = 318;
constexpr int kMaxBits = 15;
// the table row: [btype, n_tokens, raw, dw_start, tbl_ok, 0, 0, 0], D[32],
// litlen count/first/offset[16 each], distance count/first/offset, lsor, dsor
constexpr int kTD = 8, kTL = 40, kTDist = 88, kTLsor = 136, kTDsor = 424, kNTab = 456;

__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Tables {                 // one warp's shared tables
  int lens[288 + 32];           // litlen then distance lengths (CL lengths first)
  int all_lens[kClSteps];
  int ltab[48], dtab[48], cltab[48];  // count, first, offset
  int lsor[288], dsor[32], clsor[19];
  int D[kLanes];
  int head[8];
  uint8_t desc[kDescCap];
};

__device__ __forceinline__ int byte_at(const uint8_t* row, int cap, int i) {
  return i < cap ? row[i] : 0;
}

// count/first/offset into tab[0..16), [16..32), [32..48) and sym_of_rank;
// returns the Kraft check (tpucomp/formats/deflate.py::_canonical).
__device__ bool canonical(const int* lens, int nsym, int* tab, int* sor) {
  int* count = tab;
  int* first = tab + 16;
  int* offset = tab + 32;
  for (int l = 0; l <= kMaxBits; ++l) count[l] = 0;
  for (int s = 0; s < nsym; ++s)
    if (lens[s] > 0) ++count[min(lens[s], kMaxBits)];
  int code = 0, kraft = 0;
  first[0] = 0;
  offset[0] = 0;
  for (int l = 1; l <= kMaxBits; ++l) {
    code = (code + count[l - 1]) << 1;
    first[l] = code;
    kraft += count[l] << (kMaxBits - l);
    offset[l] = offset[l - 1] + count[l - 1];
  }
  int seen[kMaxBits + 1];
  for (int l = 0; l <= kMaxBits; ++l) seen[l] = 0;
  for (int s = 0; s < nsym; ++s) sor[s] = 0;
  for (int s = 0; s < nsym; ++s) {
    const int L = lens[s];
    if (L <= 0) continue;
    const int r = offset[min(L, kMaxBits)] + (L <= kMaxBits ? seen[L]++ : 0);
    sor[min(max(r, 0), nsym - 1)] = s;   // the later symbol on a rank stays
  }
  return kraft <= (1 << kMaxBits);
}

// The first of the 15 canonical range compares that matches the
// bit-reversed peek `rev`: its rank index (0 on a miss), length and hit.
__device__ __forceinline__ int match_code(uint32_t rev, const int* tab, int& len, bool& found) {
  int idx = 0;
  len = 0;
  found = false;
#pragma unroll
  for (int l = 1; l <= kMaxBits; ++l) {
    const int code = static_cast<int>(rev >> (kMaxBits - l));
    const bool in = code >= tab[16 + l] && code - tab[16 + l] < tab[l];
    if (in && !found) {
      idx = tab[32 + l] + code - tab[16 + l];
      len = l;
    }
    found = found || in;
  }
  return idx;
}

__device__ __forceinline__ uint32_t rev15(uint32_t x) { return __brev(x & 0x7FFF) >> 17; }

// Lane 0: the header fields and the tables of one tile into t.
__device__ void build_tables(const uint8_t* in, int cap, Tables& t) {
  const int btype = byte_at(in, cap, 0);
  const bool ver_ok = byte_at(in, cap, 1) <= 1;
  auto u32 = [&](int at) {
    return static_cast<int>(static_cast<uint32_t>(byte_at(in, cap, at)) |
                            (static_cast<uint32_t>(byte_at(in, cap, at + 1)) << 8) |
                            (static_cast<uint32_t>(byte_at(in, cap, at + 2)) << 16) |
                            (static_cast<uint32_t>(byte_at(in, cap, at + 3)) << 24));
  };
  const int n_tok = u32(2), raw = u32(6);
  const int hdr_bytes = byte_at(in, cap, 10) | (byte_at(in, cap, 11) << 8);
  const bool is_dyn = btype == 2;
  bool cl_ok = true;
  int* lit = t.lens;
  int* dist = t.lens + 288;
  if (is_dyn) {
    auto bit_at = [&](int bp) {
      bp = min(max(bp, 0), kDescCap * 8 - 1);
      return (t.desc[bp >> 3] >> (bp & 7)) & 1;
    };
    auto bits = [&](int bp, int n) {
      int v = 0;
      for (int k = 0; k < n; ++k) v |= bit_at(bp + k) << k;
      return v;
    };
    const int hlit = bits(0, 5) + 257, hdist = bits(5, 5) + 1, hclen = bits(10, 4) + 4;
    int cl_lens[19];
    for (int i = 0; i < 19; ++i) cl_lens[i] = 0;
    for (int i = 0; i < 19; ++i) cl_lens[kClOrder[i]] = i < hclen ? bits(14 + 3 * i, 3) : 0;
    const bool cl_valid = canonical(cl_lens, 19, t.cltab, t.clsor);
    bool cl_err = false;
    int bp = 14 + 3 * 19;
    for (int i = 0; i < kClSteps; ++i) {
      int v = 0;
      for (int k = 0; k < kMaxBits; ++k) v |= bit_at(bp + k) << (kMaxBits - 1 - k);
      int len;
      bool found;
      const int idx = match_code(static_cast<uint32_t>(v), t.cltab, len, found);
      const int sym = found ? t.clsor[min(max(idx, 0), 18)] : 0;
      cl_err = cl_err || !found || sym > 15;
      t.all_lens[i] = i < hlit + hdist ? sym : 0;
      bp += len;
    }
    for (int s = 0; s < 288; ++s) lit[s] = s < hlit ? t.all_lens[s] : 0;
    for (int s = 0; s < 32; ++s) dist[s] = s < hdist ? t.all_lens[min(hlit + s, kClSteps - 1)] : 0;
    cl_ok = cl_valid && !cl_err;
  } else {
    for (int s = 0; s < 288; ++s) lit[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
    for (int s = 0; s < 32; ++s) dist[s] = 5;
  }
  const bool lvalid = canonical(lit, 288, t.ltab, t.lsor);
  const bool dvalid = canonical(dist, 32, t.dtab, t.dsor);
  t.head[0] = btype;
  t.head[1] = n_tok;
  t.head[2] = raw;
  t.head[3] = kPayload + (is_dyn ? (hdr_bytes + 3) & ~3 : 0);
  t.head[4] = cl_ok && lvalid && dvalid && ver_ok;
  t.head[5] = t.head[6] = t.head[7] = 0;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gdeflate_parse_kernel(const uint8_t* __restrict__ comp, int batch, int comp_cap, int r_cap,
                      int max_dw, int32_t* __restrict__ tabs, int32_t* __restrict__ tokens,
                      int32_t* __restrict__ sp_out, int32_t* __restrict__ err_out) {
  __shared__ Tables s_tab[kWarpsPerBlock];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint8_t* in = comp + static_cast<size_t>(chunk) * comp_cap;
  Tables& t = s_tab[wi];
  for (int i = lane; i < kDescCap; i += 32) t.desc[i] = byte_at(in, comp_cap, kPayload + i);
  t.D[lane] = byte_at(in, comp_cap, kHdr + 2 * lane) | (byte_at(in, comp_cap, kHdr + 2 * lane + 1) << 8);
  __syncwarp();
  if (lane == 0) build_tables(in, comp_cap, t);
  __syncwarp();

  int32_t* row = tabs + static_cast<size_t>(chunk) * kNTab;
  for (int i = lane; i < kNTab; i += 32) {
    int v;
    if (i < kTD) v = t.head[i];
    else if (i < kTL) v = t.D[i - kTD];
    else if (i < kTDist) v = t.ltab[i - kTL];
    else if (i < kTLsor) v = t.dtab[i - kTDist];
    else if (i < kTDsor) v = t.lsor[i - kTLsor];
    else v = t.dsor[i - kTDsor];
    row[i] = v;
  }

  const int n_tok = t.head[1];
  const int dw0 = t.head[3] >> 2;
  const int dj = t.D[lane];
  const int rounds =
      n_tok > 0 ? static_cast<int>(min((static_cast<long long>(n_tok) + 31) / 32,
                                       static_cast<long long>(r_cap)))
                : 0;
  int32_t* tok_row = tokens + static_cast<size_t>(chunk) * r_cap * kLanes;
  uint64_t buf = 0;
  int nb = 0, taken = 0, sp = 0;
  bool err = false;
  const unsigned below = (1u << lane) - 1u;

  auto refill = [&](bool act) {
    const bool need = act && nb < 32 && taken < dj;
    const unsigned m = __ballot_sync(tpucomp::kFullMask, need);
    if (need) {
      const long long at = 4LL * (min(dw0 + sp, max_dw) + __popc(m & below));
      uint32_t w = 0;
      for (int k = 0; k < 4; ++k)
        w |= static_cast<uint32_t>(at + k < comp_cap ? in[at + k] : 0) << (8 * k);
      buf |= static_cast<uint64_t>(w) << nb;
      nb += 32;
      ++taken;
    }
    sp += __popc(m);
  };
  auto consume = [&](int n) {
    buf >>= n;
    nb -= n;
  };

  for (int r = 0; r < rounds; ++r) {
    const bool act = r * kLanes + lane < n_tok;
    // field 1: litlen symbol
    refill(act);
    int l1;
    bool ok1;
    int sym = t.lsor[min(max(match_code(rev15(static_cast<uint32_t>(buf)), t.ltab, l1, ok1), 0), 287)];
    err = err || (act && (!ok1 || sym == 256 || sym > 285));
    consume(act ? l1 : 0);
    const bool is_m = act && sym >= 257;
    const int li = min(max(sym - 257, 0), 28);
    // field 2: length extra
    refill(act);
    int le = max((li >> 2) - 1, 0);
    int lbase = ((4 + (li & 3)) << le) + 3;
    if (li < 8) lbase = li + 3, le = 0;
    if (li == 28) lbase = 258, le = 0;
    const int n2 = is_m ? le : 0;
    const int ex2 = static_cast<int>(static_cast<uint32_t>(buf) & ((1u << n2) - 1u));
    consume(n2);
    const int mlen = is_m ? lbase + ex2 : 0;
    // field 3: distance symbol
    refill(act);
    int l3;
    bool ok3;
    int dsym = t.dsor[min(max(match_code(rev15(static_cast<uint32_t>(buf)), t.dtab, l3, ok3), 0), 31)];
    err = err || (is_m && !ok3);
    consume(is_m ? l3 : 0);
    dsym = min(max(dsym, 0), 31);
    // field 4: distance extra
    refill(act);
    int de = max((dsym >> 1) - 1, 0);
    int dbase = ((2 + (dsym & 1)) << de) + 1;
    if (dsym < 4) dbase = dsym + 1, de = 0;
    const int n4 = is_m ? de : 0;
    const int ex4 = static_cast<int>(static_cast<uint32_t>(buf) & ((1u << n4) - 1u));
    consume(n4);
    const int dist = is_m ? dbase + ex4 : 0;
    const int tok = is_m ? (kMatchFlag | ((mlen - 3) << 17) | min(max(dist, 0), 0x1FFFF))
                         : min(max(sym, 0), 255);
    tok_row[r * kLanes + lane] = act ? tok : 0;
  }
  for (long long i = static_cast<long long>(rounds) * kLanes + lane;
       i < static_cast<long long>(r_cap) * kLanes; i += 32)
    tok_row[i] = 0;
  const bool any_err = __any_sync(tpucomp::kFullMask, err);
  const bool taken_bad = __any_sync(tpucomp::kFullMask, taken != dj);
  if (lane == 0) {
    sp_out[chunk] = sp;
    err_out[chunk] = (any_err ? 1 : 0) | (taken_bad ? 2 : 0);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gdeflate_exec_kernel(const int32_t* __restrict__ tokens, const int32_t* __restrict__ n_tok,
                     int batch, int ntok_cap, uint8_t* __restrict__ out, int out_cap,
                     int32_t* __restrict__ op_out, int32_t* __restrict__ derr_out) {
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (chunk >= batch) return;
  const int lane = threadIdx.x & 31;
  const int32_t* toks = tokens + static_cast<size_t>(chunk) * ntok_cap;
  uint8_t* row = out + static_cast<size_t>(chunk) * out_cap;
  const int n = n_tok[chunk];
  long long op = 0, wend = -1;
  bool err = false;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool v = i < n;
    const int tok = v ? toks[i] : 0;
    const bool is_m = v && tok >= kMatchFlag;
    const int dist = tok & 0x1FFFF;
    const int len = !v ? 0 : is_m ? ((tok >> 17) & 0xFF) + 3 : 1;
    int inc = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(tpucomp::kFullMask, inc, d);
      if (lane >= d) inc += y;
    }
    const long long pos = op + inc - len;
    const bool bad = is_m && (dist < 1 || dist > pos);
    const bool skip = v && (is_m ? bad || pos + len > out_cap : pos >= out_cap);
    const unsigned sk = __ballot_sync(tpucomp::kFullMask, skip);
    err = err || __any_sync(tpucomp::kFullMask, bad);
    if (wend < 0) {                    // nothing was skipped yet: write
      const int fs = sk ? __ffs(sk) - 1 : 32;
      if (v && !is_m && lane < fs) row[pos] = static_cast<uint8_t>(tok);
      __syncwarp();
      unsigned mm = __ballot_sync(tpucomp::kFullMask, is_m && lane < fs);
      while (mm) {
        const int k = __ffs(mm) - 1;
        mm &= mm - 1;
        const long long mpos = __shfl_sync(tpucomp::kFullMask, pos, k);
        const int ml = __shfl_sync(tpucomp::kFullMask, len, k);
        const int md = __shfl_sync(tpucomp::kFullMask, dist, k);
        tpucomp::warp_match_copy(row, mpos, md, ml, lane);
      }
      if (sk) wend = __shfl_sync(tpucomp::kFullMask, pos, fs);
    }
    op += __shfl_sync(tpucomp::kFullMask, inc, 31);
  }
  const long long end = min(wend < 0 ? op : wend, static_cast<long long>(out_cap));
  tpucomp::warp_fill(row, end, out_cap, 0, lane);
  if (lane == 0) {
    op_out[chunk] = static_cast<int32_t>(op);
    derr_out[chunk] = err ? 1 : 0;
  }
}

int blocks_for(int batch) { return (batch + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).
extern "C" int tpucomp_gdeflate_parse(const uint8_t* comp, int batch, int comp_cap, int r_cap,
                                      int max_dw, int32_t* tabs, int32_t* tokens, int32_t* sp,
                                      int32_t* err, void* stream) {
  if (batch <= 0) return 0;
  gdeflate_parse_kernel<<<blocks_for(batch), kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(comp, batch, comp_cap, r_cap,
                                                               max_dw, tabs, tokens, sp, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpucomp_gdeflate_exec(const int32_t* tokens, const int32_t* n_tok, int batch,
                                     int ntok_cap, uint8_t* out, int out_cap, int32_t* op,
                                     int32_t* derr, void* stream) {
  if (batch <= 0) return 0;
  gdeflate_exec_kernel<<<blocks_for(batch), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(tokens, n_tok, batch, ntok_cap,
                                                              out, out_cap, op, derr);
  return static_cast<int>(cudaGetLastError());
}
