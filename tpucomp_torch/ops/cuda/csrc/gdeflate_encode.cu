// Batched GDeflate encode: the token walk, one warp per chunk, emitting into
// 32 round-robin lane bit buffers, in three modes (fixed, hist, emit) of one
// kernel body.
//
// Replaces the TPU kernel tpucomp/ops/pallas/gdeflate_encode.py::_kernel in
// its three trace-time modes: "hist" (called at gdeflate_encode.py:453,
// algos 1 and 2), "fixed" and "emit" (called at :471; algo 0, algos 1 and
// 2).  Match finding is not in here: the caller first runs the sort-based
// candidate pass (tpucomp_torch/ops/match.py::candidates2 with the 64 KiB
// window), which gives for every position the nearest previous 4-byte match
// `cand`, an 8-byte-prefix sort neighbour `cand8`, and `nxt`, the next
// position that has either (all three null for entropy-only coding).  The
// walk is csrc/deflate_encode.cu's, so every mode sees the same tokens:
//
//   nm = nxt[scan]; stop at nm >= mflimit = size - 3
//   extend cand and cand8 forward, at most min(size - (nm + 4), 254) bytes;
//   keep the longer (cand8 only if longer)
//   back-extend while nm2 > anchor, src2 > 0 and the bytes before match
//   ml = min(back + 4 + longer, 258): literals [anchor, nm2), the match,
//   anchor = scan = nm2 + ml
//
// then the literals [anchor, size); there is no end-of-block symbol.
// Distances use GDeflate's 32 codes (30 and 31 carry 14 extra bits).
//  * hist: litlen and distance symbol counts into int32[B, 288] and [B, 32].
//  * fixed / emit: token t's codes go to lane t & 31 (litlen code, length
//    extra, distance code, distance extra), closed-form fixed codes or
//    tab[sym] = bit-reversed code | length << 16 (distances at 288+).  A lane
//    appends LSB first to a 64-bit buffer (the TPU's (lo, hi, nbits) triple)
//    and writes a dword whenever it holds 32 bits, at most WCAP = 832 of them
//    (more set the overflow flag, and the tile falls back to stored).  The
//    token's four field bit counts, packed 4 x 4 bits, go to nb16 as u16 t
//    (two tokens an int32 word, low half first); t >= 65536 sets the flag.
//    At the end each lane writes its partial dword, dcnt = its count +
//    (bits left > 0), and meta = [tokens, overflow, tokens > 65536, 0].
//    Lane words and nb16 entries past those written are 0.
//
// Bound: bytes.  A call must read each input byte once and write the lane
// words, the field counts and the lane counts (B x (32 x 832 + 32768 + 36)
// int32; hist B x 320); it reads the candidate arrays only where the walk
// lands.  Design: a warp per chunk, all lanes carrying the same walk state
// (broadcast loads, uniform branches); forward extension compares 32 bytes a
// step with a ballot (warp_match_len).  A run of literals is coded by all
// lanes at once, since consecutive tokens belong to consecutive lanes: each
// lane takes the literals of its own tokens in order.  A match token's four
// fields are appended by its owning lane.  Histograms and the emit table live
// in the warp's shared memory (320 words).

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"

namespace {

constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 258;
constexpr int kWarpsPerBlock = 4;
constexpr int kLanes = 32;
constexpr int kNTab = 288 + 32;
constexpr int kWCap = 832;
constexpr int kNtCap = 65536;

enum Mode { kFixed = 0, kHist = 1, kEmit = 2 };

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int n) {
  return n ? __brev(v) >> (32 - n) : 0u;
}

// Match length -> length symbol index 0..28, extra bit count and value.
__device__ __forceinline__ void len_sym(int ml, int& li, int& e, int& ev) {
  const int m = ml - 3;
  if (m < 8) {
    li = m, e = 0, ev = 0;
  } else if (ml == kMaxMatch) {
    li = 28, e = 0, ev = 0;
  } else {
    e = 29 - __clz(m);  // bit length - 3
    li = ((e + 1) << 2) | ((m >> e) - 4);
    ev = m & ((1 << e) - 1);
  }
}

// Distance (1..65536) -> GDeflate distance symbol 0..31, extra bits and value.
__device__ __forceinline__ void dist_sym(int dist, int& dc, int& e, int& ev) {
  const int d = dist - 1;
  if (d < 4) {
    dc = d, e = 0, ev = 0;
  } else {
    e = 30 - __clz(d);  // bit length - 2
    dc = ((e + 1) << 1) | ((d >> e) - 2);
    ev = d & ((1 << e) - 1);
  }
}

// One lane's bit buffer and its run of dwords.
struct Lane {
  uint32_t* words;  // this lane's WCAP dwords
  uint64_t acc;
  int nb;
  int cnt;
  bool over;
  __device__ __forceinline__ void put(uint32_t v, int n) {
    acc |= static_cast<uint64_t>(v) << nb;
    nb += n;
    if (nb >= 32) {
      if (cnt < kWCap)
        words[cnt] = static_cast<uint32_t>(acc);
      else
        over = true;
      ++cnt;
      acc >>= 32;
      nb -= 32;
    }
  }
};

template <int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gdeflate_encode_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                       const int32_t* __restrict__ cand, const int32_t* __restrict__ cand8,
                       const int32_t* __restrict__ nxt, int batch, int cap,
                       const int32_t* __restrict__ tab, int32_t* __restrict__ llh,
                       int32_t* __restrict__ dh, int32_t* __restrict__ lw,
                       int32_t* __restrict__ nb16, int32_t* __restrict__ dcnt,
                       int32_t* __restrict__ meta) {
  __shared__ int32_t s_tab[kWarpsPerBlock][kNTab];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(chunk) * cap;
  const uint8_t* in = data + row;
  const int size = min(max(sizes[chunk], 0), cap);
  int32_t* t_ = s_tab[wi];
  for (int i = lane; i < kNTab; i += 32)
    t_[i] = M == kEmit ? tab[static_cast<size_t>(chunk) * kNTab + i] : 0;
  __syncwarp();

  Lane ln{M == kHist ? nullptr
                     : reinterpret_cast<uint32_t*>(lw) +
                           (static_cast<size_t>(chunk) * kLanes + lane) * kWCap,
          0, 0, 0, false};
  uint16_t* fc = M == kHist ? nullptr
                            : reinterpret_cast<uint16_t*>(nb16) + static_cast<size_t>(chunk) * kNtCap;
  int t = 0;  // tokens so far (the same in every lane)

  auto rec = [&](int tt, int packed) {
    if (tt < kNtCap)
      fc[tt] = static_cast<uint16_t>(packed);
    else
      ln.over = true;
  };
  // literals [a, b): tokens t .. t + b - a, each coded by its own lane
  auto lits = [&](int a, int b) {
    const int n = b - a;
    for (int k = (lane - t) & 31; k < n; k += 32) {
      const int v = in[a + k];
      if (M == kHist) {
        atomicAdd(&t_[v], 1);
      } else if (M == kEmit) {
        const int n1 = t_[v] >> 16;
        ln.put(t_[v] & 0xFFFF, n1);
        rec(t + k, n1);
      } else {
        const int n1 = v < 144 ? 8 : 9;
        ln.put(v < 144 ? rev_bits(0x30 + v, 8) : rev_bits(0x190 + v - 144, 9), n1);
        rec(t + k, n1);
      }
    }
    t += n;
  };
  auto match = [&](int ml, int dist) {
    int li, e, ev, dc, de, dv;
    len_sym(ml, li, e, ev);
    dist_sym(dist, dc, de, dv);
    if (M == kHist) {
      if (lane == 0) {
        atomicAdd(&t_[257 + li], 1);
        atomicAdd(&t_[288 + dc], 1);
      }
    } else if (lane == (t & 31)) {
      uint32_t c1, c3;
      int n1, n3;
      if (M == kEmit) {
        c1 = t_[257 + li] & 0xFFFF, n1 = t_[257 + li] >> 16;
        c3 = t_[288 + dc] & 0xFFFF, n3 = t_[288 + dc] >> 16;
      } else {
        const int lsym = 257 + li;
        n1 = lsym < 280 ? 7 : 8;
        c1 = rev_bits(lsym < 280 ? lsym - 256 : 0xC0 + lsym - 280, n1);
        c3 = rev_bits(dc, 5), n3 = 5;
      }
      ln.put(c1, n1);
      ln.put(ev, e);
      ln.put(c3, n3);
      ln.put(dv, de);
      rec(t, n1 | (e << 4) | (n3 << 8) | (de << 12));
    }
    ++t;
  };

  const int mflimit = size - kMinMatch + 1;
  int anchor = 0, scan = 0;
  if (nxt != nullptr) {
    const int32_t* c4 = cand + row;
    const int32_t* c8 = cand8 + row;
    const int32_t* nx = nxt + row;
    while (scan < mflimit) {
      const int nm = nx[scan];
      if (nm >= mflimit) break;  // no usable match left: the rest is literal
      const int c4p = c4[nm], c8p = c8[nm];
      const int p4 = c4p >= 0 ? c4p : c8p;
      const int p8 = c8p >= 0 ? c8p : p4;
      const int fcap = min(size - (nm + kMinMatch), kMaxMatch - kMinMatch);
      const int l4 = tpucomp::warp_match_len(in, nm + kMinMatch, p4 + kMinMatch, fcap, lane);
      const int l8 = p8 != p4
                         ? tpucomp::warp_match_len(in, nm + kMinMatch, p8 + kMinMatch, fcap, lane)
                         : l4;
      const int src = l8 > l4 ? p8 : p4;
      int nm2 = nm, src2 = src;
      while (nm2 > anchor && src2 > 0 && in[nm2 - 1] == in[src2 - 1]) {
        --nm2;
        --src2;
      }
      const int ml = min(nm - nm2 + kMinMatch + max(l4, l8), kMaxMatch);
      lits(anchor, nm2);
      match(ml, nm - src);
      anchor = scan = nm2 + ml;
    }
  }
  lits(anchor, size);

  __syncwarp();
  if (M == kHist) {
    for (int i = lane; i < kNTab; i += 32) {
      if (i < 288)
        llh[static_cast<size_t>(chunk) * 288 + i] = t_[i];
      else
        dh[static_cast<size_t>(chunk) * 32 + i - 288] = t_[i];
    }
    return;
  }
  if (ln.nb > 0) {
    if (ln.cnt < kWCap)
      ln.words[ln.cnt] = static_cast<uint32_t>(ln.acc);
    else
      ln.over = true;
  }
  const int d = ln.cnt + (ln.nb > 0 ? 1 : 0);
  dcnt[static_cast<size_t>(chunk) * kLanes + lane] = d;
  for (int w = min(d, kWCap); w < kWCap; ++w) ln.words[w] = 0;
  for (int i = t + lane; i < kNtCap; i += 32) fc[i] = 0;
  const bool over = __any_sync(tpucomp::kFullMask, ln.over);
  if (lane == 0) {
    int32_t* m = meta + static_cast<size_t>(chunk) * 4;
    m[0] = t;
    m[1] = over ? 1 : 0;
    m[2] = t > kNtCap ? 1 : 0;
    m[3] = 0;
  }
}

template <int M>
int launch(const uint8_t* data, const int32_t* sizes, const int32_t* cand,
           const int32_t* cand8, const int32_t* nxt, int batch, int cap, const int32_t* tab,
           int32_t* llh, int32_t* dh, int32_t* lw, int32_t* nb16, int32_t* dcnt,
           int32_t* meta, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gdeflate_encode_kernel<M><<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      data, sizes, cand, cand8, nxt, batch, cap, tab, llh, dh, lw, nb16, dcnt, meta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = ok).  cand, cand8 and nxt are all null for entropy-only coding.
extern "C" int tpucomp_gdeflate_encode_fixed(const uint8_t* data, const int32_t* sizes,
                                             const int32_t* cand, const int32_t* cand8,
                                             const int32_t* nxt, int batch, int cap,
                                             int32_t* lw, int32_t* nb16, int32_t* dcnt,
                                             int32_t* meta, void* stream) {
  return launch<kFixed>(data, sizes, cand, cand8, nxt, batch, cap, nullptr, nullptr, nullptr,
                        lw, nb16, dcnt, meta, stream);
}

extern "C" int tpucomp_gdeflate_encode_hist(const uint8_t* data, const int32_t* sizes,
                                            const int32_t* cand, const int32_t* cand8,
                                            const int32_t* nxt, int batch, int cap,
                                            int32_t* llh, int32_t* dh, void* stream) {
  return launch<kHist>(data, sizes, cand, cand8, nxt, batch, cap, nullptr, llh, dh, nullptr,
                       nullptr, nullptr, nullptr, stream);
}

extern "C" int tpucomp_gdeflate_encode_emit(const uint8_t* data, const int32_t* sizes,
                                            const int32_t* cand, const int32_t* cand8,
                                            const int32_t* nxt, int batch, int cap,
                                            const int32_t* tab, int32_t* lw, int32_t* nb16,
                                            int32_t* dcnt, int32_t* meta, void* stream) {
  return launch<kEmit>(data, sizes, cand, cand8, nxt, batch, cap, tab, nullptr, nullptr, lw,
                       nb16, dcnt, meta, stream);
}
