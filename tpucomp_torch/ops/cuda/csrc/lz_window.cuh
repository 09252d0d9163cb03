// The output window of an LZ77 decoder CTA of 1024 threads: up to 64 KiB of
// output in shared memory with a u16 source a byte, shared by the Snappy
// parse (csrc/snappy_decode.cu, row 6) and the GDeflate replay
// (csrc/gdeflate_vdecode.cu, row 14).
//
// The caller places every run of the output [0, n): a bit at the run's
// start in `starts` (u32 [kMaxOut / 32]) and, at the start in `srcpos` (u16
// [kMaxOut]), the distance of its bytes' sources: 0 for a literal's bytes,
// which are their own sources, a copy's distance otherwise.  Copies in a row
// at one distance may be one run: a run at distance d is one periodic copy.
// The literal bytes go into `win` (u8 [kMaxOut]).  Then resolve_sources
// gives every byte its source, the literal byte it holds in the end, and
// flush writes the output row from the window.  Every thread calls both.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "lz_parse.cuh"

namespace lzw {

using lzp::kPThreads;
using lzp::kPWarps;
constexpr int kMaxOut = 65536;  // the largest output a window holds

// Each byte o < n gets its source, from the last run start s0 at or before
// it and its distance d: o for a literal's byte, s0 - d + (o - s0) mod d
// for a copied one; then src = src[src] until every source is a literal's
// byte.  `carry` (u32 [kMaxOut / 32]) and `scr` (long long [32]) are
// scratch.  srcpos below (n + 3) & ~3 holds the sources after it (the bytes
// past n in the last four are their own).
__device__ __forceinline__ void resolve_sources(uint16_t* srcpos, const uint32_t* starts,
                                                uint32_t* carry, long long* scr, int n, int tid,
                                                int lane, int wi) {
  // a. The (s0, d) carried into each starts word (thread tid takes words 2
  // tid and 2 tid + 1; a scan carries the last run start's across threads)
  {
    const int w = 2 * tid;
    const uint32_t m0 = 64 * tid < n ? starts[w] : 0u, m1 = 64 * tid + 32 < n ? starts[w + 1] : 0u;
    const int x0 = m0 ? 32 * w + 31 - __clz(m0) : -1, x1 = m1 ? 32 * w + 63 - __clz(m1) : -1;
    const long long l0 = x0 >= 0 ? (static_cast<long long>(x0) << 16) | srcpos[x0] : -1;
    const long long l1 = x1 >= 0 ? (static_cast<long long>(x1) << 16) | srcpos[x1] : -1;
    const long long cur = lzp::block_scan_excl<long long>(
        l1 >= 0 ? l1 : l0, -1LL, [](long long a, long long b) { return b >= 0 ? b : a; }, scr,
        lane, wi);
    carry[w] = static_cast<uint32_t>(cur);
    carry[w + 1] = static_cast<uint32_t>(l0 >= 0 ? l0 : cur);
  }
  __syncthreads();
  // b. a warp a word, a lane a byte: the last run start in the word at or
  // before the lane (read by every lane before any writes), else the
  // word's carry
  for (int w = wi; 32 * w < n; w += kPWarps) {
    const int o = 32 * w + lane;
    const uint32_t mk = starts[w] & (0xFFFFFFFFu >> (31 - lane));
    const int s0 = mk ? 32 * w + 31 - __clz(mk) : static_cast<int>(carry[w] >> 16);
    const int d = mk ? srcpos[s0] : static_cast<int>(carry[w] & 0xFFFF);
    __syncwarp();
    if (o < ((n + 3) & ~3)) {  // the bytes past n in the last four: their own sources
      const int i = o - s0;
      const int r = i < d ? i : (d & (d - 1)) == 0 ? i & (d - 1) : i % d;
      srcpos[o] = static_cast<uint16_t>(o < n && d > 0 ? s0 - d + r : o);
    }
  }
  // pointer jumping: src = src[src] until every source is a literal's
  // byte (its own source), four bytes a step (bytes 4 q to 4 q + 3 for q =
  // tid + k * kPThreads); reads of a source another thread is moving give
  // one or the other ancestor, both right.  Bit k of done: those four have
  // their literals
  uint2* s4 = reinterpret_cast<uint2*>(srcpos);
  const int nq4 = (n + 3) / 4;
  uint32_t done = 0;
  bool again = true;
  while (__syncthreads_or(again)) {
    again = false;
#pragma unroll 4
    for (int k = 0; k < kMaxOut / 4 / kPThreads; ++k) {
      const int qd = tid + k * kPThreads;
      if (((done >> k) & 1) || qd >= nq4) continue;
      const uint2 v = s4[qd];
      const uint32_t q0 = srcpos[v.x & 0xFFFF], q1 = srcpos[v.x >> 16];
      const uint32_t q2 = srcpos[v.y & 0xFFFF], q3 = srcpos[v.y >> 16];
      const uint2 nv = make_uint2(q0 | (q1 << 16), q2 | (q3 << 16));
      if (nv.x == v.x && nv.y == v.y) {
        done |= 1u << k;
      } else {
        s4[qd] = nv;
        again = true;
      }
    }
  }
}

// The row's bytes: o < n the window's byte at o's source (at o itself where
// srcpos is null: every byte a literal's), then 0; single bytes to a
// 16-byte boundary, then 16 bytes a store.
__device__ __forceinline__ void flush(uint8_t* orow, int out_cap, int n, const uint8_t* win,
                                      const uint16_t* srcpos, int tid) {
  auto val = [&](int o) {
    return o < n ? static_cast<uint32_t>(win[srcpos ? srcpos[o] : o]) : 0u;
  };
  const int a =
      min(out_cap, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(orow) & 15)) & 15));
  if (tid < a) orow[tid] = static_cast<uint8_t>(val(tid));
  const int n16 = (out_cap - a) >> 4;
  for (int i = tid; i < n16; i += kPThreads) {
    const int o = a + 16 * i;
    uint32_t w[4];
    if (!srcpos && (a & 3) == 0 && o + 16 <= n) {  // the window's own 16 bytes
      const uint32_t* ww = reinterpret_cast<const uint32_t*>(win + o);
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = ww[k];
    } else if (srcpos && (a & 7) == 0 && o + 16 <= n) {  // the 16 sources in two 16-byte loads
      const uint4 s0 = *reinterpret_cast<const uint4*>(srcpos + o);
      const uint4 s1 = *reinterpret_cast<const uint4*>(srcpos + o + 8);
      const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = win[sw[2 * k] & 0xFFFF] | (win[sw[2 * k] >> 16] << 8) |
               (win[sw[2 * k + 1] & 0xFFFF] << 16) | (win[sw[2 * k + 1] >> 16] << 24);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = val(o + 4 * k) | (val(o + 4 * k + 1) << 8) | (val(o + 4 * k + 2) << 16) |
               (val(o + 4 * k + 3) << 24);
    }
    *reinterpret_cast<uint4*>(orow + o) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int b = a + 16 * n16;
  if (tid < out_cap - b) orow[b + tid] = static_cast<uint8_t>(val(b + tid));
}

}  // namespace lzw
