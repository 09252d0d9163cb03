// Warp-cooperative byte moves shared by the LZ kernels (and the encoders'
// bounded output row and forward match extension).
//
// Replaces tpucomp/ops/pallas/bytecopy.py (window128, store128_wild,
// store128_masked, copy_bytes, copy_bytes_wide, copy_pattern).  Those helpers
// keep one byte per int32 lane of (rows, 128) VMEM tiles and move bytes with
// lane rolls, 128-byte wild stores and log-doubling pattern amplification.
// What they compute is: a forward copy of n bytes, an LZ77 match copy whose
// source may overlap its destination (the period-`off` pattern that ends at
// `op`, repeated), and exact stores that never touch bytes past the end.
// Here every lane of a warp moves every 32nd byte of global memory, so the
// warp stores 32 neighbouring bytes per instruction and needs no wild
// overshoot and no padding.
//
// Callers keep the warp converged: every lane holds the same arguments.  Each
// helper ends in __syncwarp(), so its stores are visible to every lane of the
// warp when it returns (the next match copy reads them).
#pragma once

#include <cstdint>

namespace tpucomp {

constexpr unsigned kFullMask = 0xffffffffu;

// dst[i] = src[i] for 0 <= i < n; the ranges must not overlap.
__device__ __forceinline__ void warp_copy(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ src,
                                          long long n, int lane) {
  for (long long i = lane; i < n; i += 32) dst[i] = src[i];
  __syncwarp();
}

// dst[i] = src[i] for i < n, where src reads as 0 at and past src_end
// (a byte source whose logical size may exceed the buffer behind it).
__device__ __forceinline__ void warp_copy_bounded(uint8_t* __restrict__ dst,
                                                  const uint8_t* __restrict__ src,
                                                  long long src_pos, long long src_end,
                                                  long long n, int lane) {
  for (long long i = lane; i < n; i += 32) {
    long long s = src_pos + i;
    dst[i] = s < src_end ? src[s] : 0;
  }
  __syncwarp();
}

// LZ77 match copy, overlap-safe for every offset 1 <= off <= op:
//   buf[op + i] = buf[op - off + (i mod off)]  for 0 <= i < n,
// which equals the byte-serial buf[op + i] = buf[op + i - off].  Every byte is
// read from the window [op - off, op) written before the call, so lanes never
// wait on each other; `r` tracks i mod off without a division per byte.
__device__ __forceinline__ void warp_match_copy(uint8_t* buf, long long op, int off,
                                                long long n, int lane) {
  const uint8_t* s = buf + op - off;
  uint8_t* d = buf + op;
  int r = lane % off;
  const int step = 32 % off;
  for (long long i = lane; i < n; i += 32) {
    d[i] = s[r];
    r += step;
    if (r >= off) r -= off;
  }
  __syncwarp();
}

// dst[i] = v for lo <= i < hi.
__device__ __forceinline__ void warp_fill(uint8_t* dst, long long lo, long long hi,
                                          uint8_t v, int lane) {
  for (long long i = lo + lane; i < hi; i += 32) dst[i] = v;
  __syncwarp();
}

// An encoder's output row: stores at and past `cap` are dropped, so a frame
// that outgrows the row never writes past it.  put() is lane 0's single byte.
struct OutRow {
  uint8_t* p;
  int cap;
  int lane;
  __device__ __forceinline__ void put(int o, int v) const {
    if (lane == 0 && o < cap) p[o] = static_cast<uint8_t>(v);
  }
  __device__ __forceinline__ void fill(int lo, int hi, uint8_t v) const {
    warp_fill(p, lo, min(hi, cap), v, lane);
  }
  __device__ __forceinline__ void copy(int o, const uint8_t* src, int n) const {
    warp_copy(p + o, src, max(0, min(n, cap - o)), lane);
  }
};

// Common-prefix length of in[a..] and in[c..], at most cap_n: 32 byte pairs a
// step, the first mismatch (or the cap) found by ballot.
__device__ __forceinline__ int warp_match_len(const uint8_t* __restrict__ in,
                                              int a, int c, int cap_n, int lane) {
  int l = 0;
  while (true) {
    const int i = l + lane;
    const bool ok = i < cap_n && in[a + i] == in[c + i];
    const unsigned bad = __ballot_sync(kFullMask, !ok);
    if (bad) return min(l + __ffs(bad) - 1, cap_n);
    l += 32;
  }
}

}  // namespace tpucomp
