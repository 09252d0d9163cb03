// Block-format emission shared by the LZ4 and Snappy encoders: the
// sort-matched emitters (lz4_encode.cu, snappy_encode.cu) and the hash-table
// scan (hash_encode.cu) write the same elements.
//
// Replaces the emission helpers inside the TPU kernels
// tpucomp/ops/pallas/lz4_encode2.py, lz4_encode.py, snappy_encode2.py and
// snappy_encode.py (emit_seq / wr_ext, emit_literals / emit_copy2 /
// emit_copy, the varint preamble), which compose each element into a
// 128-byte vector for one wild store.  Here tags, lengths and offsets are
// lane 0's single-byte stores and literals a warp copy, all through OutRow
// (csrc/bytecopy.cuh): bytes at and past the row's cap are dropped, so a
// frame that outgrows its row is counted and never stored.
//
// Callers keep the warp converged: every lane holds the same arguments.
#pragma once

#include <cstdint>

#include "bytecopy.cuh"

namespace tpucomp {

constexpr int kEncodeSuccess = 0;
constexpr int kEncodeOutputTooSmall = 15;

// LZ4 length extension: k / 255 bytes of 255, then k % 255.
__device__ __forceinline__ int lz4_put_ext(const OutRow& w, int o, int k) {
  const int n255 = k / 255;
  w.fill(o, o + n255, 255);
  w.put(o + n255, k % 255);
  return o + n255 + 1;
}

// One LZ4 sequence: token, literal-length extension, ll literals from `lit`,
// then (when ml > 0) the 2-byte offset and the match-length extension.  With
// ml == 0 it is the final literal-only sequence (token 0x00 when ll == 0).
__device__ __forceinline__ int lz4_emit_seq(const OutRow& w, int op, const uint8_t* lit,
                                            int ll, int ml, int off) {
  w.put(op++, (min(ll, 15) << 4) | min(max(ml - 4, 0), 15));
  if (ll >= 15) op = lz4_put_ext(w, op, ll - 15);
  w.copy(op, lit, ll);
  op += ll;
  if (ml > 0) {
    w.put(op, off & 0xFF);
    w.put(op + 1, off >> 8);
    op += 2;
    if (ml - 4 >= 15) op = lz4_put_ext(w, op, ml - 4 - 15);
  }
  return op;
}

// Snappy's varint32 preamble of the uncompressed size.
__device__ __forceinline__ int snappy_put_varint(const OutRow& w, int op, int size) {
  unsigned rem = static_cast<unsigned>(size);
  while (rem >= 0x80) {
    w.put(op++, (rem & 0x7F) | 0x80);
    rem >>= 7;
  }
  w.put(op++, rem);
  return op;
}

// Snappy literal element: tag (and 1-3 length bytes), then ll bytes from `lit`.
__device__ __forceinline__ int snappy_emit_literals(const OutRow& w, int op,
                                                    const uint8_t* lit, int ll) {
  const int n = ll - 1;
  if (ll <= 60) {
    w.put(op++, n << 2);
  } else if (ll <= 256) {
    w.put(op++, 60 << 2);
    w.put(op++, n);
  } else if (ll <= 65536) {
    w.put(op++, 61 << 2);
    w.put(op++, n & 0xFF);
    w.put(op++, n >> 8);
  } else {
    w.put(op++, 62 << 2);
    w.put(op++, n & 0xFF);
    w.put(op++, (n >> 8) & 0xFF);
    w.put(op++, (n >> 16) & 0xFF);
  }
  w.copy(op, lit, ll);
  return op + ll;
}

// One Snappy copy element of ml <= 64 bytes: copy-1 where it fits, else copy-2.
__device__ __forceinline__ int snappy_emit_copy2(const OutRow& w, int op, int off, int ml) {
  if (off < 2048 && ml >= 4 && ml <= 11) {
    w.put(op, 1 | ((ml - 4) << 2) | ((off >> 8) << 5));
    w.put(op + 1, off & 0xFF);
    return op + 2;
  }
  w.put(op, 2 | ((ml - 1) << 2));
  w.put(op + 1, off & 0xFF);
  w.put(op + 2, off >> 8);
  return op + 3;
}

// A Snappy match of any length: the reference encoder's 64/60-byte split.
__device__ __forceinline__ int snappy_emit_copy(const OutRow& w, int op, int off, int ml) {
  while (ml >= 68) {
    op = snappy_emit_copy2(w, op, off, 64);
    ml -= 64;
  }
  if (ml > 64) {
    op = snappy_emit_copy2(w, op, off, 60);
    ml -= 60;
  }
  return snappy_emit_copy2(w, op, off, ml);
}

// The end of a chunk: a frame of `op` bytes that passes the row's cap is
// OUTPUT_BUFFER_TOO_SMALL with size 0 and a zero row; the row is zero past
// the frame either way, so the caller's buffer needs no clearing.
__device__ __forceinline__ void finish_row(const OutRow& w, int op, int32_t* out_sizes,
                                           int32_t* statuses, int chunk) {
  const bool too_big = op > w.cap;
  const int osz = too_big ? 0 : op;
  __syncwarp();  // order lane 0's single-byte stores before the zero fill
  warp_fill(w.p, osz, w.cap, 0, w.lane);
  if (w.lane == 0) {
    out_sizes[chunk] = osz;
    statuses[chunk] = too_big ? kEncodeOutputTooSmall : kEncodeSuccess;
  }
}

}  // namespace tpucomp
