// Batched rANS decode (v2 container): one warp per chunk.
//
// Replaces the TPU kernels tpucomp/ops/pallas/ans_decode.py::_kernel (single
// chunk per grid step, called by decompress_batch at ans_decode.py:231, its
// body decode_block :59) and ::_kernel_wide (8 chunks per grid step, called
// by decompress_batch_wide at :457).  Both are one function here: the same
// warp body (ans.cuh's decode_block), launched with one warp per block for
// the single-chunk wrapper and eight for the wide one (the reference's G).
//
// Per warp: parse the header from the raw row (magic, version, signed int32
// size and total_words, the 256 frequencies, 128 states and word counts),
// check it as the TPU wrappers do (ans_decode.py:201-207,438-446: magic and
// version, sum(freq) == 4096, 0 <= size <= out_cap, comp_size >= 1292 + 2 *
// total_words in 64 bits), build the slot -> symbol and freq | cum tables in
// shared memory (about 5 KiB a warp), walk ceil(size / 128) steps, then check
// each lane as the kernels do (x_fin == 2^16, consumed == wcount, the cursor
// == total_words; all waived when the checked size is 0).  A failed chunk
// gets status CANNOT_DECOMPRESS, size 0 and a zero row; bytes at and past
// the size are zero.
//
// Bound: bytes.  The work must read each frame once and write each output
// byte once; the walk itself is a serial chain of ceil(size / 128) steps per
// chunk whose every step waits on a shared-memory lookup and, for the lanes
// that renormalize, a word read at the shared cursor.  Design: the 128
// states live in registers (four a thread), the tables in shared memory, a
// lane's rank among the needing lanes is four ballots and popcounts (no
// shuffles), and the cursor advances by the same sum in every thread.  Many
// chunks in flight (1024 warps at the main path's shape) hide the chain's
// latency.

#include <cstdint>

#include <cuda_runtime.h>

#include "ans.cuh"

namespace {

using namespace tpucomp_ans;

constexpr int kSuccess = 0;
constexpr int kCannotDecompress = 12;
constexpr int kMagic = 0xA5;
constexpr int kVersion = 2;

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
ans_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ comp_sizes, int batch,
                  int comp_cap, int n_words, int max_word_pos,
                  uint8_t* __restrict__ out, int out_cap,
                  int32_t* __restrict__ out_sizes,
                  int32_t* __restrict__ statuses) {
  __shared__ DecodeTables tables[kWarps];
  const int warp = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarps + warp;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  DecodeTables& t = tables[warp];
  const WordStream ws{comp + static_cast<size_t>(chunk) * comp_cap, comp_cap,
                      n_words};
  uint8_t* row = out + static_cast<size_t>(chunk) * out_cap;

  auto u16 = [&](int o) { return ws.byte(o) | (ws.byte(o + 1) << 8); };
  auto u32 = [&](int o) { return u16(o) | (u16(o + 2) << 16); };
  const int size = static_cast<int>(u32(4));
  const int total_words = static_cast<int>(u32(8));
  uint32_t f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = u16(12 + 2 * (8 * lane + i));
  const int fsum = build_decode_tables(f, t, lane);
  const bool ok_hdr =
      ws.byte(0) == kMagic && ws.byte(1) == kVersion && fsum == kProbScale &&
      size >= 0 && size <= out_cap &&
      static_cast<int64_t>(comp_sizes[chunk]) >=
          kHeaderBytes + 2 * static_cast<int64_t>(total_words);
  const int size_c = ok_hdr ? size : 0;

  uint32_t x[kPerThread];
  int consumed[kPerThread], wcount[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int l = 32 * k + lane;
    x[k] = u32(12 + 512 + 4 * l);
    wcount[k] = static_cast<int>(u16(12 + 1024 + 2 * l));
    consumed[k] = 0;
  }
  int ptr = 0;
  decode_block(size_c, t, ws, max_word_pos, x, consumed, &ptr, row, out_cap,
               lane);
  const int walked = min((size_c + kLanes - 1) / kLanes * kLanes, out_cap);
  for (int p = walked + lane; p < out_cap; p += 32) row[p] = 0;

  bool lanes_ok = ptr == total_words;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    lanes_ok = lanes_ok && x[k] == kRansL && consumed[k] == wcount[k];
  const bool ok = ok_hdr && (__all_sync(kFull, lanes_ok) || size_c <= 0);
  if (!ok) {
    __syncwarp();  // order the walk's byte stores before the clearing
    for (int p = lane; p < walked; p += 32) row[p] = 0;
  }
  if (lane == 0) {
    out_sizes[chunk] = ok ? size_c : 0;
    statuses[chunk] = ok ? kSuccess : kCannotDecompress;
  }
}

}  // namespace

// Launch on `stream` with `warps` (1 or 8) chunks per block; returns
// cudaGetLastError() after the launch (0 = ok).  n_words and max_word_pos
// describe the padded shared stream of a comp_cap-byte row (the wrapper
// computes them as the TPU wrappers do).
extern "C" int tpucomp_ans_decode(const uint8_t* comp, const int32_t* comp_sizes,
                                  int batch, int comp_cap, int n_words,
                                  int max_word_pos, uint8_t* out, int out_cap,
                                  int32_t* out_sizes, int32_t* statuses,
                                  int warps, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps == 8) {
    ans_decode_kernel<8><<<(batch + 7) / 8, 8 * 32, 0, s>>>(
        comp, comp_sizes, batch, comp_cap, n_words, max_word_pos, out, out_cap,
        out_sizes, statuses);
  } else if (warps == 1) {
    ans_decode_kernel<1><<<batch, 32, 0, s>>>(
        comp, comp_sizes, batch, comp_cap, n_words, max_word_pos, out, out_cap,
        out_sizes, statuses);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
