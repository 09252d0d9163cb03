// Batched rANS encode walk (v2 container): one warp per chunk.
//
// Replaces the TPU kernels tpucomp/ops/pallas/ans_encode.py::_kernel (single
// chunk per grid step, called by compress_batch at ans_encode.py:145, its
// body encode_block :72) and ::_kernel_wide (8 chunks per grid step, called
// by compress_batch_wide at :278).  Both are one function here: the same warp
// body (ans.cuh's encode_block), launched with one warp per block for the
// single-chunk wrapper and eight for the wide one (the reference's G).
//
// The tables (tpucomp_torch/formats/ans.py::tables_for) and the shared-stream
// compaction and serialization (::serialize_scan) stay in torch ops around
// the kernel, as the reference shares them between its XLA and Pallas paths.
// Per warp: freq | cum << 16 into shared memory, then the 128 lane states
// walk the rows from the last one holding data down to row 0; each row
// writes its 128 emitted words (u16, 0 where a lane did not emit) and emit
// flags (u8) in decode order, rows past the data are zero, and the final
// states and per-lane word counts close the chunk.  The TPU kernel's
// three-limb f32 long division (_udiv_by_freq :43) is a native u32 divide.
//
// Bound: bytes.  The work must read each input byte once and, counting only
// what leaves the function, write the frames (the words/emits arrays are the
// kernel's interface to the compaction, not counted).  Each step is a chain
// per lane of a shared-memory lookup, a compare and a divide; lanes are
// independent (no cross-lane step: the interleave happens in the
// compaction), and 1024 warps at the main path's shape keep the SMs busy.

#include <cstdint>

#include <cuda_runtime.h>

#include "ans.cuh"

namespace {

using namespace tpucomp_ans;

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
ans_encode_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ sizes,
                  const int32_t* __restrict__ freq,
                  const int32_t* __restrict__ cum, int batch, int cap, int steps,
                  int16_t* __restrict__ words, uint8_t* __restrict__ emits,
                  int32_t* __restrict__ x_fin, int32_t* __restrict__ wcounts) {
  __shared__ uint32_t fc_tables[kWarps][256];
  const int warp = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarps + warp;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  uint32_t* fc = fc_tables[warp];
  for (int s = lane; s < 256; s += 32) {
    fc[s] = static_cast<uint32_t>(freq[chunk * 256 + s]) |
            (static_cast<uint32_t>(cum[chunk * 256 + s]) << 16);
  }
  __syncwarp();
  const int size = min(max(sizes[chunk], 0), cap);
  const size_t row = static_cast<size_t>(chunk) * steps * kLanes;
  int16_t* w = words + row;
  uint8_t* e = emits + row;
  const int rows = (size + kLanes - 1) / kLanes;
  for (int p = rows * kLanes + lane; p < steps * kLanes; p += 32) {
    w[p] = 0;
    e[p] = 0;
  }
  uint32_t x[kPerThread];
  int wc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    x[k] = kRansL;
    wc[k] = 0;
  }
  encode_block(size, fc, data + static_cast<size_t>(chunk) * cap, x, wc, w, e,
               lane);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    x_fin[chunk * kLanes + 32 * k + lane] = static_cast<int32_t>(x[k]);
    wcounts[chunk * kLanes + 32 * k + lane] = wc[k];
  }
}

}  // namespace

// Launch on `stream` with `warps` (1 or 8) chunks per block; returns
// cudaGetLastError() after the launch (0 = ok).  words/emits are
// [batch, steps, 128] with steps = ceil(cap / 128).
extern "C" int tpucomp_ans_encode(const uint8_t* data, const int32_t* sizes,
                                  const int32_t* freq, const int32_t* cum,
                                  int batch, int cap, int16_t* words,
                                  uint8_t* emits, int32_t* x_fin,
                                  int32_t* wcounts, int warps, void* stream) {
  if (batch <= 0) return 0;
  const int steps = (cap + tpucomp_ans::kLanes - 1) / tpucomp_ans::kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps == 8) {
    ans_encode_kernel<8><<<(batch + 7) / 8, 8 * 32, 0, s>>>(
        data, sizes, freq, cum, batch, cap, steps, words, emits, x_fin, wcounts);
  } else if (warps == 1) {
    ans_encode_kernel<1><<<batch, 32, 0, s>>>(
        data, sizes, freq, cum, batch, cap, steps, words, emits, x_fin, wcounts);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
