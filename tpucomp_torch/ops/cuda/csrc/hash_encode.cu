// Batched LZ4 and Snappy block encode with a hash-table match finder, one
// warp per chunk: the reference's v1 encoders.
//
// Replaces two TPU kernels that share one scan:
//  * tpucomp/ops/pallas/lz4_encode.py::_kernel (called by compress_batch at
//    lz4_encode.py:275; kernel row 5): tpucomp_lz4_encode_hash;
//  * tpucomp/ops/pallas/snappy_encode.py::_kernel (called at
//    snappy_encode.py:314; row 8): tpucomp_snappy_encode_hash.
// No dispatch table reaches them: the dispatched encoders are the
// sort-matched emitters of lz4_encode.cu and snappy_encode.cu.
//
// The scan, LZ4-fast's, is serial (each probe depends on the table writes
// before it), and the kernel follows it step for step:
//
//   v = the 4 bytes at ip; h = (v * 2654435761 mod 2^32) >> 20
//   cand = table[h] - 1; table[h] = ip + 1
//   a match when table[h] was set, ip - cand <= 65535 and the 4 bytes at
//     cand equal v: extend it forward from ip + 4 (capped at size - 5 - (ip
//     + 4) for LZ4, whose last 5 bytes stay literal, and size - (ip + 4)
//     for Snappy), emit the literals since the anchor and the match, jump
//     past it and seed table[hash(ip2 - 2)] = ip2 - 1; misses = 0
//   else ip += 1 + (misses >> 6), misses += 1
//
// while ip < size - 12; then the final literals (LZ4: a literal-only
// sequence, token 0x00 when none remain; Snappy: a literal element when some
// remain).  Snappy frames start with the varint size and split long matches
// 64s while ml >= 68, then 60 if the rest passes 64 (csrc/emit.cuh).  The
// TPU kernel keeps its 4096-entry table in SMEM across grid steps and tags
// entries with an epoch (b * epoch_stride), so that an earlier chunk's
// entries read as empty; here each warp clears its own table in shared
// memory for each chunk, which gives the same result.  The wrapper keeps the
// reference's limit on the batch (B * epoch_stride < 2^31) all the same.
// Frames are byte-identical to the reference's.
//
// Bound: bytes.  A call must read each input byte once and write each output
// byte once (B x out_cap, the zero tail included).  The walk is latency
// bound: one probe a step, each a chain of dependent loads (input word,
// table entry, candidate word).  Design: one warp a chunk, four a block, each
// warp's 16 KiB table in dynamic shared memory (64 KiB a block, above the
// 48 KiB default: the entry point raises the block's limit).  Lane 0 reads
// and writes the table and broadcasts the entry (__shfl_sync), so every lane
// sees the table in the order of the scan; the other state is the same in
// every lane.  Forward extension compares 32 byte pairs a step
// (warp_match_len); literals are warp copies.  Sizes are clamped to [0, cap],
// as in the port's other encoders.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytecopy.cuh"
#include "emit.cuh"

namespace {

constexpr int kHashLog = 12;
constexpr int kHashSize = 1 << kHashLog;
constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;    // no match starts within the last 12 bytes
constexpr int kSkipTrigger = 6;
constexpr int kWarpsPerBlock = 4;
constexpr int kSmemBytes = kWarpsPerBlock * kHashSize * static_cast<int>(sizeof(int32_t));

__device__ __forceinline__ uint32_t load32(const uint8_t* in, int i) {
  return static_cast<uint32_t>(in[i]) | (static_cast<uint32_t>(in[i + 1]) << 8) |
         (static_cast<uint32_t>(in[i + 2]) << 16) | (static_cast<uint32_t>(in[i + 3]) << 24);
}

__device__ __forceinline__ int hash4(uint32_t v) {
  return static_cast<int>((v * 2654435761u) >> (32 - kHashLog));
}

struct Lz4Emit {
  static constexpr int kLastLiterals = 5;  // matches end 5 bytes before the end
  __device__ static int begin(const tpucomp::OutRow&, int, int) { return 0; }
  __device__ static int seq(const tpucomp::OutRow& w, int op, const uint8_t* lit, int ll,
                            int ml, int off) {
    return tpucomp::lz4_emit_seq(w, op, lit, ll, ml, off);
  }
  __device__ static int end(const tpucomp::OutRow& w, int op, const uint8_t* lit, int ll) {
    return tpucomp::lz4_emit_seq(w, op, lit, ll, 0, 0);
  }
};

struct SnappyEmit {
  static constexpr int kLastLiterals = 0;
  __device__ static int begin(const tpucomp::OutRow& w, int op, int size) {
    return tpucomp::snappy_put_varint(w, op, size);
  }
  __device__ static int seq(const tpucomp::OutRow& w, int op, const uint8_t* lit, int ll,
                            int ml, int off) {
    if (ll > 0) op = tpucomp::snappy_emit_literals(w, op, lit, ll);
    return tpucomp::snappy_emit_copy(w, op, off, ml);
  }
  __device__ static int end(const tpucomp::OutRow& w, int op, const uint8_t* lit, int ll) {
    return ll > 0 ? tpucomp::snappy_emit_literals(w, op, lit, ll) : op;
  }
};

template <class Emit>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hash_encode_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ sizes,
                   int batch, int cap, uint8_t* __restrict__ out, int out_cap,
                   int32_t* __restrict__ out_sizes, int32_t* __restrict__ statuses) {
  extern __shared__ int32_t s_tables[];
  const int wi = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarpsPerBlock + wi;
  if (chunk >= batch) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  int32_t* table = s_tables + wi * kHashSize;
  for (int i = lane; i < kHashSize; i += 32) table[i] = 0;
  __syncwarp();

  const uint8_t* in = data + static_cast<size_t>(chunk) * cap;
  const tpucomp::OutRow w{out + static_cast<size_t>(chunk) * out_cap, out_cap, lane};
  const int size = min(max(sizes[chunk], 0), cap);
  const int mflimit = size - kMfLimit;
  const int match_end = size - Emit::kLastLiterals;

  int op = Emit::begin(w, 0, size);
  int ip = 0, anchor = 0, misses = 0;
  while (ip < mflimit) {
    const uint32_t v = load32(in, ip);
    const int h = hash4(v);
    int cand_raw = 0;
    if (lane == 0) {
      cand_raw = table[h];
      table[h] = ip + 1;
    }
    cand_raw = __shfl_sync(tpucomp::kFullMask, cand_raw, 0);
    const int cand = cand_raw - 1;
    if (cand_raw > 0 && ip - cand <= 65535 && load32(in, cand) == v) {
      const int ml = kMinMatch + tpucomp::warp_match_len(in, ip + kMinMatch, cand + kMinMatch,
                                                         match_end - (ip + kMinMatch), lane);
      op = Emit::seq(w, op, in + anchor, ip - anchor, ml, ip - cand);
      ip += ml;
      anchor = ip;
      // the seed; past mflimit the scan is over (and a Snappy match may end
      // at size, where the word at ip - 2 would pass the row)
      if (lane == 0 && ip < mflimit) table[hash4(load32(in, ip - 2))] = ip - 2 + 1;
      misses = 0;
    } else {
      ip += 1 + (misses >> kSkipTrigger);
      ++misses;
    }
  }
  op = Emit::end(w, op, in + anchor, size - anchor);
  tpucomp::finish_row(w, op, out_sizes, statuses, chunk);
}

template <class Emit>
int launch(const uint8_t* data, const int32_t* sizes, int batch, int cap, uint8_t* out,
           int out_cap, int32_t* out_sizes, int32_t* statuses, void* stream) {
  if (batch <= 0) return 0;
  const cudaError_t set = cudaFuncSetAttribute(
      hash_encode_kernel<Emit>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hash_encode_kernel<Emit><<<blocks, kWarpsPerBlock * 32, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      data, sizes, batch, cap, out, out_cap, out_sizes, statuses);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns the first CUDA error of the launch
// (0 = ok).
extern "C" int tpucomp_lz4_encode_hash(const uint8_t* data, const int32_t* sizes, int batch,
                                       int cap, uint8_t* out, int out_cap, int32_t* out_sizes,
                                       int32_t* statuses, void* stream) {
  return launch<Lz4Emit>(data, sizes, batch, cap, out, out_cap, out_sizes, statuses, stream);
}

extern "C" int tpucomp_snappy_encode_hash(const uint8_t* data, const int32_t* sizes, int batch,
                                          int cap, uint8_t* out, int out_cap,
                                          int32_t* out_sizes, int32_t* statuses, void* stream) {
  return launch<SnappyEmit>(data, sizes, batch, cap, out, out_cap, out_sizes, statuses, stream);
}
