// rANS (v2 container) device-side blocks: one warp decodes or encodes one
// chunk's 128 interleaved lanes.
//
// The counterparts of the TPU package's device-side API,
// tpucomp/ops/pallas/ans_decode.py::decode_block and
// tpucomp/ops/pallas/ans_encode.py::encode_block: callable from any kernel
// that gives them one warp, its tables in shared memory and its rows.  The
// container is tpucomp_torch/formats/ans.py's: 32-bit states, 16-bit
// renormalization words, 12-bit frequencies, and ONE word stream shared by all
// lanes in the order the decoder consumes it (step-major, lane-minor).
//
// Layout: format lane L = 32 * k + t belongs to warp thread t, k = 0..3, so a
// thread holds four states in lane-stride order and a step's bytes are four
// coalesced 32-byte runs.  The TPU kernels' one-hot/MXU table lookups,
// bf16-exact byte splits, 7-step lane-roll routing, three-limb f32 division
// and sign-bit compares are not carried over: tables are shared-memory
// arrays, a lane's rank among the lanes that need a word is four ballots and
// popcounts, the division is native u32, all state arithmetic is uint32_t.

#pragma once

#include <cstdint>

namespace tpucomp_ans {

constexpr int kLanes = 128;
constexpr int kPerThread = kLanes / 32;
constexpr int kProbBits = 12;
constexpr int kProbScale = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kHeaderBytes = 12 + 512 + 512 + 256;
constexpr unsigned kFull = 0xffffffffu;

// A warp's decode tables: slot -> symbol, and freq | cum << 16 by symbol.
struct DecodeTables {
  uint8_t sym[kProbScale];
  uint32_t fc[256];
};

// The shared word stream of one frame row of comp_cap bytes: word i is the
// row's bytes at kHeaderBytes + 2i, +1 (zero past the row) for i < n_words,
// and 0 beyond, as the TPU wrappers pad it (ans_decode.py:186-190).
struct WordStream {
  const uint8_t* row;
  int comp_cap;
  int n_words;

  __device__ __forceinline__ uint32_t byte(int j) const {
    return j < comp_cap ? row[j] : 0u;
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    if (i >= n_words) return 0u;
    const int o = kHeaderBytes + 2 * i;
    return byte(o) | (byte(o + 1) << 8);
  }
};

// Fill t.fc from the 256 frequencies (thread `lane` holds symbols 8 * lane ..
// 8 * lane + 7 in f[]) and return their sum.  When the sum is PROB_SCALE,
// also fill t.sym: slot j maps to the s with cum[s] <= j < cum[s] + freq[s],
// which is the TPU kernel's #(cumn <= j).  Other sums leave t.sym unfilled:
// the caller's header check then walks no step.
__device__ __forceinline__ int build_decode_tables(const uint32_t f[8],
                                                   DecodeTables& t, int lane) {
  uint32_t local = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) local += f[i];
  uint32_t incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const uint32_t total = __shfl_sync(kFull, incl, 31);
  uint32_t cum = incl - local;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t.fc[8 * lane + i] = f[i] | (cum << 16);
    cum += f[i];
  }
  __syncwarp();
  if (total == static_cast<uint32_t>(kProbScale)) {
    for (int s = 0; s < 256; ++s) {  // warp-uniform: every thread reads fc[s]
      const uint32_t fc = t.fc[s];
      const int lo = static_cast<int>(fc >> 16);
      const int hi = lo + static_cast<int>(fc & 0xFFFF);
      for (int j = lo + lane; j < hi; j += 32) t.sym[j] = static_cast<uint8_t>(s);
    }
  }
  __syncwarp();
  return static_cast<int>(total);
}

// Decode ceil(size / 128) steps of the 128 lanes from states x[] (updated in
// place), counting each lane's words in consumed[] and the shared cursor in
// *ptr.  The words a step needs are read at min(*ptr, max_word_pos) + rank,
// as the TPU kernels read their clamped window.  out[p] receives the byte at
// position p for p < out_cap: the symbol where p < size, else 0.
__device__ __forceinline__ void decode_block(int size, const DecodeTables& t,
                                             const WordStream& ws, int max_word_pos,
                                             uint32_t x[kPerThread],
                                             int consumed[kPerThread], int* ptr,
                                             uint8_t* out, int out_cap, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  const int steps = (size + kLanes - 1) / kLanes;
  int p = *ptr;
  for (int step = 0; step < steps; ++step) {
    const int base = min(p, max_word_pos);
    int taken = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int pos = step * kLanes + 32 * k + lane;
      const bool act = pos < size;
      const uint32_t slot = x[k] & (kProbScale - 1);
      const uint32_t s = t.sym[slot];
      const uint32_t fc = t.fc[s];
      uint32_t xn = (fc & 0xFFFF) * (x[k] >> kProbBits) + slot - (fc >> 16);
      const bool need = act && xn < kRansL;
      const unsigned ballot = __ballot_sync(kFull, need);
      if (need) {
        xn = (xn << 16) | ws.word(base + taken + __popc(ballot & lt));
        ++consumed[k];
      }
      if (act) x[k] = xn;
      if (pos < out_cap) out[pos] = act ? static_cast<uint8_t>(s) : 0;
      taken += __popc(ballot);
    }
    p += taken;
  }
  *ptr = p;
}

// Encode the first `size` bytes of `data` in reverse position order (rANS is
// LIFO) from states x[] (updated in place), with fc[s] = freq | cum << 16 in
// shared memory.  Row r of words/emits (128 entries each, decode order)
// receives what position row r emitted, for r < ceil(size / 128); wcount[]
// counts each lane's words.  The emit rule is the reference's: x_max =
// freq << 20 as u32, where freq = 4096 (a one-symbol chunk) wraps to 0, which
// means never emit.
__device__ __forceinline__ void encode_block(int size, const uint32_t* fc,
                                             const uint8_t* data,
                                             uint32_t x[kPerThread],
                                             int wcount[kPerThread],
                                             int16_t* words, uint8_t* emits,
                                             int lane) {
  const int rows = (size + kLanes - 1) / kLanes;
  for (int r = rows - 1; r >= 0; --r) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int pos = r * kLanes + 32 * k + lane;
      bool emit = false;
      uint32_t word = 0;
      if (pos < size) {
        const uint32_t e = fc[data[pos]];
        const uint32_t f = e & 0xFFFF, c = e >> 16;
        const uint32_t x_max = f << 20;
        emit = x_max != 0 && x[k] >= x_max;
        if (emit) {
          word = x[k] & 0xFFFF;
          x[k] >>= 16;
        }
        const uint32_t fs = max(f, 1u);
        x[k] = ((x[k] / fs) << kProbBits) + x[k] % fs + c;
        wcount[k] += emit;
      }
      words[pos] = static_cast<int16_t>(static_cast<uint16_t>(word));
      emits[pos] = emit;
    }
  }
}

}  // namespace tpucomp_ans
