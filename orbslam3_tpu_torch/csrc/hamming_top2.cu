// Masked Hamming best / runner-up match over packed 256-bit descriptors.
//
// Replaces the Pallas kernel orbslam3_tpu/kernels/hamming_pallas.py:masked_top2
// (body _top2_kernel): for each of N query descriptors, over the M candidates
// that row i of the (N, M) mask allows, the column of the least Hamming
// distance (ties go to the lowest column), that distance, and the least
// distance over the other columns. A masked-out entry counts as distance
// 2^20 at its own column, exactly as the Pallas kernel fills it, so a row
// with no candidate gives best = second = 2^20 and idx = 0.
//
// Bound on the H100 at the tracking shapes (N = 2048 map points, M = 1200
// features): the kernel must read the 2.46 MB byte mask once, the 64 KB and
// 38 KB of packed words and write 24 KB, about 0.8 us at 3.35 TB/s. The
// arithmetic is 8 XOR+popcount per allowed pair (a window mask allows a few
// percent of them), far below that; so the bytes bound it, and at
// microsecond scale so does the launch itself.
//
// Design: one warp per query row, eight rows per block. The row's 8 words
// sit in registers; lanes stride over the candidate columns (coalesced mask
// bytes, 32-byte candidate rows that stay in L1/L2), compute the distance
// only where the mask allows, and keep a running (best, idx, second). A
// butterfly of warp shuffles merges the 32 partial results; the merge is a
// total order on (distance, column), so every lane ends with the same
// answer and the lowest column wins ties. The (N, M) distance matrix is
// never written, which is what the Pallas kernel keeps out of HBM too; its
// MXU +/-1 plane product and 128-lane padding are TPU artifacts.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWords = 8;          // 256 bits
constexpr int kWarpsPerBlock = 8;
constexpr int kBig = 1 << 20;      // distance of a masked-out entry

struct Top2 {
  int best;
  int idx;
  int second;
};

// Merge another partial result into `a`. Commutative: the winner is the
// lexicographically smaller (best, idx); the runner-up is the smaller of
// the winner's runner-up and the loser's best.
__device__ __forceinline__ void merge(Top2& a, const Top2& b) {
  const bool b_wins = (b.best < a.best) || (b.best == a.best && b.idx < a.idx);
  if (b_wins) {
    a.second = min(b.second, a.best);
    a.best = b.best;
    a.idx = b.idx;
  } else {
    a.second = min(a.second, b.best);
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
masked_top2_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   const uint8_t* __restrict__ mask, int n, int m,
                   int32_t* __restrict__ idx_out, int32_t* __restrict__ best_out,
                   int32_t* __restrict__ second_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together

  const uint4 a0 = a[2 * (size_t)row];
  const uint4 a1 = a[2 * (size_t)row + 1];
  const uint8_t* mrow = mask + (size_t)row * m;

  // INT_MAX marks "no entry seen yet": any real entry (<= kBig) beats it.
  Top2 t{INT_MAX, INT_MAX, INT_MAX};
  for (int j = lane; j < m; j += 32) {
    int d = kBig;
    if (mrow[j]) {
      const uint4 b0 = __ldg(b + 2 * (size_t)j);
      const uint4 b1 = __ldg(b + 2 * (size_t)j + 1);
      d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
          __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
          __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
    }
    // j grows along the loop, so an equal distance never takes the lead
    if (d < t.best) {
      t.second = t.best;
      t.best = d;
      t.idx = j;
    } else {
      t.second = min(t.second, d);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    merge(t, o);
  }
  if (lane == 0) {
    idx_out[row] = t.idx;
    best_out[row] = t.best;
    second_out[row] = min(t.second, kBig);  // a single candidate column
  }
}

}  // namespace

// a_words (n, 8) and b_words (m, 8) packed descriptors, 16-byte aligned;
// mask (n, m) bytes, nonzero = candidate allowed; outputs (n,) int32 each.
// Requires n >= 0 and m >= 1. Launches on `stream`; returns cudaGetLastError().
extern "C" int orb_masked_top2(const void* a_words, const void* b_words,
                               const void* mask, int n, int m, void* idx,
                               void* best, void* second, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  masked_top2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a_words), static_cast<const uint4*>(b_words),
      static_cast<const uint8_t*>(mask), n, m, static_cast<int32_t*>(idx),
      static_cast<int32_t*>(best), static_cast<int32_t*>(second));
  return static_cast<int>(cudaGetLastError());
}
