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
// arithmetic is 8 XOR+popcount per allowed pair; the tracker's window masks
// allow ~0.3% of the pairs (3.5 a row), so the mask's bytes bound the
// kernel, and at microsecond scale so do latency and the launch itself.
//
// Design: one warp per query row, whose memory traffic comes in two
// dependent rounds (the byte-strided kernel this one replaced made 38
// dependent mask loads a row).
//   1. The mask row is read in 16-byte chunks (ld.global.nc.v4) on the
//      absolute 16-byte grid, lane l taking chunk 32 s + l of step s, so one
//      step covers 512 contiguous bytes; all kSteps steps of a batch are
//      requested before any is tested (one batch for rows up to 1521 bytes).
//      The head and tail chunks of a row that starts or ends off the grid
//      are loaded whole (they lie in the mask) and the neighbouring rows'
//      bytes masked off; only a chunk that would run past the mask's last
//      byte is read bytewise.
//   2. Each lane turns its chunks into 16-bit "nonzero byte" maps, and the
//      warp compacts the allowed columns, in increasing order, into a list
//      in shared memory (a prefix sum over lanes by shuffles). Lane l then
//      takes list entries l, l + 32, ..., loading kUnroll candidates' 32
//      bytes (__ldg; the 38 KB candidate set stays in L1/L2) before
//      computing any of their 8 XOR+popcounts against the row's words in
//      registers. A sparse row costs one round of descriptor loads spread
//      over as many lanes as it has candidates, however they cluster; a
//      dense row keeps every lane busy with coalesced loads.
//   3. Each lane sees its columns in increasing order, so a strict "<" keeps
//      the lowest column of a tie. Three warp min-reductions (redux.sync)
//      merge the lanes on the total order (distance, column). Masked
//      columns are never visited: a row with no candidate is recognised at
//      the end and given (idx 0, 2^20, 2^20), and the runner-up is clamped
//      to 2^20, which equals the minimum over masked columns when one exists.
//
// Launch shape, chosen on an NVIDIA H100 80GB HBM3 at 700.00 W: 8 rows per
// block, 4 candidate loads and 3 mask chunks in flight per lane; 2048 rows
// are one wave. Tried at the tracker's (2048, 1200) problem under its own
// mask, a random 2% mask and an all-true mask: 4 or 16 rows per block were
// no faster; 2 or 8 loads in flight were slower; 2 chunks in flight split a
// 1200-byte row into two batches, two mask round trips, and were slower at
// every mask. What is left at the tracker's mask is mostly what a launch of
// this grid costs with nothing to read; PERF.md gives the numbers.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // candidate loads in flight per lane
constexpr int kSteps = 3;   // 16-byte chunks in flight per lane
constexpr int kBatch = 32 * 16 * kSteps;  // row bytes per batch
constexpr int kBig = 1 << 20;       // distance of a masked-out entry
static_assert(kSteps <= 3, "the counts of a batch share one word, 10 bits a step");

struct Top2 {
  int best;
  int idx;
  int second;
};

// Bit i set where byte i of the 4-byte word is nonzero.
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  // __vsetne4 leaves 1 in each nonzero byte (bits 0, 8, 16, 24); the
  // product moves them to bits 28..31 without carries from the cross terms
  return (__vsetne4(w, 0u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ unsigned nonzero16(uint4 v) {
  return nonzero4(v.x) | (nonzero4(v.y) << 4) | (nonzero4(v.z) << 8) |
         (nonzero4(v.w) << 12);
}

__device__ __forceinline__ int distance(const uint4& a0, const uint4& a1,
                                        const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
masked_top2_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   const uint8_t* __restrict__ mask, int n, int m,
                   int32_t* __restrict__ idx_out, int32_t* __restrict__ best_out,
                   int32_t* __restrict__ second_out) {
  // per warp: the batch's allowed columns, as byte offsets into the batch
  __shared__ uint16_t cols[kWarpsPerBlock][kBatch];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n) return;  // the whole warp leaves together
  uint16_t* list = cols[warp];

  // The row is bytes [head, head + m) of the 16-byte chunks from `chunks`;
  // it touches `n_chunks` of them, and the first `n_whole` lie inside the
  // mask's bytes (all but a last chunk that runs past the mask's end).
  const uint8_t* row_bytes = mask + (size_t)row * m;
  const int head = (int)(reinterpret_cast<uintptr_t>(row_bytes) & 15u);
  const uint8_t* chunk_bytes = row_bytes - head;
  const uint4* chunks = reinterpret_cast<const uint4*>(chunk_bytes);
  const int n_chunks = (head + m + 15) >> 4;
  const size_t left = (size_t)n * m - ((size_t)row * m - head);  // bytes to the end
  const int n_whole = left >= 16 * (size_t)n_chunks ? n_chunks : (int)(left >> 4);
  const int tail = (int)(left & 15u);  // bytes of a last chunk past n_whole

  const uint4 a0 = __ldg(a + 2 * row);
  const uint4 a1 = __ldg(a + 2 * row + 1);

  // INT_MAX marks "no entry seen yet": any real entry beats it.
  Top2 t{INT_MAX, INT_MAX, INT_MAX};
  for (int k0 = 0; k0 < n_chunks; k0 += 32 * kSteps) {
    // 1. every chunk of the batch in flight before any is tested
    uint4 v[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int k = k0 + 32 * s + lane;
      v[s] = k < n_whole ? __ldg(chunks + k) : make_uint4(0u, 0u, 0u, 0u);
    }
    if (n_whole < n_chunks) {  // the mask's ragged last chunk: its own bytes
      const int k = n_whole - k0;
      if (k >= 0 && k < 32 * kSteps && (k & 31) == lane) {
        unsigned w[4] = {0u, 0u, 0u, 0u};
        for (int i = 0; i < tail; ++i)
          w[i >> 2] |= (unsigned)__ldg(chunk_bytes + 16 * n_whole + i) << (8 * (i & 3));
        const uint4 last = make_uint4(w[0], w[1], w[2], w[3]);
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
          if (k >> 5 == s) v[s] = last;
      }
    }

    // 2. the allowed columns of the row, compacted in increasing order
    unsigned bits[kSteps];
    unsigned counts = 0;  // 10-bit field per step
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int lo = 16 * (k0 + 32 * s + lane) - head;  // column of the chunk's byte 0
      unsigned keep = 0xFFFFu;
      if (lo < 0) keep = 0xFFFFu << -lo;
      if (lo + 16 > m) keep &= lo < m ? 0xFFFFu >> (lo + 16 - m) : 0u;
      bits[s] = nonzero16(v[s]) & keep;
      counts |= __popc(bits[s]) << (10 * s);
    }
    unsigned incl = counts;  // inclusive prefix over lanes, per step
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned up = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += up;
    }
    const unsigned sums = __shfl_sync(full, incl, 31);
    const unsigned excl = incl - counts;
    int n_listed = 0;  // list entries of the earlier steps
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      int p = n_listed + (int)((excl >> (10 * s)) & 0x3FFu);
      for (unsigned bs = bits[s]; bs; bs &= bs - 1)
        list[p++] = (uint16_t)(16 * (32 * s + lane) + __ffs(bs) - 1);
      n_listed += (int)((sums >> (10 * s)) & 0x3FFu);
    }
    __syncwarp();

    // 3. the candidates, kUnroll descriptor loads in flight per lane
    const int col0 = 16 * k0 - head;
    for (int q0 = 0; q0 < n_listed; q0 += 32 * kUnroll) {
      int col[kUnroll];
      uint4 b0[kUnroll], b1[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + 32 * u + lane;
        col[u] = q < n_listed ? col0 + list[q] : -1;
        if (col[u] >= 0) {
          b0[u] = __ldg(b + 2 * col[u]);
          b1[u] = __ldg(b + 2 * col[u] + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (col[u] < 0) continue;
        const int d = distance(a0, a1, b0[u], b1[u]);
        // columns grow along u and q0, so an equal distance never takes the lead
        if (d < t.best) {
          t.second = t.best;
          t.best = d;
          t.idx = col[u];
        } else {
          t.second = min(t.second, d);
        }
      }
    }
    __syncwarp();  // the list is rewritten by the next batch
  }

  // 4. the warp's result on the total order (distance, column): the least
  // distance, its least column, then the runner-up over every other lane's
  // best and the winning lane's own runner-up
  const unsigned best = __reduce_min_sync(full, (unsigned)t.best);
  const unsigned idx =
      __reduce_min_sync(full, (unsigned)t.best == best ? (unsigned)t.idx : UINT_MAX);
  const bool won = (unsigned)t.best == best && (unsigned)t.idx == idx;
  const unsigned second =
      __reduce_min_sync(full, won ? (unsigned)t.second : (unsigned)t.best);
  if (lane == 0) {
    const bool empty = best == INT_MAX;  // every column masked out
    idx_out[row] = empty ? 0 : (int)idx;
    best_out[row] = empty ? kBig : (int)best;
    second_out[row] = min((int)second, kBig);
  }
}

}  // namespace

// a_words (n, 8) and b_words (m, 8) packed descriptors, 16-byte aligned;
// mask (n, m) bytes, 16-byte aligned, nonzero = candidate allowed; outputs
// (n,) int32 each. Requires n >= 0 and m >= 1. Launches on `stream`;
// returns cudaGetLastError().
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
