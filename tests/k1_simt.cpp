// Host emulation of the CUDA features kernel K1 (csrc/hamming_top2.cu) uses,
// so its source runs on the CPU under g++ (tests/test_torch_k1_emulated.py).
//
// Each lane is a std::thread; the warps of a block run together and blocks
// one after another. Warp shuffles, redux.sync and __syncwarp exchange
// values through a barrier per warp. __ldg checks every read against the
// kernel's three inputs and counts reads outside them (or misaligned
// 16-byte reads) instead of faulting. The test compiles this file with the
// kernel's body (its source up to the C entry point) as "k1_body.inc".

#include <atomic>
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static  // one block runs at a time
#define __restrict__

struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct Dim3 {
  unsigned x, y, z;
};
thread_local Dim3 threadIdx, blockIdx;

struct Range {
  const char* lo;
  const char* hi;
};
static Range g_inputs[3];
static std::atomic<long> g_bad_reads{0};

inline void check_read(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  if (bytes == 16 && reinterpret_cast<uintptr_t>(c) % 16) ++g_bad_reads;
  for (const Range& r : g_inputs)
    if (c >= r.lo && c + bytes <= r.hi) return;
  ++g_bad_reads;
}
inline uint4 __ldg(const uint4* p) {
  check_read(p, 16);
  uint4 v;
  std::memcpy(&v, p, 16);
  return v;
}
inline uint8_t __ldg(const uint8_t* p) {
  check_read(p, 1);
  return *p;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int min(int a, int b) { return a < b ? a : b; }
inline unsigned __vsetne4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int k = 0; k < 4; ++k)
    if (((a >> 8 * k) & 255u) != ((b >> 8 * k) & 255u)) r |= 1u << 8 * k;
  return r;
}

struct Warp {
  std::barrier<>* bar;
  unsigned long long* slots;  // one per lane
};
thread_local Warp g_warp;

inline int lane_id() { return static_cast<int>(threadIdx.x & 31); }

// Every lane publishes `v`; returns what lane `src` published.
template <class T>
T exchange(T v, int src) {
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_warp.slots[lane_id()] = u;
  g_warp.bar->arrive_and_wait();
  const unsigned long long r = g_warp.slots[src];
  g_warp.bar->arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T>
T __shfl_up_sync(unsigned, T v, int off) {
  const T up = exchange(v, lane_id() >= off ? lane_id() - off : lane_id());
  return lane_id() >= off ? up : v;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return exchange(v, src);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int off) {
  return exchange(v, lane_id() ^ off);
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  g_warp.slots[lane_id()] = v;
  g_warp.bar->arrive_and_wait();
  unsigned r = UINT_MAX;
  for (int src = 0; src < 32; ++src)
    r = g_warp.slots[src] < r ? static_cast<unsigned>(g_warp.slots[src]) : r;
  g_warp.bar->arrive_and_wait();
  return r;
}
inline void __syncwarp() { g_warp.bar->arrive_and_wait(); }

#include "k1_body.inc"

// The kernel over the whole grid, as orb_masked_top2 launches it. The mask's
// readable range is `mask_bytes` long (n * m unless a test shortens it).
// Returns the number of reads outside the inputs.
extern "C" long emulated_top2(const void* a, const void* b, const void* mask,
                              long mask_bytes, int n, int m, void* idx,
                              void* best, void* second) {
  g_inputs[0] = {static_cast<const char*>(a), static_cast<const char*>(a) + 32L * n};
  g_inputs[1] = {static_cast<const char*>(b), static_cast<const char*>(b) + 32L * m};
  g_inputs[2] = {static_cast<const char*>(mask),
                 static_cast<const char*>(mask) + mask_bytes};
  g_bad_reads = 0;
  const int warps = kWarpsPerBlock;
  for (int blk = 0; blk < (n + warps - 1) / warps; ++blk) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::vector<unsigned long long>> slots(
        warps, std::vector<unsigned long long>(32));
    for (int w = 0; w < warps; ++w) bars.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32 * warps; ++t)
      lanes.emplace_back([&, t] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {static_cast<unsigned>(blk), 0, 0};
        g_warp = {bars[t >> 5].get(), slots[t >> 5].data()};
        masked_top2_kernel(static_cast<const uint4*>(a), static_cast<const uint4*>(b),
                           static_cast<const uint8_t*>(mask), n, m,
                           static_cast<int32_t*>(idx), static_cast<int32_t*>(best),
                           static_cast<int32_t*>(second));
      });
    for (std::thread& lane : lanes) lane.join();
  }
  return g_bad_reads;
}
