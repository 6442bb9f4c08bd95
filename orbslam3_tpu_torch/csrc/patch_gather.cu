// Batched 32x32 patch gather at keypoint corners.
//
// Replaces the Pallas kernel orbslam3_tpu/kernels/patch_pallas.py:gather_patches
// (body _patch_kernel): out[k, r, c] = img[y0[k] + r, x0[k] + c] for N corner
// starts into an (H, W) float32 image. Feeds steered BRIEF
// (kernels/orb_descriptor.py:brief_descriptors).
//
// Bound on the H100 at the tracking shapes (the (2272, 768) blurred pyramid
// atlas, N = 1200 keypoints): the kernel reads at most 4.9 MB of patch pixels
// (less where patches overlap) and writes 4.9 MB, about 3 us at 3.35 TB/s,
// with no arithmetic. At that size the launch costs as much as the copy.
//
// Design: one warp per keypoint, eight keypoints per block. Lane c copies
// column c of each of the 32 rows, so every row is one 128-byte read and one
// 128-byte write. Starts are clamped to [0, H-32] x [0, W-32] in the kernel
// (the caller pre-clamps them, as it does for the Pallas kernel; the clamp
// keeps a bad start from reading out of bounds). The Pallas kernel's aligned
// (40, 256) window, 8-way row select and one-hot shift matmul exist only
// because Mosaic has no unaligned VMEM slice; none of that is needed here,
// and the image needs no padding.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPatch = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gather_patches_kernel(const float* __restrict__ img, int h, int w,
                      const int32_t* __restrict__ ys,
                      const int32_t* __restrict__ xs, int n,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;
  const int y0 = min(max(ys[k], 0), h - kPatch);
  const int x0 = min(max(xs[k], 0), w - kPatch);
  const float* src = img + (size_t)y0 * w + x0 + lane;
  float* dst = out + (size_t)k * kPatch * kPatch + lane;
#pragma unroll 8
  for (int r = 0; r < kPatch; ++r) {
    dst[r * kPatch] = __ldg(src + (size_t)r * w);
  }
}

}  // namespace

// img (h, w) float32 with h, w >= 32; ys, xs (n,) int32 corner starts;
// out (n, 32, 32) float32. Launches on `stream`; returns cudaGetLastError().
extern "C" int orb_gather_patches(const void* img, int h, int w, const void* ys,
                                  const void* xs, int n, void* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gather_patches_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(xs), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
