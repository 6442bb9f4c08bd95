"""Batched 32x32 patch gather at keypoint corners: kernel K2.

Port of `orbslam3_tpu/kernels/patch_pallas.py:gather_patches`. On a CUDA
tensor `gather_patches` launches the hand-written kernel in
`csrc/patch_gather.cu`; on a CPU tensor it runs `gather_patches_reference`,
the plain PyTorch version of the same function, which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from orbslam3_tpu_torch import _build

PATCH = 32
KERNEL = "gather_patches"


def gather_patches_reference(img: torch.Tensor, ys: torch.Tensor,
                             xs: torch.Tensor) -> torch.Tensor:
    """Plain version: (H, W) image + (N,) corner starts -> (N, 32, 32).

    Starts are clamped to [0, H-32] x [0, W-32], as the kernel clamps them.
    """
    h, w = img.shape
    r = torch.arange(PATCH, device=img.device)
    y0 = torch.clamp(ys.long(), 0, h - PATCH)
    x0 = torch.clamp(xs.long(), 0, w - PATCH)
    return img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def gather_patches(img: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 image + (N,) int32 corner starts -> (N, 32, 32) patches.

    Starts are pre-clamped by the caller to [0, H-32] x [0, W-32].
    """
    if img.device.type == "cpu":
        return gather_patches_reference(img, ys, xs)
    if img.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("gather_patches: img must be a contiguous 2-D float32 "
                         f"tensor, got {img.dtype} {tuple(img.shape)}")
    h, w = img.shape
    if h < PATCH or w < PATCH:
        raise ValueError(f"gather_patches: image {h}x{w} smaller than a patch")
    for name, v in (("ys", ys), ("xs", xs)):
        if (v.dtype != torch.int32 or v.dim() != 1 or not v.is_contiguous()
                or v.device != img.device):
            raise ValueError(f"gather_patches: {name} must be a contiguous 1-D "
                             f"int32 tensor on {img.device}")
    if ys.shape != xs.shape:
        raise ValueError("gather_patches: ys and xs differ in length")
    n = ys.shape[0]
    out = torch.empty((n, PATCH, PATCH), dtype=torch.float32, device=img.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.orb_gather_patches(
            ctypes.c_void_p(img.data_ptr()), h, w,
            ctypes.c_void_p(ys.data_ptr()), ctypes.c_void_p(xs.data_ptr()), n,
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    _build.check(rc, KERNEL)
    _build.launches[KERNEL] += 1
    return out
