"""Kernel K1's CUDA source, run on the CPU under an emulation of the card.

The kernel runs for real only on the card (tests/test_torch_cuda.py). Here
its source, `orbslam3_tpu_torch/csrc/hamming_top2.cu` up to the C entry
point, is compiled with g++ together with tests/k1_simt.cpp, which
emulates the few CUDA features it uses (a thread per lane, warp shuffles
and reductions through a barrier per warp) and checks every read against
the kernel's inputs. On the cases of tests/torch_parity.py the emulated
kernel must equal the plain version exactly and read nothing outside its inputs: a wrong
column, a broken tie or an over-read of the mask's ragged end shows here
before a run on the card. It says nothing of speed or of the card's
compiler. Skips where there is no g++.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch.kernels import hamming
from torch_parity import CASES, top2_case

HERE = _build.CSRC.parents[1] / "tests"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    out = tmp_path_factory.mktemp("k1_simt")
    src = (_build.CSRC / "hamming_top2.cu").read_text()
    body = src[:src.index('extern "C"')].replace("#include <cuda_runtime.h>", "")
    (out / "k1_body.inc").write_text(body)
    lib = out / "libk1.so"
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{out}",
           "-o", str(lib), str(HERE / "k1_simt.cpp")]
    proc = subprocess.run(cmd, stderr=subprocess.PIPE, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(lib)).emulated_top2
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int,
                                            ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_long
    return fn


def _aligned(arr):
    """A copy of `arr` whose data starts on a 16-byte boundary, as the
    wrapper requires of every input on the card."""
    buf = np.empty(arr.nbytes + 16, np.uint8)
    start = -buf.ctypes.data % 16
    out = buf[start:start + arr.nbytes].view(arr.dtype).reshape(arr.shape)
    out[...] = arr
    return out


def _run(fn, a, b, mask, mask_bytes=None):
    n, m = mask.shape
    a, b = _aligned(a.view(np.int32)), _aligned(b.view(np.int32))
    mk = _aligned(mask.astype(np.uint8) if mask.dtype == bool else mask)
    out = np.zeros((3, n), np.int32)
    bad = fn(a.ctypes.data, b.ctypes.data, mk.ctypes.data,
             n * m if mask_bytes is None else mask_bytes, n, m,
             out[0].ctypes.data, out[1].ctypes.data, out[2].ctypes.data)
    return out, bad


def _plain(a, b, mask):
    got = hamming.masked_top2_reference(torch.from_numpy(a.view(np.int32).copy()),
                                        torch.from_numpy(b.view(np.int32).copy()),
                                        torch.from_numpy(mask))
    return np.stack([x.numpy() for x in got])


@pytest.mark.parametrize("name", CASES)
def test_emulated_kernel_equals_plain(emulated, name):
    a, b, mask = top2_case(name)
    out, bad = _run(emulated, a, b, mask)
    assert bad == 0
    np.testing.assert_array_equal(out, _plain(a, b, mask))


def test_emulated_kernel_any_nonzero_byte_allows(emulated):
    a, b, mask = top2_case("m513")
    weights = mask * np.random.default_rng(4).integers(1, 256, mask.shape)
    out, bad = _run(emulated, a, b, weights.astype(np.uint8))
    assert bad == 0
    np.testing.assert_array_equal(out, _plain(a, b, mask))


def test_emulation_counts_an_over_read(emulated):
    """The bounds check itself: with the mask's range cut one byte short,
    the read of the mask's last byte is counted."""
    a, b, mask = top2_case("last_column")
    _, bad = _run(emulated, a, b, mask, mask_bytes=mask.size - 1)
    assert bad > 0
