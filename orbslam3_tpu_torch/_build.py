"""Build and load the port's CUDA kernels: one nvcc call, one ctypes library.

All `csrc/*.cu` sources are compiled together by a single
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` call into a plain C
shared library under `_build/` (listed in `.gitignore`), named by a hash of
the sources and flags, so an unchanged tree reuses it. No source includes
PyTorch's headers: a plain C interface builds in seconds, where a
`torch.utils.cpp_extension` build takes minutes.

Each C entry point takes raw device pointers, sizes and a `cudaStream_t`,
launches on that stream and returns `cudaGetLastError()`. If nvcc is
missing or the build fails, `library()` raises with nvcc's stderr; there is
no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Kernel launches by kernel name. Each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show the main path went
# through the kernels. Callers reset it with `launches.clear()`.
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as void*).
_SIGNATURES = {
    # a_words, b_words, mask, n, m, idx, best, second, stream
    "orb_masked_top2": (_P, _P, _P, _I, _I, _P, _P, _P, _P),
    # img, h, w, ys, xs, n, out, stream
    "orb_gather_patches": (_P, _I, _I, _P, _P, _I, _P, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "orbslam3_tpu_torch: nvcc not found on PATH or under CUDA_HOME "
        f"({home}); the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liborb_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, bool]:
    """Compile the kernels if needed. Returns (library path, was cached)."""
    out = library_path()
    if out.exists():
        return out, True
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"orbslam3_tpu_torch: nvcc failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, False


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"orbslam3_tpu_torch: {name} failed with cudaError {rc}")
