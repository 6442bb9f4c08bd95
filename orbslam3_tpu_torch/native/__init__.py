"""The port's host C++ helpers, each built on first use.

- `wirecodec.cpp`: the edge server's wire codec (SlamPktVI decode and the
  stream scan). Port of `orbslam3_tpu/native/__init__.py`'s loader for the
  port's own copy of the source.
- `pngfilter.cpp`: PNG row reconstruction for `datasets/imageio.py`.

Host code, no GPU work. One ``g++ -O3 -shared -fPIC`` call builds each
into the package's `_build/` directory (listed in `.gitignore`, shared with
the CUDA kernels' library), named by a hash of the source and the flags,
so an unchanged tree reuses it; the library is loaded with ctypes.

There is no fallback: if g++ is missing or the build fails, `wirecodec()`
and `pngfilter()` raise with g++'s stderr, and their callers do not quietly
drop to the numpy versions (`edge/wire.py`'s `decode_frame_py`,
`datasets/imageio.py`'s `unfilter_np`, the plain versions the tests hold
these against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from orbslam3_tpu_torch._build import BUILD_DIR

HERE = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
# library stem -> {C entry point -> (restype, argtypes)}
_SIGNATURES = {
    "wirecodec": {
        "svi_header": (ctypes.c_int, (_U8, ctypes.c_int64, _I32, _I64, _I32, _I32)),
        "svi_decode": (ctypes.c_int, (_U8, ctypes.c_int64, _F32, _U8, _I64, _F32, _F32)),
        "svi_scan_stream": (ctypes.c_int32, (_U8, ctypes.c_int64, _I64, ctypes.c_int32,
                                             _I64)),
    },
    "pngfilter": {
        "png_unfilter": (ctypes.c_int64, (_U8, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int32, _U8)),
    },
}


def library_path(stem: str) -> Path:
    """Where the library of `stem`.cpp for the current source lives (built
    or not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((HERE / f"{stem}.cpp").read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(stem: str) -> tuple[Path, bool]:
    """Compile `stem`.cpp if needed. Returns (library path, was cached)."""
    out = library_path(stem)
    if out.exists():
        return out, True
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"orbslam3_tpu_torch: g++ not found on PATH; {stem} "
                           "cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, str(HERE / f"{stem}.cpp"), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"orbslam3_tpu_torch: g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, False


def _load(stem: str) -> ctypes.CDLL:
    """The loaded library of `stem`, built on first use (thread-safe,
    memoized)."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _lock:
        if stem not in _libs:
            path, _ = build(stem)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _libs[stem] = lib
    return _libs[stem]


def wirecodec() -> ctypes.CDLL:
    """The edge server's wire codec."""
    return _load("wirecodec")


def pngfilter() -> ctypes.CDLL:
    """The PNG row reconstruction of `datasets/imageio.py`."""
    return _load("pngfilter")
