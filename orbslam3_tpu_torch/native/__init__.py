"""The host C++ wire codec of the edge server, built on first use.

Port of `orbslam3_tpu/native/__init__.py`'s loader for the port's own copy
of `wirecodec.cpp` (SlamPktVI decode and the stream scan; host code,
no GPU work). One ``g++ -O3 -shared -fPIC`` call builds it into the
package's `_build/` directory (listed in `.gitignore`, shared with the CUDA
kernels' library), named by a hash of the source and the flags, so an
unchanged tree reuses it; the library is loaded with ctypes.

There is no fallback: if g++ is missing or the build fails, `wirecodec()`
raises with g++'s stderr, and the server does not quietly drop to the
numpy codec (`edge/wire.py`'s `decode_frame_py`, the plain version the
tests hold this one against).
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

SOURCE = Path(__file__).resolve().parent / "wirecodec.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None

_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
# C entry point -> (restype, argtypes)
_SIGNATURES = {
    "svi_header": (ctypes.c_int, (_U8, ctypes.c_int64, _I32, _I64, _I32, _I32)),
    "svi_decode": (ctypes.c_int, (_U8, ctypes.c_int64, _F32, _U8, _I64, _F32, _F32)),
    "svi_scan_stream": (ctypes.c_int32, (_U8, ctypes.c_int64, _I64, ctypes.c_int32,
                                         _I64)),
}


def library_path() -> Path:
    """Where the codec for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwirecodec_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, bool]:
    """Compile the codec if needed. Returns (library path, was cached)."""
    out = library_path()
    if out.exists():
        return out, True
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("orbslam3_tpu_torch: g++ not found on PATH; the wire "
                           "codec cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp]
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


def wirecodec() -> ctypes.CDLL:
    """The loaded codec, built on first use (thread-safe, memoized)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _lib = lib
    return _lib
