"""PNG read and write, and OpenCV's linear resize, without OpenCV.

The JAX package's loaders, writers and runners call `cv2.imread`,
`cv2.imwrite` and `cv2.resize`; the machine with the card has no OpenCV, so
the port keeps its own codec on numpy and the stdlib `zlib`:

- `imread(path, grey=True)` gives what `cv2.imread(path,
  cv2.IMREAD_GRAYSCALE)` gives, and `grey=False` what
  `cv2.IMREAD_UNCHANGED` gives, for 8-bit grey, RGB and RGBA and 16-bit
  grey files, with all five row filters. libpng's rules: RGB(A) to grey is
  `(9797 R + 19234 G + 3737 B) >> 15` (its `rgb_to_gray` at 0.299 / 0.587,
  truncated; alpha dropped), 16-bit grey read as grey is `v >> 8`, and an
  unchanged colour image comes back BGR(A). Interlaced, palette,
  grey+alpha, sub-byte and 16-bit colour files raise.
- Row reconstruction runs in host C++ (`native/pngfilter.cpp`, built on
  first use; a failed build raises); `unfilter_np` is its plain version.
- `imwrite(path, img)` writes 8-bit grey and 16-bit grey (depth) files,
  choosing None, Sub or Up for each row by the least sum of absolute
  filtered bytes; `filter_rows` can force any of the five filters.
- `resize_linear(img, width, height)` is `cv2.resize(img, (width,
  height))` of a uint8 image (INTER_LINEAR): an exact 2x halving is
  OpenCV's INTER_AREA, the rounded 2x2 mean; otherwise 11-bit
  fixed-point coefficients as OpenCV computes them, its SIMD rounding in
  the vertical pass.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each PNG colour type this codec reads
_CHANNELS = {0: 1, 2: 3, 6: 4}


class PngError(ValueError):
    """A file this codec does not read (or not a PNG)."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG file")
    off = 8
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        if len(body) != length:
            raise PngError(f"truncated {kind!r} chunk")
        yield kind, body
        off += 12 + length
        if kind == b"IEND":
            return
    raise PngError("no IEND chunk")


def unfilter_np(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the PNG row filters in numpy (the plain version of
    `native/pngfilter.cpp`): `raw` is (height * (1 + stride),) uint8, each
    row its filter byte and filtered bytes; returns (height, stride) uint8."""
    rows = np.asarray(raw, np.uint8).reshape(height, 1 + stride)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        ftype, x = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            r = x
        elif ftype == 1:   # a running sum along each byte lane of a pixel
            pad = (-stride) % bpp
            lanes = np.concatenate([x, np.zeros(pad, np.int64)]).reshape(-1, bpp)
            r = (np.cumsum(lanes, axis=0) % 256).reshape(-1)[:stride]
        elif ftype == 2:
            r = (x + prev) % 256
        elif ftype in (3, 4):
            r = np.zeros(stride, np.int64)
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                r[i] = (x[i] + pred) % 256
        else:
            raise PngError(f"row {y}: filter type {ftype}")
        out[y] = r
        prev = r.astype(np.int64)
    return out


def unfilter_native(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """`unfilter_np` in host C++ (`native/pngfilter.cpp`)."""
    from orbslam3_tpu_torch import native
    src = np.ascontiguousarray(raw, np.uint8)
    if src.size != height * (1 + stride):
        raise PngError(f"image data holds {src.size} bytes, not {height * (1 + stride)}")
    out = np.empty((height, stride), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = native.pngfilter().png_unfilter(src.ctypes.data_as(u8), height, stride, bpp,
                                         out.ctypes.data_as(u8))
    if rc != 0:
        raise PngError(f"row {-rc - 1}: bad filter type")
    return out


def decode_png(data: bytes, unfilter=unfilter_native) -> np.ndarray:
    """The stored pixels of a PNG: (H, W) uint8 grey, (H, W, 3) RGB,
    (H, W, 4) RGBA, or (H, W) uint16 grey (native byte order)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise PngError("interlaced PNGs are not read")
    if ctype not in _CHANNELS:
        raise PngError(f"colour type {ctype} is not read (grey, RGB and RGBA only)")
    ch = _CHANNELS[ctype]
    if depth not in (8, 16) or (depth == 16 and ch != 1):
        raise PngError(f"bit depth {depth} with colour type {ctype} is not read")
    nbytes = depth // 8
    stride = width * ch * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = unfilter(raw, height, stride, ch * nbytes)
    if depth == 16:
        return rows.view(">u2").reshape(height, width).astype(np.uint16)
    return rows.reshape((height, width) if ch == 1 else (height, width, ch))


def to_grey(pixels: np.ndarray) -> np.ndarray:
    """libpng's grey of decoded pixels, as `cv2.IMREAD_GRAYSCALE` reads
    them: 16-bit grey >> 8, RGB(A) by `(9797 R + 19234 G + 3737 B) >> 15`."""
    if pixels.dtype == np.uint16:
        return (pixels >> 8).astype(np.uint8)
    if pixels.ndim == 2:
        return pixels
    rgb = pixels[..., :3].astype(np.uint32)
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2]) >> 15
            ).astype(np.uint8)


def imread(path: str, grey: bool = True) -> np.ndarray:
    """`cv2.imread(path, IMREAD_GRAYSCALE)` (grey) or `IMREAD_UNCHANGED`
    (colour as BGR / BGRA, 16-bit as uint16). Raises IOError where
    `cv2.imread` returns None."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise IOError(f"cannot read {path}") from e
    pixels = decode_png(data)
    if grey:
        return to_grey(pixels)
    if pixels.ndim == 3:
        return np.ascontiguousarray(pixels[..., [2, 1, 0, 3][:pixels.shape[2]]])
    return pixels


def filter_rows(rows: np.ndarray, bpp: int, ftype) -> np.ndarray:
    """Forward PNG filtering in numpy (every filter reads only raw bytes, so
    all five vectorise): `rows` (H, stride) uint8 -> (H, 1 + stride) with
    each row's filter byte. `ftype` is one type (0-4) for every row or an
    (H,) array of them."""
    x = rows.astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])   # (5, H, stride)
    ftype = np.broadcast_to(np.asarray(ftype, np.int64), (x.shape[0],))
    pred = np.take_along_axis(preds, ftype[None, :, None], axis=0)[0]
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = ftype
    out[:, 1:] = (x - pred) % 256
    return out


def choose_filters(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Per row, the one of None, Sub and Up whose filtered bytes, read as
    signed, have the least absolute sum (libpng's heuristic over three)."""
    scores = []
    for f in (0, 1, 2):
        fb = filter_rows(rows, bpp, f)[:, 1:].astype(np.int16)
        scores.append(np.abs(np.where(fb > 127, fb - 256, fb)).sum(axis=1))
    return np.argmin(np.stack(scores), axis=0)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, ftype=None, level: int = 6) -> bytes:
    """A PNG of an (H, W) uint8 or uint16 grey image. `ftype` forces a
    filter type (0-4) on every row; None chooses among None, Sub and Up."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise PngError(f"writes (H, W) uint8 or uint16 images, not {img.dtype} "
                       f"{img.shape}")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = (img.astype(">u2") if depth == 16 else img).view(np.uint8).reshape(h, -1)
    bpp = img.dtype.itemsize
    if ftype is None:
        ftype = choose_filters(rows, bpp)
    body = zlib.compress(filter_rows(rows, bpp, ftype).tobytes(), level)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
            + _chunk(b"IDAT", body) + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray, ftype=None) -> None:
    """Write an (H, W) uint8 or uint16 grey image as a PNG."""
    data = encode_png(img, ftype)
    with open(path, "wb") as f:
        f.write(data)


# -- OpenCV's INTER_LINEAR resize of uint8 images ----------------------------

_COEF_SCALE = 2048   # INTER_RESIZE_COEF_SCALE: 11 fractional bits


def _linear_axis(n_src: int, n_dst: int, clamp_weights: bool):
    """Source indices (n_dst, 2) and 11-bit weights (n_dst, 2) along one
    axis, as OpenCV's resize computes them: the float32 source coordinate
    (d + 0.5) * (src/dst) - 0.5, floored, each weight rounded on its own.
    Past an edge the taps clamp to the edge pixel; the horizontal pass also
    moves the whole weight onto it (`clamp_weights`), the vertical pass
    keeps the fraction."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low = s < 0
        high = s >= n_src - 1
        f[low | high] = 0.0
        s = np.where(low, 0, np.where(high, n_src - 1, s))
    idx = np.clip(np.stack([s, s + 1], axis=-1), 0, n_src - 1)
    w = np.stack([np.rint((np.float32(1.0) - f) * _COEF_SCALE),
                  np.rint(f * _COEF_SCALE)], axis=-1).astype(np.int64)
    return idx, w


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height))` of an (H, W) uint8 image."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes (H, W) uint8, not {img.dtype} {img.shape}")
    h, w = img.shape
    if (w, h) == (width, height):
        return img.copy()
    if w == 2 * width and h == 2 * height:   # OpenCV takes INTER_AREA here
        x = img.astype(np.int32)
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
    ix, wx = _linear_axis(w, width, True)
    iy, wy = _linear_axis(h, height, False)
    x = img.astype(np.int64)
    rows = x[:, ix[:, 0]] * wx[:, 0] + x[:, ix[:, 1]] * wx[:, 1]     # (h, width), 11 bits
    s0, s1 = rows[iy[:, 0]], rows[iy[:, 1]]
    b0, b1 = wy[:, :1], wy[:, 1:]
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
