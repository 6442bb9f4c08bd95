"""The port's PNG codec and linear resize against OpenCV, CPU.

`orbslam3_tpu_torch/datasets/imageio.py` replaces `cv2.imread`,
`cv2.imwrite` and `cv2.resize` on the machine with the card, which has no
OpenCV. Here, where OpenCV is installed:
- the decoder is held exactly (every pixel) to `cv2.imread` with
  IMREAD_GRAYSCALE and IMREAD_UNCHANGED, on the PNGs the JAX package's
  writers produce, on random grey, RGB, RGBA and 16-bit images cv2 writes
  at odd widths, and on files the port's encoder writes with each of the
  five row filters forced;
- interlaced and palette files raise;
- the C++ row reconstruction equals its numpy version byte for byte;
- `resize_linear` equals `cv2.resize` exactly on downscales (the 2x
  halving included) and is held to 1 grey level on upscales (the share of
  pixels that differ is printed; it measured 0 here).
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from orbslam3_tpu_torch.datasets import imageio

UPSCALE_TOL = 1   # grey levels


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _same_as_cv2(path: str) -> None:
    for grey, flag in ((True, cv2.IMREAD_GRAYSCALE), (False, cv2.IMREAD_UNCHANGED)):
        ours, ref = imageio.imread(path, grey=grey), cv2.imread(path, flag)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, (path, grey)
        assert np.array_equal(ours, ref), (path, grey)


@pytest.fixture(scope="module")
def writer_pngs(tmp_path_factory):
    """PNGs from the JAX package's writers: EuRoC grey, its stereo and
    fisheye forms, TUM RGB-D grey and 16-bit depth."""
    from orbslam3_tpu.datasets.synth_euroc import write_synth_euroc
    from orbslam3_tpu.datasets.tum_rgbd import write_synth_tum_rgbd
    root = tmp_path_factory.mktemp("writers")
    small = dict(n_frames=2, width=97, height=64, fx=80.0, fy=80.0)
    write_synth_euroc(str(root / "grey"), **small)
    write_synth_euroc(str(root / "stereo"), stereo_baseline=0.1, **small)
    write_synth_euroc(str(root / "fisheye"), fisheye=True, stereo_baseline=0.1, **small)
    write_synth_tum_rgbd(str(root / "tum"), n_frames=2, width=97, height=64)
    paths = sorted(str(p) for p in root.rglob("*.png"))
    assert len(paths) == 2 + 4 + 4 + 4
    return paths


def test_decoder_on_writer_pngs(writer_pngs):
    for p in writer_pngs:
        _same_as_cv2(p)
    depth = [p for p in writer_pngs if f"{os.sep}depth{os.sep}" in p]
    assert depth and all(imageio.imread(p, grey=False).dtype == np.uint16 for p in depth)


@pytest.mark.parametrize("kind,shape", [("grey", (37, 53)), ("grey", (1, 1)),
                                        ("rgb", (31, 45, 3)), ("rgba", (29, 41, 4)),
                                        ("depth16", (33, 47)), ("depth16", (5, 1))])
def test_decoder_on_cv2_pngs(tmp_path, kind, shape):
    rng = np.random.default_rng(sum(shape))
    if kind == "depth16":
        img = rng.integers(0, 65536, shape).astype(np.uint16)
    else:
        img = rng.integers(0, 256, shape).astype(np.uint8)
    # smooth ramps make libpng pick the predicting filters, noise keeps None
    img[: shape[0] // 2] = np.sort(img[: shape[0] // 2], axis=1)
    p = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(p, img)
    _same_as_cv2(p)
    assert np.array_equal(imageio.imread(p, grey=False), cv2.imread(p, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_encoder_each_filter(tmp_path, ftype, dtype):
    """Files the port writes with one filter forced on every row decode in
    cv2 and in both reconstructions to the written pixels."""
    rng = np.random.default_rng(ftype)
    hi = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hi, (23, 61)).astype(dtype)
    img[:11] = np.sort(img[:11], axis=1)
    p = str(tmp_path / "f.png")
    imageio.imwrite(p, img, ftype=ftype)
    assert np.array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), img)
    with open(p, "rb") as f:
        data = f.read()
    assert np.array_equal(imageio.decode_png(data, imageio.unfilter_np), img)
    assert np.array_equal(imageio.decode_png(data), img)
    _same_as_cv2(p)


def test_encoder_chooses_filters(tmp_path):
    """The writers' choice among None, Sub and Up, per row."""
    yy, xx = np.mgrid[0:40, 0:75]
    img = ((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128).astype(np.uint8)
    img[20:] = np.random.default_rng(0).integers(0, 256, (20, 75))
    rows = imageio.choose_filters(img, 1)
    assert set(rows.tolist()) <= {0, 1, 2} and len(set(rows.tolist())) > 1
    p = str(tmp_path / "auto.png")
    imageio.imwrite(p, img)
    assert np.array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), img)


def _adam7_png(img: np.ndarray) -> bytes:
    """An interlaced (Adam7) 8-bit grey PNG, every pass unfiltered."""
    h, w = img.shape
    raw = b""
    for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
                           (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 1)
    return (imageio.SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def test_interlaced_and_palette_raise(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (19, 23)).astype(np.uint8)
    p = str(tmp_path / "adam7.png")
    with open(p, "wb") as f:
        f.write(_adam7_png(img))
    assert np.array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), img)  # a valid file
    with pytest.raises(imageio.PngError, match="interlaced"):
        imageio.imread(p)
    palette = (imageio.SIGNATURE
               + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 1, 8, 3, 0, 0, 0))
               + _png_chunk(b"PLTE", bytes(6))
               + _png_chunk(b"IDAT", zlib.compress(b"\x00\x00\x01"))
               + _png_chunk(b"IEND", b""))
    with pytest.raises(imageio.PngError, match="colour type 3"):
        imageio.decode_png(palette)
    with pytest.raises(IOError):
        imageio.imread(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_matches_numpy(bpp):
    """The C++ reconstruction against the numpy one on random filtered
    rows with every filter type, including rows shorter than a pixel run."""
    rng = np.random.default_rng(bpp)
    for height, stride in ((17, 13 * bpp), (3, bpp), (9, 7 * bpp + 1)):
        rows = rng.integers(0, 256, (height, 1 + stride)).astype(np.uint8)
        rows[:, 0] = rng.integers(0, 5, height)
        raw = rows.reshape(-1)
        assert np.array_equal(imageio.unfilter_native(raw, height, stride, bpp),
                              imageio.unfilter_np(raw, height, stride, bpp))
    rows[1, 0] = 7
    with pytest.raises(imageio.PngError, match="row 1"):
        imageio.unfilter_native(rows.reshape(-1), height, stride, bpp)


def _smooth_image(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 17.0) + np.cos(yy / 13.0)) * 60 + 128
    noise = np.random.default_rng(h * w).normal(0, 9, (h, w))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [((480, 752), (408, 640)), ((480, 752), (333, 500)),
                                     ((480, 752), (241, 376)), ((480, 752), (200, 300)),
                                     ((480, 752), (240, 376)), ((241, 377), (120, 188)),
                                     ((64, 97), (31, 13))])
def test_resize_linear_downscale_exact(src, dst):
    img = _smooth_image(*src)
    ours = imageio.resize_linear(img, dst[1], dst[0])
    assert np.array_equal(ours, cv2.resize(img, (dst[1], dst[0])))


@pytest.mark.parametrize("src,dst", [((240, 376), (480, 752)), ((480, 752), (600, 800)),
                                     ((480, 752), (481, 753)), ((31, 45), (200, 301))])
def test_resize_linear_upscale(src, dst):
    img = _smooth_image(*src)
    diff = np.abs(imageio.resize_linear(img, dst[1], dst[0]).astype(np.int64)
                  - cv2.resize(img, (dst[1], dst[0])).astype(np.int64))
    print(f"resize {src} -> {dst}: max diff {diff.max()}, share differing "
          f"{(diff > 0).mean():.6f}")
    assert diff.max() <= UPSCALE_TOL


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """Without g++ the row reconstruction does not build, and the decoder
    raises: there is no quiet fall back to the numpy version."""
    from orbslam3_tpu_torch import native
    monkeypatch.setattr(native, "library_path", lambda stem: tmp_path / f"lib{stem}.so")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        imageio.decode_png(imageio.encode_png(np.zeros((3, 4), np.uint8)))
