"""The port's build loader and device policy, on the CPU.

nvcc is not installed here, so the build is driven through a stand-in
`nvcc` script that records its arguments and writes the output file: this
checks the one-call command line, the content-keyed cache and the error
paths. Loading and launching the real library happens on the card
(chip_smoke.py and the `cuda`-marked tests)."""

import os
import stat
import sys

import pytest
import torch

from orbslam3_tpu_torch import _build, device
from orbslam3_tpu_torch.kernels import hamming, patch


def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return bindir


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", d)
    return d


def test_one_nvcc_call_builds_every_source_then_caches(tmp_path, monkeypatch, build_dir):
    log = tmp_path / "args.txt"
    bindir = _fake_nvcc(tmp_path, f"""
args = sys.argv[1:]
open({str(log)!r}, "a").write(" ".join(args) + "\\n")
open(args[args.index("-o") + 1], "wb").write(b"so")
""")
    monkeypatch.setenv("PATH", str(bindir))
    path, cached = _build.build()
    assert not cached and path.exists() and path.parent == build_dir
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    args = calls[0].split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
    sources = [a for a in args if a.endswith(".cu")]
    assert sorted(os.path.basename(s) for s in sources) == [
        "hamming_top2.cu", "patch_gather.cu"]
    path2, cached2 = _build.build()
    assert (path2, cached2) == (path, True)
    assert len(log.read_text().splitlines()) == 1  # no second compile


def test_library_name_is_keyed_by_sources(build_dir):
    p = _build.library_path()
    assert p == _build.library_path()
    assert p.name.startswith("liborb_kernels_") and p.suffix == ".so"


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch, build_dir):
    bindir = _fake_nvcc(tmp_path, 'sys.stderr.write("error: boom in kernel\\n"); sys.exit(2)')
    monkeypatch.setenv("PATH", str(bindir))
    with pytest.raises(RuntimeError, match="boom in kernel"):
        _build.build()
    assert not any(build_dir.glob("*.so"))  # no half-built library left


def test_missing_nvcc_raises(tmp_path, monkeypatch, build_dir):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_check_raises_on_cuda_error():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "k")


def test_device_policy():
    assert device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device.resolve(None)
        with pytest.raises(RuntimeError):
            device.resolve("cuda")


def test_tf32_is_off():
    import orbslam3_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_plain_versions_do_not_count_as_launches():
    before = dict(_build.launches)
    img = torch.zeros((64, 64))
    ys = torch.zeros(3, dtype=torch.int32)
    patch.gather_patches(img, ys, ys)
    w = torch.zeros((3, 8), dtype=torch.int32)
    hamming.masked_top2(w, w, torch.ones((3, 3), dtype=torch.bool))
    assert dict(_build.launches) == before
