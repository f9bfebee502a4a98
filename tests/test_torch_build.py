"""The build rule of tpu_amg_torch.ops._build: a library is rebuilt when
it is missing or older than its source or one of its headers.  A stub
compiler (a Python one-liner that logs its call and writes the output)
stands in for nvcc."""

import os
import sys

import pytest

from tpu_amg_torch.ops import _build


@pytest.fixture
def stub(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    log = tmp_path / "calls.log"
    cmd = [sys.executable, "-c",
           "import sys; open(sys.argv[1], 'a').write('x');"
           " open(sys.argv[-1], 'w').write('lib')", str(log)]
    return cmd, log


def _touch(path, t):
    if not path.exists():
        path.write_text(path.name)
    os.utime(path, (t, t))


def test_rebuilds_when_source_or_header_is_newer(tmp_path, stub):
    cmd, log = stub
    src, hdr, other = (tmp_path / "k.cu", tmp_path / "k.cuh",
                       tmp_path / "other.cuh")
    for p in (src, hdr, other):
        _touch(p, 1000)

    def build():
        out = _build.build_library("libk.so", src, cmd, headers=[hdr, other])
        return out, len(log.read_text())

    out, calls = build()
    assert out == tmp_path / "build" / "libk.so" and out.read_text() == "lib"
    assert calls == 1
    os.utime(out, (2000, 2000))
    assert build()[1] == 1  # fresh: newer than source and headers
    _touch(hdr, 3000)
    assert build()[1] == 2  # a header edit rebuilds
    os.utime(out, (4000, 4000))
    _touch(src, 5000)
    assert build()[1] == 3  # a source edit rebuilds
    os.utime(out, (6000, 6000))
    assert build()[1] == 3
    out.unlink()
    assert build()[1] == 4  # a missing library builds
    assert not list((tmp_path / "build").glob(".*.tmp"))


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("")
    with pytest.raises(RuntimeError, match="building libk.so failed"):
        _build.build_library("libk.so", src,
                             [sys.executable, "-c", "raise SystemExit(1)"])
    assert not list((tmp_path / "build").iterdir())


def test_cuda_sources_count_their_headers(monkeypatch):
    seen = {}

    def fake(name, source, cmd, headers=()):
        seen.update(name=name, cmd=cmd, headers=list(headers))
        return source

    monkeypatch.setattr(_build, "build_library", fake)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    src = _build.REPO_ROOT / "tpu_amg_torch" / "csrc" / "spmv.cu"
    _build.build_cuda_library("libamg_kernels.so", src)
    assert src.parent / "csr_rowblock.cuh" in seen["headers"]
    assert "arch=compute_90a,code=sm_90a" in seen["cmd"]
    assert not any(flag.startswith("-D") for flag in seen["cmd"])
    # the row-block probe's builds of other sizes
    _build.build_cuda_library("libamg_kernels_s1024.so", src,
                              defines=["ROWBLOCK_ENTRIES=1024"])
    assert seen["name"] == "libamg_kernels_s1024.so"
    assert "-DROWBLOCK_ENTRIES=1024" in seen["cmd"]
