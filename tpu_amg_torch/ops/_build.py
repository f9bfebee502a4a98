"""Compile one source file into a shared library at first use.

Libraries go to ``build/tpu_amg_torch/`` at the repository root (listed
in ``.gitignore``), never into a package directory.  A library is
rebuilt when it is missing or older than its source or any header the
source includes (for a CUDA source: every ``*.cuh`` beside it).  The compiler
writes to a per-process temporary name that is renamed into place, so
processes that build at the same time never load a half-written file.
A failed build raises; there is no fallback.

CUDA sources build with ``nvcc`` for ``sm_90a`` into a plain-C shared
library each, loaded with ctypes; each library has one source, so that
its freshness check stays the source's and its headers' own.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "tpu_amg_torch"


def build_library(name: str, source: Path, compile_cmd: list,
                  headers=()) -> Path:
    """Build ``source`` into ``BUILD_DIR / name`` with ``compile_cmd``
    (the compiler and its flags; the source and ``-o`` are appended),
    unless the library is newer than ``source`` and every one of
    ``headers``."""
    out = BUILD_DIR / name
    newest = max(p.stat().st_mtime for p in (source, *headers))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{name}.{os.getpid()}.tmp")
    cmd = [*compile_cmd, str(source), "-o", str(tmp)]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed:\n{' '.join(cmd)}\n{result.stderr}"
        )
    os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_cuda_library(name: str, source: Path, defines=()) -> Path:
    """Build one ``.cu`` file with nvcc for ``sm_90a`` into ``name``, with
    the macros ``defines`` ("NAME=VALUE"); the ``.cuh`` headers of its
    directory count for its freshness."""
    cmd = [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", *(f"-D{d}" for d in defines),
    ]
    return build_library(name, source, cmd,
                         headers=sorted(source.parent.glob("*.cuh")))
