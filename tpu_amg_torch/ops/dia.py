"""Sparse apply of a DIA (diagonal-format) matrix on the device: K3.

K3 ``dia_spmv`` computes y = A x, and Y = A X for a row-major X of shape
(n, k) with 1 <= k <= 64 (K1's limit), for a square A stored by
diagonals, ``data[d, i] = A[i, i + offsets[d]]``
(:class:`tpu_amg_torch.sparse.dia.DIA`).

- K3 replaces the DIA SpMV Pallas kernel
  (``tpu_amg/ops/dia_pallas.py::_kernel``, launched by ``_dia_spmv_call``
  and ``dia_spmv_pallas``), and with it the XLA slice-FMA apply of
  ``tpu_amg/sparse/dia.py`` (``DIA.mv``/``mm``), which is what the JAX
  package runs on its solve path.
- It is bound by bytes: values + x + y, with no index stream.  This
  first version is deliberately simple (CUDA C++ in
  ``tpu_amg_torch/csrc/dia.cu``: one thread per (row, column), the
  diagonals walked in offset order, out-of-range reads skipped).

The plain PyTorch version beside it is the JAX package's form: one
multiply-accumulate per diagonal over shifted slices.  The wrapper takes
it only when its tensors lie on the CPU; for a CUDA tensor it launches
the kernel or raises.  Launches are counted in ``dia_spmv_launches``.

The kernel is compiled with nvcc for ``sm_90a`` into
``build/tpu_amg_torch/libamg_dia.so`` at first launch and loaded with
ctypes; sums accumulate in the value type (float64 or float32).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from tpu_amg_torch.ops._build import build_cuda_library
from tpu_amg_torch.ops.spmv import check_x

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dia.cu"

dia_spmv_launches = 0


def reset_launch_counts() -> None:
    global dia_spmv_launches
    dia_spmv_launches = 0


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The K3 library, compiled with nvcc on first call."""
    dll = ctypes.CDLL(str(build_cuda_library("libamg_dia.so", SOURCE)))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in ("f64", "f32"):
        fn = getattr(dll, f"dia_spmv_{suffix}")
        fn.restype = i32
        fn.argtypes = [i64, i32, i32, vp, vp, vp, vp, vp]
    dll.dia_error_string.restype = ctypes.c_char_p
    dll.dia_error_string.argtypes = [i32]
    return dll


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def plain_dia_spmv(mat, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (same contract, any device): the JAX
    ``DIA.mv``/``mm`` sum, diagonal by diagonal in offset order, each
    over the rows whose shifted column lies inside the matrix."""
    n = mat.shape[0]
    x2 = x.reshape(n, -1)
    acc = torch.zeros_like(x2)
    for d, off in enumerate(mat.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            acc[lo:hi] += mat.data[d, lo:hi, None] * x2[lo + off:hi + off]
    return acc.reshape(x.shape)


def dia_spmv(mat, x: torch.Tensor) -> torch.Tensor:
    """K3: y = A x (or Y = A X) for a DIA matrix."""
    global dia_spmv_launches
    k = check_x(mat, x)
    if x.device.type == "cpu":
        return plain_dia_spmv(mat, x)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for {x.dtype}")
    lib = kernel_lib()
    y = torch.empty_like(x)
    if mat.shape[0] == 0:
        return y
    with torch.cuda.device(x.device):
        code = getattr(lib, f"dia_spmv_{_SUFFIX[x.dtype]}")(
            mat.shape[0], len(mat.offsets), k, mat.offsets_dev.data_ptr(),
            mat.data.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        msg = lib.dia_error_string(code).decode()
        raise RuntimeError(f"dia_spmv launch failed: CUDA error {code} ({msg})")
    dia_spmv_launches += 1
    return y
