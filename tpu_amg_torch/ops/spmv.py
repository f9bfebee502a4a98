"""Sparse apply of a CSR matrix on the device: K1 + K2.

K1 ``csr_spmv_capped`` computes Y = A_cap X over the first ``cap``
entries of each CSR row; K2 ``coo_patch`` adds the entries of rows
longer than ``cap`` (the tail) into Y.  Together they give y = A x, and
Y = A X for a row-major X of shape (n, k) with k <= 64 (the bootstrap
smooths k = near-null dim - 1 candidates at once).  A may be square or
rectangular.

- K1 replaces the WELL SpMV Pallas kernel
  (``tpu_amg/ops/well_pallas.py::_kernel``, launched by
  ``_well_spmv_call``); K2 replaces its stray-patch kernel
  (``tpu_amg/ops/well_pallas.py::_stray_kernel``).  The split is the
  same: a row-length capped main kernel plus a patch for what spills.
- Both are bound by bytes (values + indices + gathered x + y), not by
  operations.  This first version is deliberately simple (CUDA C++ in
  ``tpu_amg_torch/csrc/spmv.cu``: a group of lanes per row, shuffle
  reduce; one atomic add per tail entry); speed comes in later changes.
- ``cap`` defaults to 64: at that cap the hub rows of a smoothed-SA
  restriction (a few hundred entries) spill, so K2 runs on the main
  path.  :func:`split_capped` makes the split once, when an operator is
  built.

Each kernel has a plain PyTorch version beside it (gather ``x[cols] *
vals``, then ``index_add_`` over rows).  A wrapper takes the plain
version only when its tensors lie on the CPU; for a CUDA tensor it
launches the kernel or raises.  Each wrapper counts its launches in a
module integer (``csr_spmv_launches``, ``coo_patch_launches``).

The kernels are compiled with nvcc for ``sm_90a`` into
``build/tpu_amg_torch/libamg_kernels.so`` at first launch and loaded
with ctypes; sums accumulate in the value type (float64 or float32).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops._build import build_cuda_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "spmv.cu"
DEFAULT_CAP = 64
MAX_COLUMNS = 64

csr_spmv_launches = 0
coo_patch_launches = 0


def reset_launch_counts() -> None:
    global csr_spmv_launches, coo_patch_launches
    csr_spmv_launches = 0
    coo_patch_launches = 0


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The kernel library, compiled with nvcc on first call."""
    dll = ctypes.CDLL(str(build_cuda_library("libamg_kernels.so", SOURCE)))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in ("f64", "f32"):
        fn = getattr(dll, f"csr_spmv_capped_{suffix}")
        fn.restype = i32
        fn.argtypes = [i64, i32, i32, vp, vp, vp, vp, vp, vp]
        fn = getattr(dll, f"coo_patch_{suffix}")
        fn.restype = i32
        fn.argtypes = [i64, i32, vp, vp, vp, vp, vp, vp]
    dll.kernel_error_string.restype = ctypes.c_char_p
    dll.kernel_error_string.argtypes = [i32]
    return dll


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def split_capped(indptr, indices, data, cap: int):
    """Split a CSR into (capped CSR, tail COO) on the host.

    The capped part keeps the first ``cap`` entries of each row; the
    tail holds the rest as (rows, cols, vals).  Capped part plus tail
    equals the whole matrix."""
    indptr = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(indptr)
    n = len(deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    rank = np.arange(len(rows), dtype=np.int64) - indptr[:-1][rows]
    head = rank < cap
    cap_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.minimum(deg, cap), out=cap_indptr[1:])
    tail = ~head
    return (
        (cap_indptr, indices[head], data[head]),
        (rows[tail], indices[tail], data[tail]),
    )


def _group_size(cap_indptr: np.ndarray) -> int:
    """Lanes per row for K1: the power of two nearest the mean row
    length of the capped part, within [2, 32]."""
    n = len(cap_indptr) - 1
    mean = cap_indptr[-1] / max(n, 1)
    g = 2 ** int(np.rint(np.log2(max(mean, 1.0))))
    return int(min(max(g, 2), 32))


@dataclasses.dataclass
class CappedCSR:
    """A CSR matrix on one device, split for K1 (capped rows) + K2 (tail).

    ``indptr`` int64, ``indices``/``tail_rows``/``tail_cols`` int32,
    values in the working dtype."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    shape: Tuple[int, int]
    cap: int
    group: int
    # expanded row ids of the capped part, for the plain version
    _rows: torch.Tensor = dataclasses.field(default=None, repr=False)

    @staticmethod
    def from_csr(csr, device, dtype=torch.float64, cap: int = DEFAULT_CAP):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        (ip, ix, v), (tr, tc, tv) = split_capped(
            csr.indptr, csr.indices, csr.data, cap
        )
        return CappedCSR(
            indptr=to_device(ip, device, torch.int64),
            indices=to_device(ix, device, torch.int32),
            data=to_device(v, device, dtype),
            tail_rows=to_device(tr, device, torch.int32),
            tail_cols=to_device(tc, device, torch.int32),
            tail_vals=to_device(tv, device, dtype),
            shape=tuple(csr.shape),
            cap=cap,
            group=_group_size(ip),
        )

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return self.data.numel() + self.tail_vals.numel()

    @property
    def n_tail(self) -> int:
        return self.tail_vals.numel()

    def rows(self) -> torch.Tensor:
        if self._rows is None:
            counts = self.indptr[1:] - self.indptr[:-1]
            self._rows = torch.repeat_interleave(
                torch.arange(self.shape[0], device=self.device), counts
            )
        return self._rows

    def to_csr(self):
        """The matrix on the host, capped part and tail together."""
        from tpu_amg_torch.sparse.csr import CSR

        def host(*ts):
            return [t.cpu().numpy() for t in ts]

        rows, cols, vals = host(self.rows(), self.indices, self.data)
        t_rows, t_cols, t_vals = host(self.tail_rows, self.tail_cols,
                                      self.tail_vals)
        return CSR.from_coo(
            np.concatenate([rows, t_rows]), np.concatenate([cols, t_cols]),
            np.concatenate([vals, t_vals]), self.shape,
        )


def check_x(mat, x: torch.Tensor) -> int:
    """Validate x for a device matrix ``mat`` (``CappedCSR`` or ``DIA``:
    ``device``, ``dtype`` and ``shape``); returns k (1 for a vector)."""
    if x.device != mat.device:
        raise ValueError(f"x on {x.device}, matrix on {mat.device}")
    if x.dtype != mat.dtype:
        raise TypeError(f"x is {x.dtype}, matrix is {mat.dtype}")
    if x.dim() not in (1, 2) or x.shape[0] != mat.shape[1]:
        raise ValueError(f"x of shape {tuple(x.shape)} for A {mat.shape}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major)")
    k = 1 if x.dim() == 1 else x.shape[1]
    if not 1 <= k <= MAX_COLUMNS:
        raise ValueError(f"k = {k} columns; the kernels take 1..{MAX_COLUMNS}")
    return k


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = kernel_lib().kernel_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _kernel(name: str, x: torch.Tensor):
    """The C entry point ``name`` for x's dtype; raises off the card."""
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for {x.dtype}")
    return getattr(kernel_lib(), f"{name}_{_SUFFIX[x.dtype]}")


def plain_csr_spmv_capped(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (same contract, any device)."""
    x2 = x.reshape(mat.shape[1], -1)
    y = torch.zeros(mat.shape[0], x2.shape[1], dtype=x.dtype, device=x.device)
    y.index_add_(0, mat.rows(), mat.data[:, None] * x2[mat.indices.long()])
    return y.reshape((mat.shape[0],) + tuple(x.shape[1:]))


def plain_coo_patch(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor) -> None:
    """Plain PyTorch version of K2: y += tail · x, in place."""
    x2 = x.reshape(mat.shape[1], -1)
    y2 = y.view(mat.shape[0], -1)
    y2.index_add_(
        0, mat.tail_rows.long(), mat.tail_vals[:, None] * x2[mat.tail_cols.long()]
    )


def csr_spmv_capped(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """K1: Y = A_cap X (the first ``mat.cap`` entries of every row)."""
    global csr_spmv_launches
    k = check_x(mat, x)
    if x.device.type == "cpu":
        return plain_csr_spmv_capped(mat, x)
    fn = _kernel("csr_spmv_capped", x)
    y = torch.empty((mat.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if mat.shape[0] == 0:
        return y
    with torch.cuda.device(x.device):
        code = fn(
            mat.shape[0], k, mat.group, mat.indptr.data_ptr(),
            mat.indices.data_ptr(), mat.data.data_ptr(), x.data_ptr(),
            y.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "csr_spmv_capped")
    csr_spmv_launches += 1
    return y


def coo_patch(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor) -> None:
    """K2: y[r_t] += v_t · x[c_t] over the tail entries, in place."""
    global coo_patch_launches
    k = check_x(mat, x)
    if (y.shape != (mat.shape[0],) + tuple(x.shape[1:])
            or y.device != x.device or y.dtype != x.dtype
            or not y.is_contiguous()):
        raise ValueError(f"y ({tuple(y.shape)}, {y.dtype}, {y.device}) does "
                         f"not match A {mat.shape} and x")
    if mat.n_tail == 0:
        return
    if x.device.type == "cpu":
        plain_coo_patch(mat, x, y)
        return
    fn = _kernel("coo_patch", x)
    with torch.cuda.device(x.device):
        code = fn(
            mat.n_tail, k, mat.tail_rows.data_ptr(), mat.tail_cols.data_ptr(),
            mat.tail_vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "coo_patch")
    coo_patch_launches += 1


def spmv(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A x (or Y = A X): K1, then K2 on the same stream."""
    y = csr_spmv_capped(mat, x)
    coo_patch(mat, x, y)
    return y


def plain_spmv(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`spmv`, on any device."""
    y = plain_csr_spmv_capped(mat, x)
    plain_coo_patch(mat, x, y)
    return y
