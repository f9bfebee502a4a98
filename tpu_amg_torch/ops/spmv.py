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
  operations.  K1 is a row-block streaming kernel (CUDA C++ in
  ``tpu_amg_torch/csrc/csr_rowblock.cuh``, instantiated by
  ``csrc/spmv.cu``): :func:`row_blocks` cuts the rows once, on the
  host, into blocks of at most ``BLOCK_ENTRIES`` entries and half as
  many rows; one thread block streams a row block's
  entries in coalesced loads, stages the products in shared memory and
  reduces its rows from there.  K2 is a segmented row reduction over the
  tail, which keeps CSR order: :func:`tail_row_table` lists once, on the
  host, the rows that spill and where each one's tail starts; a team
  of :func:`k2_lanes` lanes owns such a row (a block of 8 warps a row
  of more than ``LONG_TAIL_ROW`` tail entries), sums it in a fixed
  order and adds it into Y: one writer a row, no atomics.
- ``cap`` defaults to 64: at that cap the hub rows of a smoothed-SA
  restriction (a few hundred entries) spill, so K2 runs on the main
  path.  :func:`split_capped` makes the split once, when an operator is
  built.

Each kernel has a plain PyTorch version beside it (gather ``x[cols] *
vals``, then ``index_add_`` over rows).  A wrapper takes the plain
version only when its tensors lie on the CPU; for a CUDA tensor it
launches the kernel or raises.  Each wrapper counts its launches in a
module integer (``csr_spmv_launches``, ``coo_patch_launches``), and by
(rows, cols, k) in ``csr_spmv_launches_by_shape`` and
``coo_patch_launches_by_shape``.

The kernels are compiled with nvcc for ``sm_90a`` into
``build/tpu_amg_torch/libamg_kernels.so`` at first launch and loaded
with ctypes; sums accumulate in the value type (float64 or float32).
"""

from __future__ import annotations

import collections
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
# K1's row blocks: S entries and S / 2 rows at most; the kernel library is
# compiled for this S (ROWBLOCK_ENTRIES in csrc/csr_rowblock.cuh: S / 4
# threads, 4 entries each).  Chosen by tools/rowblocks.py on the SA path's
# own matrices (PERF.md).
BLOCK_ENTRIES = 256
# K2: a tail row of more entries than this (a warp's step of loads at
# k = 1: 4 entries a lane) takes a block of 8 warps; the library is
# compiled for it (kLongTailRow in csrc/spmv.cu)
LONG_TAIL_ROW = 128
# K2 takes teams of no fewer lanes a tail row than this (k2_lanes)
K2_MIN_LANES = 8
THREADS_PER_SM = 2048  # resident on a Hopper SM
_INT32_MAX = 2**31 - 1

csr_spmv_launches = 0
coo_patch_launches = 0
csr_spmv_launches_by_shape = collections.Counter()
coo_patch_launches_by_shape = collections.Counter()


def reset_launch_counts() -> None:
    global csr_spmv_launches, coo_patch_launches
    csr_spmv_launches = 0
    coo_patch_launches = 0
    csr_spmv_launches_by_shape.clear()
    coo_patch_launches_by_shape.clear()


def check_block_entries(dll: ctypes.CDLL, entries: int = BLOCK_ENTRIES):
    """Raise unless the library ``dll`` was compiled for row blocks of
    ``entries``."""
    dll.row_block_entries.restype = ctypes.c_int
    built = dll.row_block_entries()
    if built != entries:
        raise RuntimeError(f"{dll._name} is compiled for row blocks of "
                           f"{built} entries, the tables are cut for {entries}")


def check_long_tail_row(dll: ctypes.CDLL):
    """Raise unless the library ``dll`` takes K2's long rows past
    ``LONG_TAIL_ROW`` entries, as the host lists them."""
    dll.long_tail_row.restype = ctypes.c_int
    built = dll.long_tail_row()
    if built != LONG_TAIL_ROW:
        raise RuntimeError(f"{dll._name} takes long tail rows past {built} "
                           f"entries, the tables list those past "
                           f"{LONG_TAIL_ROW}")


def bind_kernel_lib(path: Path, entries: int = BLOCK_ENTRIES) -> ctypes.CDLL:
    """Load a build of ``spmv.cu`` compiled for row blocks of
    ``entries`` and declare its entry points."""
    dll = ctypes.CDLL(str(path))
    check_block_entries(dll, entries)
    check_long_tail_row(dll)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in ("f64", "f32"):
        fn = getattr(dll, f"csr_spmv_capped_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
        fn = getattr(dll, f"coo_patch_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
    dll.kernel_error_string.restype = ctypes.c_char_p
    dll.kernel_error_string.argtypes = [i32]
    return dll


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The kernel library, compiled with nvcc on first call."""
    return bind_kernel_lib(build_cuda_library("libamg_kernels.so", SOURCE))


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


def tail_row_table(indptr, cap: int):
    """K2's tail row table: the rows longer than ``cap`` (int32,
    increasing) and where each one's tail starts in the tail arrays of
    :func:`split_capped` (int32, one more entry than there are such
    rows)."""
    spill = np.diff(np.asarray(indptr, dtype=np.int64)) - cap
    row_ids = np.flatnonzero(spill > 0)
    ptr = np.zeros(len(row_ids) + 1, dtype=np.int64)
    np.cumsum(spill[row_ids], out=ptr[1:])
    if ptr[-1] > _INT32_MAX:
        raise ValueError(f"a tail of {ptr[-1]} entries passes 32-bit offsets")
    return row_ids.astype(np.int32), ptr.astype(np.int32)


def k2_lanes(n_rows: int, k: int, sms: int) -> int:
    """K2's lanes a tail row for a tail of ``n_rows`` rows at k columns
    on a card of ``sms`` SMs: a warp, or at k = 1 half as many, down to
    ``K2_MIN_LANES``, while the rows' teams would not all be resident at
    once (chosen on both paths' tails, PERF.md)."""
    lanes = 32
    while (k == 1 and lanes > K2_MIN_LANES
           and n_rows * lanes > sms * THREADS_PER_SM):
        lanes //= 2
    return lanes


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_blocks(cap_indptr: np.ndarray,
               max_entries: int = BLOCK_ENTRIES) -> np.ndarray:
    """K1's row-block table (int32, n_blocks + 1): block b holds rows
    ``table[b]`` to ``table[b + 1]``, whose entries span at most
    ``max_entries / 4`` aligned 4-entry chunks (so at most
    ``max_entries`` entries), and at most ``max_entries / 2`` rows (two
    a thread of the kernel's block: its shared row-pointer array).

    Rows go to buckets by the chunk of their first entry, ``wc`` chunks a
    bucket, ``wc`` = the budget less the chunks a longest row can reach
    past its bucket; a bucket of more rows than that is split.  Every row
    with entries fits: its length is at most the cap."""
    if max_entries % 4 or max_entries < 4:
        raise ValueError(f"max_entries {max_entries}: a positive multiple of 4")
    max_rows = max_entries // 2
    indptr = np.asarray(cap_indptr, dtype=np.int64)
    n = len(indptr) - 1
    longest = int(np.diff(indptr).max()) if n else 0
    wc = max_entries // 4 - (longest + 2) // 4
    if wc < 1:
        raise ValueError(f"a row of {longest} entries does not fit a block "
                         f"of {max_entries}")
    bucket = indptr[:-1] // 4 // wc
    row = np.arange(n, dtype=np.int64)
    first = np.maximum.accumulate(
        np.where(np.r_[True, bucket[1:] != bucket[:-1]], row, 0))
    starts = np.flatnonzero((row - first) % max_rows == 0)
    return np.r_[starts, n].astype(np.int32)


def block_table(cap_indptr: np.ndarray, device,
                max_entries: int = BLOCK_ENTRIES) -> dict:
    """:func:`row_blocks` on ``device`` as a ``CappedCSR``'s
    ``block_rows`` and ``block_ptr``."""
    rows = row_blocks(cap_indptr, max_entries)
    return dict(block_rows=to_device(rows, device, torch.int32),
                block_ptr=to_device(cap_indptr[rows], device, torch.int32))


@dataclasses.dataclass
class CappedCSR:
    """A CSR matrix on one device, split for K1 (capped rows) + K2 (tail).

    ``indptr`` int64, ``indices``/``tail_cols`` int32, values in the
    working dtype.  K1's row-block table, built for blocks of
    ``BLOCK_ENTRIES``: ``block_rows`` (int32, n_blocks + 1, from
    :func:`row_blocks`) and ``block_ptr``, the first entry of each block
    (``indptr[block_rows]``, int32), so that a block's bounds are two
    loads of the table.  K2's tail row table (:func:`tail_row_table`):
    ``tail_row_ids`` and ``tail_ptr``, and ``tail_long``, the table
    positions of the rows longer than ``LONG_TAIL_ROW``."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    shape: Tuple[int, int]
    cap: int
    block_rows: torch.Tensor
    block_ptr: torch.Tensor
    tail_row_ids: torch.Tensor
    tail_ptr: torch.Tensor
    tail_long: torch.Tensor
    # expanded row ids of the capped part and of the tail, for the plain
    # versions
    _rows: torch.Tensor = dataclasses.field(default=None, repr=False)
    _tail_rows: torch.Tensor = dataclasses.field(default=None, repr=False)

    @staticmethod
    def from_csr(csr, device, dtype=torch.float64, cap: int = DEFAULT_CAP):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        (ip, ix, v), (_, tc, tv) = split_capped(
            csr.indptr, csr.indices, csr.data, cap
        )
        row_ids, ptr = tail_row_table(csr.indptr, cap)
        long_rows = np.flatnonzero(np.diff(ptr) > LONG_TAIL_ROW)
        return CappedCSR(
            indptr=to_device(ip, device, torch.int64),
            indices=to_device(ix, device, torch.int32),
            data=to_device(v, device, dtype),
            tail_cols=to_device(tc, device, torch.int32),
            tail_vals=to_device(tv, device, dtype),
            shape=tuple(csr.shape),
            cap=cap,
            **block_table(ip, device),
            tail_row_ids=to_device(row_ids, device, torch.int32),
            tail_ptr=to_device(ptr, device, torch.int32),
            tail_long=to_device(long_rows, device, torch.int32),
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

    @property
    def n_blocks(self) -> int:
        return self.block_rows.numel() - 1

    @property
    def n_tail_rows(self) -> int:
        return self.tail_row_ids.numel()

    def rows(self) -> torch.Tensor:
        if self._rows is None:
            counts = self.indptr[1:] - self.indptr[:-1]
            self._rows = torch.repeat_interleave(
                torch.arange(self.shape[0], device=self.device), counts
            )
        return self._rows

    def tail_rows(self) -> torch.Tensor:
        """The row of every tail entry (int64), from the tail row table."""
        if self._tail_rows is None:
            self._tail_rows = torch.repeat_interleave(
                self.tail_row_ids.long(),
                (self.tail_ptr[1:] - self.tail_ptr[:-1]).long())
        return self._tail_rows

    def to_csr(self):
        """The matrix on the host, capped part and tail together."""
        from tpu_amg_torch.sparse.csr import CSR

        def host(*ts):
            return [t.cpu().numpy() for t in ts]

        rows, cols, vals = host(self.rows(), self.indices, self.data)
        t_rows, t_cols, t_vals = host(self.tail_rows(), self.tail_cols,
                                      self.tail_vals)
        return CSR.from_coo(
            np.concatenate([rows, t_rows]), np.concatenate([cols, t_cols]),
            np.concatenate([vals, t_vals]), self.shape,
        )


def k1_bytes(mat: CappedCSR, k: int = 1) -> int:
    """The bytes K1 must move at k columns, each once: capped values and
    indices, int64 row pointers, X (m, k) and Y (n, k)."""
    isz = mat.data.element_size()
    n, m = mat.shape
    return mat.data.numel() * (isz + 4) + 8 * (n + 1) + (m + n) * k * isz


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


def check_row_block_kernel(mat: CappedCSR, k: int = 1) -> None:
    """The checks the row-block kernels' 32-bit offsets and the SpMM's
    16-byte copies need."""
    if max(mat.data.numel(), max(mat.shape) * k) > _INT32_MAX:
        raise ValueError(f"A {mat.shape} with {mat.data.numel()} entries "
                         f"at k = {k} passes 32-bit offsets")
    if mat.indices.data_ptr() % 16 or mat.data.data_ptr() % 16:
        raise ValueError("indices and values must be 16-byte aligned")


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
        0, mat.tail_rows(), mat.tail_vals[:, None] * x2[mat.tail_cols.long()]
    )


def launch_csr_spmv_capped(fn, mat: CappedCSR, x: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Launch ``fn``, a ``csr_spmv_capped_*`` entry point of a kernel
    library, on CUDA tensors; counts nothing."""
    check_row_block_kernel(mat, k)
    y = torch.empty((mat.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if mat.shape[0] == 0:
        return y
    with torch.cuda.device(x.device):
        code = fn(
            mat.n_blocks, k, mat.block_rows.data_ptr(),
            mat.block_ptr.data_ptr(), mat.indptr.data_ptr(),
            mat.indices.data_ptr(), mat.data.data_ptr(), x.data_ptr(),
            y.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "csr_spmv_capped")
    return y


def csr_spmv_capped(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """K1: Y = A_cap X (the first ``mat.cap`` entries of every row)."""
    global csr_spmv_launches
    k = check_x(mat, x)
    if x.device.type == "cpu":
        return plain_csr_spmv_capped(mat, x)
    y = launch_csr_spmv_capped(_kernel("csr_spmv_capped", x), mat, x, k)
    if mat.shape[0]:
        csr_spmv_launches += 1
        csr_spmv_launches_by_shape[(*mat.shape, k)] += 1
    return y


def launch_coo_patch(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor,
                     k: int, lanes: int) -> None:
    """Launch K2 on CUDA tensors (x checked, a tail present) with teams
    of ``lanes`` lanes a tail row: 8, 16 or 32, and no fewer than the
    group width (the power of two at or above k, at most 32).  Counts
    nothing."""
    fn = _kernel("coo_patch", x)
    if max(mat.shape) * k > _INT32_MAX:
        raise ValueError(f"A {mat.shape} at k = {k} passes 32-bit offsets")
    with torch.cuda.device(x.device):
        code = fn(
            mat.n_tail_rows, mat.tail_long.numel(), k, lanes,
            mat.tail_row_ids.data_ptr(), mat.tail_ptr.data_ptr(),
            mat.tail_long.data_ptr(), mat.tail_cols.data_ptr(),
            mat.tail_vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "coo_patch")


def coo_patch(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor) -> None:
    """K2: y[r] += Σ v · x[c] over the tail entries of each row r, in
    place."""
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
    launch_coo_patch(mat, x, y, k,
                     k2_lanes(mat.n_tail_rows, k, sm_count(x.device.index)))
    coo_patch_launches += 1
    coo_patch_launches_by_shape[(*mat.shape, k)] += 1


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
