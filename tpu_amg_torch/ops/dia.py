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
- It is bound by bytes: values + x + y, with no index stream.  CUDA C++
  in ``tpu_amg_torch/csrc/dia.cu``, three designs in one library, two of
  them routed, by k alone:
  - k < ``TILED_MIN_K`` = 8: the row-chunk design.  A thread owns R
    consecutive rows (1 or 2 at k = 1) and all k columns, so each value
    is read once, or one column of a row where an X row is wide and the
    stencil short; the diagonals go in chunks of U, all of a chunk's
    loads issued before its fused multiply-adds, x read at a clamped
    row and an out-of-range product dropped by a select.
    :func:`row_plan`, a pure function of the shapes, dtypes, the SM
    count and the data's alignment, picks R, the columns and the block;
    the offsets ride in the launch by value;
  - k >= 8: the band-tile design.  :func:`dia_plan`, a pure function of
    the offsets and shapes, cuts the rows into tiles of T and the sorted
    offsets into bands; a block stages each band's X window (rows
    [i0 + lo, i0 + T + hi) clipped to [0, n)) and data rows in shared
    memory once, double-buffered, and every lane sums its outputs from
    there.  The plan passes to the kernel by value, so a CUDA graph
    captures it with the launch and the matrix holds nothing more;
  - the first design, one thread per (row, column) walking the
    diagonals from a device table of offsets, is routed nowhere: it is
    the reference of the other two on the card.
  All three sum each output in one accumulator, diagonal by diagonal in
  offset order with one fused multiply-add each, and skip the same
  reads: they give the same bits.  Each stays callable at any k it
  takes, uncounted (:func:`launch_first_design`,
  :func:`launch_row_design`, :func:`launch_band_tiles`).

The diagonals (``data``) are of a type V no wider than T, the type of
X and Y: the pairs of :data:`tpu_amg_torch.ops.spmv.PAIRS`, (f64, f64),
(f32, f32), (f32, f64), (bf16, f32) and (bf16, f64); any other pair
raises.  Every design widens each value exactly to T and sums in T; the
band tiles stage data rows in V and the X window in T
(:func:`dia_plan` sizes each by its own itemsize).  Y is T.  That
follows the XLA apply the JAX package runs on the CPU
(``tpu_amg/sparse/dia.py:89``, ``jnp.result_type`` of the two), which
the tests hold the port against; the reference's Pallas kernel instead
writes Y in the data's dtype (``tpu_amg/ops/dia_pallas.py:92``), so on
a TPU a bf16 DIA rounds Y to bf16.

The plain PyTorch version beside it is the JAX package's form: one
multiply-accumulate per diagonal over shifted slices, the values
widened to T first.  The wrapper takes it only when its tensors lie on
the CPU; for a CUDA tensor it launches the kernel or raises.  Launches
are counted in ``dia_spmv_launches``, by (rows, cols, k) in
``dia_spmv_launches_by_shape``, by (V, T) in
``dia_spmv_launches_by_dtype`` and by both, (rows, cols, k, V, T), in
``dia_spmv_launches_by_shape_dtype``.

The kernels are compiled with nvcc for ``sm_90a`` into
``build/tpu_amg_torch/libamg_dia.so`` at first launch and loaded with
ctypes.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Tuple

import torch

from tpu_amg_torch.ops._build import build_cuda_library
from tpu_amg_torch.ops.spmv import PAIRS, check_x, pair_suffix

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dia.cu"

# The band-tile design's limits, compiled into the library (csrc/dia.cu
# kMaxDiags, kMaxRowsPerThread, kMaxThreads) and checked when it loads;
# MAX_DIAGS bounds the row-chunk design's table too.
MAX_DIAGS = 160  # the structured builder's DIA envelope (structured.py)
BLOCK_THREADS = (256, 128, 64, 32)
ROWS_PER_THREAD = (4, 2, 1)
MAX_LANES = 32  # lanes a row: a warp at most
TILE_CAP = 128  # rows a block at most
MIN_BLOCKS_PER_SM = 2  # the grid the plan aims for, where n allows
# the wrapper runs the band tiles from this k up, the row-chunk design below
TILED_MIN_K = 8
# The row-chunk design (csrc/dia.cu kRowMaxK, kRowLoads, kRowMaxChunk;
# its instances checked when the library loads): k up to ROW_MAX_K, at
# most ROW_LOADS loads a thread in flight, at most ROW_MAX_CHUNK
# diagonals a chunk, blocks of ROW_THREADS
ROW_MAX_K = 7
ROW_LOADS = 32
ROW_MAX_CHUNK = 16
ROW_THREADS = (256, 128, 64)
# the plan's R: a diagonal's R values fill at most this many bytes; its
# columns a thread: one where an X row passes ROW_X_BYTES and the
# stencil has at most ROW_SHORT_DIAGS diagonals
ROW_VALUE_BYTES = 8
ROW_X_BYTES = 32
ROW_SHORT_DIAGS = 8
# shared memory of one buffer (the kernel keeps two): a band's X window,
# and its data rows
X_BUDGET = 40 * 1024
DATA_BUDGET = 8 * 1024

dia_spmv_launches = 0
dia_spmv_launches_by_shape = collections.Counter()
dia_spmv_launches_by_dtype = collections.Counter()  # (V, T) -> launches
dia_spmv_launches_by_shape_dtype = collections.Counter()  # (r, c, k, V, T)


def reset_launch_counts() -> None:
    global dia_spmv_launches
    dia_spmv_launches = 0
    dia_spmv_launches_by_shape.clear()
    dia_spmv_launches_by_dtype.clear()
    dia_spmv_launches_by_shape_dtype.clear()


class _PlanStruct(ctypes.Structure):
    """``Plan`` of csrc/dia.cu, field for field."""

    _fields_ = [("n_bands", ctypes.c_int), ("tile", ctypes.c_int),
                ("lanes_log2", ctypes.c_int), ("rows_per_thread", ctypes.c_int),
                ("xs_cap", ctypes.c_int), ("ds_cap", ctypes.c_int),
                ("offsets", ctypes.c_int * MAX_DIAGS),
                ("band_start", ctypes.c_int * (MAX_DIAGS + 1))]


class _RowStruct(ctypes.Structure):
    """``RowPlan`` of csrc/dia.cu, field for field."""

    _fields_ = [("n_diags", ctypes.c_int),
                ("offsets", ctypes.c_int * MAX_DIAGS)]


def row_shapes(k: int) -> Tuple[Tuple[int, int], ...]:
    """The (rows, columns) a thread may own at k, the row kernel's
    instances: at k = 1 two rows or one; above, one row and all k
    columns or one column."""
    return ((2, 1), (1, 1)) if k == 1 else ((1, k), (1, 1))


def row_chunk(cols: int, rows_per_thread: int) -> int:
    """Diagonals a chunk of the row kernel (csrc/dia.cu ``row_chunk``):
    the largest power of two that keeps at most ``ROW_LOADS`` loads in
    flight a thread (R values and R·C X elements a diagonal), 1 to
    ``ROW_MAX_CHUNK``."""
    u = 1
    while (2 * u <= ROW_MAX_CHUNK
           and 2 * u * rows_per_thread * (cols + 1) <= ROW_LOADS):
        u *= 2
    return u


def row_chunks(n_diags: int, chunk: int) -> Tuple[int, ...]:
    """The sizes of the row kernel's chunks, in order: full chunks of
    ``chunk`` diagonals, then of chunk / 2, ..., 1, each at most once,
    for the rest (the kernel's ``row_tail_sum``)."""
    sizes = [chunk] * (n_diags // chunk)
    rest, u = n_diags % chunk, chunk // 2
    while u:
        if rest >= u:
            sizes.append(u)
            rest -= u
        u //= 2
    return tuple(sizes)


def _check_design(dll: ctypes.CDLL) -> None:
    """Raise unless the library's plan layouts, limits and row-kernel
    instances are this module's."""
    built = {}
    for name in ("dia_plan_bytes", "dia_max_diags", "dia_max_rows_per_thread",
                 "dia_max_threads", "dia_row_plan_bytes"):
        fn = getattr(dll, name)
        fn.restype = ctypes.c_int
        built[name] = fn()
    dll.dia_row_chunk.restype = ctypes.c_int
    dll.dia_row_chunk.argtypes = [ctypes.c_int] * 3
    shapes = [(k, r, c) for k in range(1, ROW_MAX_K + 2) for r in (1, 2)
              for c in range(1, ROW_MAX_K + 2)]
    built["dia_row_chunk"] = {s: dll.dia_row_chunk(*s) for s in shapes}
    want = {"dia_plan_bytes": ctypes.sizeof(_PlanStruct),
            "dia_max_diags": MAX_DIAGS,
            "dia_max_rows_per_thread": max(ROWS_PER_THREAD),
            "dia_max_threads": max(BLOCK_THREADS),
            "dia_row_plan_bytes": ctypes.sizeof(_RowStruct),
            "dia_row_chunk": {
                (k, r, c): row_chunk(c, r) if k <= ROW_MAX_K
                and (r, c) in row_shapes(k) else 0 for k, r, c in shapes}}
    if built != want:
        raise RuntimeError(f"{dll._name} is built for {built}, the host "
                           f"plans for {want}")


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The K3 library, compiled with nvcc on first call; the tiled
    kernels are let take the card's largest dynamic shared memory."""
    dll = ctypes.CDLL(str(build_cuda_library("libamg_dia.so", SOURCE)))
    _check_design(dll)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in PAIRS.values():
        fn = getattr(dll, f"dia_spmv_first_{suffix}")
        fn.restype = i32
        fn.argtypes = [i64, i32, i32, vp, vp, vp, vp, vp]
        fn = getattr(dll, f"dia_spmv_row_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp]
        fn = getattr(dll, f"dia_spmv_tiled_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp]
    dll.dia_error_string.restype = ctypes.c_char_p
    dll.dia_error_string.argtypes = [i32]
    dll.dia_allow_smem.restype = i32
    _raise_on(dll, dll.dia_allow_smem(), "dia_allow_smem")
    return dll


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """The band-tile kernel's launch for one (offsets, n, k, dtype,
    value dtype).

    Block b owns rows [b·tile, (b + 1)·tile) ∩ [0, n) and all k columns.
    Its ``threads`` are ``threads / lanes`` row slots of ``lanes`` lanes:
    slot s holds rows s + j·(threads / lanes), j < ``rows_per_thread``;
    lane l holds columns (l + g·lanes)·vector + [0, vector), g <
    ``groups``, those under k.  ``bands`` are the diagonals [d0, d1) of
    each band, in offset order; for a block's rows [i0, i0 + rows) a
    band's X window is rows [i0 + lo, i0 + rows + hi) ∩ [0, n), lo and
    hi its first and last offsets.  A buffer holds ``xs_cap`` elements
    of window (``itemsize`` bytes each, X's) and ``ds_cap`` of data rows
    (``value_itemsize`` bytes each), a band's row every ``data_stride``
    elements; ``smem_bytes`` is one buffer for one band, else two."""

    n: int
    k: int
    itemsize: int
    value_itemsize: int
    data_stride: int
    offsets: Tuple[int, ...]
    vector: int
    lanes: int
    groups: int
    threads: int
    rows_per_thread: int
    tile: int
    blocks: int
    bands: Tuple[Tuple[int, int], ...]
    xs_cap: int
    ds_cap: int
    smem_bytes: int


def _tile_ladder(lanes: int):
    """(tile, threads, rows_per_thread) for every tile up to TILE_CAP at
    ``lanes`` lanes a row, largest first, each with the most threads."""
    shapes = {}
    for threads in BLOCK_THREADS:
        for rpt in ROWS_PER_THREAD:
            tile = threads // lanes * rpt
            if tile <= TILE_CAP:
                shapes.setdefault(tile, (threads, rpt))
    return [(t, *shapes[t]) for t in sorted(shapes, reverse=True)]


def data_stride(tile: int, value_itemsize: int) -> int:
    """A data row's slot in a band-tile buffer, in elements (csrc/dia.cu
    ``data_stride``): the tile, or for 2-byte values an even number with
    room for the row's phase against 4 bytes (the kernel stages 2-byte
    rows in 4-byte copies)."""
    return (tile + 3) & ~1 if value_itemsize == 2 else tile


@functools.lru_cache(maxsize=None)
def dia_plan(offsets: Tuple[int, ...], n: int, k: int, dtype: torch.dtype,
             sm_count: int, aligned: bool = True,
             value_dtype: torch.dtype = None) -> DiaPlan:
    """The band-tile kernel's plan: a pure function of the sorted
    ``offsets``, n, k, X's type ``dtype``, the card's SM count, whether
    X's base address is 16-byte aligned, and the data's type
    ``value_dtype`` (``dtype`` when None).

    - Lanes read 16 bytes of a row at once where X is aligned and k a
      multiple of that vector, else one element; a row takes the fewest
      lanes (a power of two, at most a warp) that cover it in at most two
      passes.
    - The tile T is the largest of the ladder (threads 256 down to 32, 4,
      2 or 1 rows a thread, T ≤ 128) that gives ``MIN_BLOCKS_PER_SM``
      blocks an SM, else the smallest, 32 / lanes rows: every n from
      2·SMs·T_min rows up gets two blocks an SM without a column split.
    - Bands: the offsets in order, a run broken where the gap to the
      next offset exceeds T (staging the gap's rows then costs more than
      a band's own window) or where the band's window or data rows would
      pass their budget (``X_BUDGET``, ``DATA_BUDGET`` bytes a buffer),
      the window by X's itemsize, the data rows by the values'."""
    offsets = tuple(int(o) for o in offsets)
    if any(b <= a for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"offsets {offsets} are not strictly increasing")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{len(offsets)} diagonals; the band-tile kernel "
                         f"takes up to {MAX_DIAGS}")
    if not 1 <= k <= 64 or not 1 <= n < 2**30:
        raise ValueError(f"n = {n}, k = {k}: the band-tile kernel takes "
                         f"1 <= n < 2**30 (32-bit rows) and 1 <= k <= 64")
    itemsize = torch.empty((), dtype=dtype).element_size()
    v_isz = torch.empty((), dtype=value_dtype or dtype).element_size()
    vec = 16 // itemsize
    vector = vec if aligned and k % vec == 0 else 1
    pieces = -(-k // vector)
    lanes = min(MAX_LANES, 1 << (pieces - 1).bit_length())
    groups = -(-pieces // lanes)
    ladder = _tile_ladder(lanes)
    tile, threads, rpt = ladder[-1]
    for cand in ladder:
        if -(-n // cand[0]) >= MIN_BLOCKS_PER_SM * sm_count:
            tile, threads, rpt = cand
            break

    stride = data_stride(tile, v_isz)

    def rounded(elems: int, isz: int = itemsize) -> int:  # 16-byte places
        per = 16 // isz
        return -(-elems // per) * per

    def x_elems(span: int) -> int:  # a window's elements, with its phase
        return rounded(min(tile + span, n) * k + vec)

    def fits(span: int, n_diags: int) -> bool:
        return (x_elems(span) * itemsize <= X_BUDGET
                and n_diags * stride * v_isz <= DATA_BUDGET)

    bands, start = [], 0
    for d in range(1, len(offsets)):
        if not (offsets[d] - offsets[d - 1] <= tile
                and fits(offsets[d] - offsets[start], d - start + 1)):
            bands.append((start, d))
            start = d
    if offsets:
        bands.append((start, len(offsets)))
    xs_cap = max((x_elems(offsets[d1 - 1] - offsets[d0]) for d0, d1 in bands),
                 default=0)
    ds_cap = rounded(max(((d1 - d0) * stride for d0, d1 in bands),
                         default=0), v_isz)
    buffers = 2 if len(bands) > 1 else 1
    return DiaPlan(n=n, k=k, itemsize=itemsize, value_itemsize=v_isz,
                   data_stride=stride, offsets=offsets,
                   vector=vector, lanes=lanes, groups=groups, threads=threads,
                   rows_per_thread=rpt, tile=tile, blocks=-(-n // tile),
                   bands=tuple(bands), xs_cap=xs_cap, ds_cap=ds_cap,
                   smem_bytes=buffers * (xs_cap * itemsize
                                         + ds_cap * v_isz))


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """The row-chunk kernel's launch for one (n, diagonals, k).

    Thread t of the grid (``blocks`` blocks of ``threads``) owns, at
    ``cols`` = k, rows [t·R, t·R + R) ∩ [0, n), R = ``rows_per_thread``,
    and all k columns of each; at ``cols`` = 1 < k, row t / k and column
    t % k.  It walks the diagonals in chunks of ``chunk``, the rest in
    smaller ones (:func:`row_chunks`)."""

    n: int
    n_diags: int
    k: int
    rows_per_thread: int
    cols: int
    threads: int
    blocks: int
    chunk: int


@functools.lru_cache(maxsize=None)
def row_plan(n: int, n_diags: int, k: int, dtype: torch.dtype,
             sm_count: int, aligned: bool = True,
             value_dtype: torch.dtype = None) -> RowPlan:
    """The row-chunk kernel's plan: a pure function of n, the number of
    diagonals, k, X's type ``dtype``, the card's SM count, whether the
    data's base address is 16-byte aligned, and the values' type
    ``value_dtype`` (``dtype`` when None).

    Of :func:`row_plans`, those whose R values fill at most
    ``ROW_VALUE_BYTES``; at k > 1, one column a thread where an X row
    passes ``ROW_X_BYTES`` and the stencil is short (at most
    ``ROW_SHORT_DIAGS`` diagonals: the classical path's 5-point fine A
    at k = 5), else all k columns (a warp's X loads then stride a whole
    row, and with few diagonals a thread has too few of them to hide
    that; one column a thread reads X rows whole, with k times the
    threads).  Of those, the first that gives ``MIN_BLOCKS_PER_SM``
    blocks an SM, else the last."""
    isz = torch.empty((), dtype=value_dtype or dtype).element_size()
    plans = [p for p in row_plans(n, n_diags, k, aligned)
             if p.rows_per_thread * isz <= ROW_VALUE_BYTES
             or p.rows_per_thread == 1]
    if k > 1:
        one = (k * torch.empty((), dtype=dtype).element_size() > ROW_X_BYTES
               and n_diags <= ROW_SHORT_DIAGS)
        plans = [p for p in plans if (p.cols == 1) == one] or plans
    return next((p for p in plans
                 if p.blocks >= MIN_BLOCKS_PER_SM * sm_count), plans[-1])


@functools.lru_cache(maxsize=None)
def row_plans(n: int, n_diags: int, k: int, aligned: bool = True
              ) -> Tuple[RowPlan, ...]:
    """Every launch the row-chunk kernel can take for (n, n_diags, k) and
    the data's alignment: R > 1 only where a diagonal's R values are one
    aligned vector load (n a multiple of R, the data 16-byte aligned), a
    column a thread only where n·k < 2**31 (32-bit thread ids).  Those of
    all k columns a thread first, then those of one; in each, the most
    outputs a block first, the more threads first at equal outputs.
    :func:`row_plan` picks one; the card tests hold each to the first
    design's bits."""
    if n_diags > MAX_DIAGS:
        raise ValueError(f"{n_diags} diagonals; the row-chunk kernel takes "
                         f"up to {MAX_DIAGS}")
    if not 1 <= k <= ROW_MAX_K or not 1 <= n < 2**30:
        raise ValueError(f"n = {n}, k = {k}: the row-chunk kernel takes "
                         f"1 <= n < 2**30 (32-bit rows) and 1 <= k <= "
                         f"{ROW_MAX_K}")
    shapes = [(r, c) for r, c in row_shapes(k)
              if (r == 1 or (aligned and n % r == 0))
              and (c == k or n * k < 2**31)]
    launches = sorted(((r, c, t) for r, c in shapes for t in ROW_THREADS),
                      key=lambda s: (s[1] != k, -s[0] * s[1] * s[2], -s[2]))
    return tuple(RowPlan(n=n, n_diags=n_diags, k=k, rows_per_thread=r,
                         cols=c, threads=t, blocks=-(-n * k // (t * r * c)),
                         chunk=row_chunk(c, r)) for r, c, t in launches)


@functools.lru_cache(maxsize=None)
def _row_struct(offsets: Tuple[int, ...]) -> _RowStruct:
    s = _RowStruct(n_diags=len(offsets))
    s.offsets[:len(offsets)] = offsets
    return s


@functools.lru_cache(maxsize=None)
def _plan_struct(plan: DiaPlan) -> _PlanStruct:
    s = _PlanStruct(n_bands=len(plan.bands), tile=plan.tile,
                    lanes_log2=plan.lanes.bit_length() - 1,
                    rows_per_thread=plan.rows_per_thread,
                    xs_cap=plan.xs_cap, ds_cap=plan.ds_cap)
    s.offsets[:len(plan.offsets)] = plan.offsets
    starts = [d0 for d0, _ in plan.bands] + [len(plan.offsets)]
    s.band_start[:len(starts)] = starts
    return s


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_plan_for(mat, x: torch.Tensor) -> RowPlan:
    """The row-chunk plan of ``mat`` for this X on its card."""
    return row_plan(mat.shape[0], len(mat.offsets),
                    1 if x.dim() == 1 else x.shape[1], x.dtype,
                    _sms(x.device.index), mat.data.data_ptr() % 16 == 0,
                    None if mat.dtype == x.dtype else mat.dtype)


def plan_for(mat, x: torch.Tensor) -> DiaPlan:
    """The band-tile plan of ``mat`` for this X on its card."""
    k = 1 if x.dim() == 1 else x.shape[1]
    return dia_plan(mat.offsets, mat.shape[0], k, x.dtype,
                    _sms(x.device.index), x.data_ptr() % 16 == 0,
                    None if mat.dtype == x.dtype else mat.dtype)


def plain_dia_spmv(mat, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (same contract, any device): the JAX
    ``DIA.mv``/``mm`` sum, diagonal by diagonal in offset order, each
    over the rows whose shifted column lies inside the matrix, the
    values widened to x's dtype first."""
    n = mat.shape[0]
    x2 = x.reshape(n, -1)
    data = mat.data.to(x.dtype)
    acc = torch.zeros_like(x2)
    for d, off in enumerate(mat.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            acc[lo:hi] += data[d, lo:hi, None] * x2[lo + off:hi + off]
    return acc.reshape(x.shape)


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.dia_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _on_card(mat, x: torch.Tensor) -> int:
    """Validate x for a launch on the card; returns k."""
    k = check_x(mat, x)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {x.device}")
    if mat.data.data_ptr() % 4:
        raise ValueError("the diagonals must be 4-byte aligned")
    return k


def _first(lib, mat, x, y, k) -> int:
    return getattr(lib, f"dia_spmv_first_{pair_suffix(mat.dtype, x.dtype)}")(
        mat.shape[0], len(mat.offsets), k, mat.offsets_dev.data_ptr(),
        mat.data.data_ptr(), x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream().cuda_stream)


def _row(lib, mat, x, y, k, plan=None) -> int:
    plan = plan or row_plan_for(mat, x)
    return getattr(lib, f"dia_spmv_row_{pair_suffix(mat.dtype, x.dtype)}")(
        plan.n, k, plan.rows_per_thread, plan.cols, plan.threads, plan.blocks,
        ctypes.addressof(_row_struct(mat.offsets)), mat.data.data_ptr(),
        x.data_ptr(), y.data_ptr(), torch.cuda.current_stream().cuda_stream)


def _tiled(lib, mat, x, y, k) -> int:
    plan = plan_for(mat, x)
    return getattr(lib, f"dia_spmv_tiled_{pair_suffix(mat.dtype, x.dtype)}")(
        plan.n, k, plan.vector, plan.threads, plan.blocks, plan.smem_bytes,
        ctypes.addressof(_plan_struct(plan)), mat.data.data_ptr(),
        x.data_ptr(), y.data_ptr(), torch.cuda.current_stream().cuda_stream)


def _launch(design, mat, x: torch.Tensor, k: int, what: str):
    """(Y, whether a kernel ran): ``design`` on the card, nothing for a
    matrix of no rows."""
    lib = kernel_lib()
    y = torch.empty_like(x)
    if mat.shape[0] == 0:
        return y, False
    with torch.cuda.device(x.device):
        _raise_on(lib, design(lib, mat, x, y, k), what)
    return y, True


def launch_first_design(mat, x: torch.Tensor) -> torch.Tensor:
    """K3's first design at any k, uncounted: the routed designs'
    reference on the card (the same bits)."""
    return _launch(_first, mat, x, _on_card(mat, x),
                   "dia_spmv (first design)")[0]


def launch_row_design(mat, x: torch.Tensor, plan: RowPlan = None
                      ) -> torch.Tensor:
    """K3's row-chunk design at any k up to ``ROW_MAX_K``, uncounted, on
    its own plan or on ``plan``, another launch of :func:`row_plans` (a
    sweep): the wrapper routes every k < ``TILED_MIN_K`` to it."""
    if plan is not None and plan not in row_plans(
            mat.shape[0], len(mat.offsets), 1 if x.dim() == 1 else x.shape[1],
            mat.data.data_ptr() % 16 == 0):
        raise ValueError(f"{plan} is no row-chunk plan of this matrix and X")
    return _launch(functools.partial(_row, plan=plan), mat, x,
                   _on_card(mat, x), "dia_spmv (row-chunk design)")[0]


def launch_band_tiles(mat, x: torch.Tensor) -> torch.Tensor:
    """K3's band-tile design at any k, uncounted: the wrapper routes only
    k >= ``TILED_MIN_K`` to it."""
    return _launch(_tiled, mat, x, _on_card(mat, x),
                   "dia_spmv (band tiles)")[0]


def dia_spmv(mat, x: torch.Tensor) -> torch.Tensor:
    """K3: y = A x (or Y = A X) for a DIA matrix: the row-chunk design
    below k = ``TILED_MIN_K``, the band-tile design from it up."""
    global dia_spmv_launches
    if x.device.type == "cpu":
        check_x(mat, x)
        return plain_dia_spmv(mat, x)
    k = _on_card(mat, x)
    design = _row if k < TILED_MIN_K else _tiled
    y, launched = _launch(design, mat, x, k, "dia_spmv")
    if launched:
        dia_spmv_launches += 1
        dia_spmv_launches_by_shape[(*mat.shape, k)] += 1
        dia_spmv_launches_by_dtype[(mat.dtype, x.dtype)] += 1
        dia_spmv_launches_by_shape_dtype[(*mat.shape, k, mat.dtype,
                                          x.dtype)] += 1
    return y
