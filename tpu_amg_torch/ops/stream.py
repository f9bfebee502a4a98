"""Streaming-read bandwidth probe on the device: S1/S2 ``stream_sum``.

``stream_sum(inputs, carry)`` reads n_in arrays (float32 or int8) and
returns a (tiles, 8, 128) float32 array,

    out[t] = carry + Σ_i Σ_chunks float(block_i,t[chunk]),

where tile t's block of each input is cut into (8, 128) chunks.  Each
input is given as a (tiles, rows, width) view with a unit last stride;
two layouts of the JAX harness ``tools/streambench.py`` map onto it:

- ``run_case`` (:38): an array of shape (tiles, rows, 128), each
  tile's block stacked after the last, is the view itself;
- ``run_wide`` (:96): an array of shape (rows, tiles · width), each
  tile's block a column band of the rows, is seen through
  :func:`wide_layout`.

The TPU's ``run_wide`` writes every tile into one (8, 128) output block,
so that only the last tile survives; that is a Mosaic artefact, and
here every tile's sum is returned.

The kernel (CUDA C++ in ``tpu_amg_torch/csrc/stream.cu``) is bound by
bytes only.  One block of 512 threads runs on each SM, each thread
keeping 16 16-byte loads in flight across steps and tiles.
:func:`launch_plan` makes the grid from the SM count: with as many tiles
as SMs or more, persistent blocks walk the tiles; with fewer, a tile is
shared by ``parts`` = 2, 4 or 8 blocks, each owning 8 / parts rows of
its (8, 128) sum.  One launch a call, no atomics, no scratch, each
output written once, and the same bits on every call.  Its plain
PyTorch version beside it is ``reshape`` + ``sum``.  The wrapper takes the plain version only when its tensors lie
on the CPU; for a CUDA tensor it launches the kernel or raises.  Launches are counted in
``stream_sum_launches``.  The kernel is compiled with nvcc for
``sm_90a`` into ``build/tpu_amg_torch/libamg_stream.so`` at first
launch and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence, Tuple

import torch

from tpu_amg_torch.ops._build import build_cuda_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "stream.cu"
MAX_INPUTS = 8
THREADS = 512  # a block (kThreads in stream.cu)
UNROLL = 8  # 16-byte loads a thread issues a step (kUnroll)
MAX_PARTS = 8  # blocks a tile: one row of the (8, 128) sum each

stream_sum_launches = 0


def reset_launch_counts() -> None:
    global stream_sum_launches
    stream_sum_launches = 0


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The stream-probe library, compiled with nvcc on first call."""
    dll = ctypes.CDLL(str(build_cuda_library("libamg_stream.so", SOURCE)))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in ("f32", "i8"):
        fn = getattr(dll, f"stream_sum_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, ctypes.POINTER(vp), i64, i64, i64, i64, i64, i32,
                       i32, vp, vp, vp]
    dll.stream_error_string.restype = ctypes.c_char_p
    dll.stream_error_string.argtypes = [i32]
    return dll


_SUFFIX = {torch.float32: "f32", torch.int8: "i8"}


def step_chunks(element_size: int, parts: int = 1) -> int:
    """Chunks a block's step of loads spans: a thread's slot is 16 bytes
    of a block's rows of an (8, 128) chunk, which take 256 / parts
    (float32) or 64 / parts (int8) threads."""
    return THREADS * parts // (64 * element_size)


def launch_plan(tiles: int, rows: int, width: int, element_size: int,
                n_in: int, sms: int) -> Tuple[int, int]:
    """The kernel's grid (``parts``, ``blocks``) for ``tiles`` (≥ 1)
    blocks of (rows, width) values of ``element_size`` bytes in each of
    ``n_in`` inputs, on a card of ``sms`` SMs: a pure function of these.
    Block (p, b) owns rows [8 p / parts, 8 (p + 1) / parts) of the sums
    of tiles b, b + blocks, ...  With as many tiles as
    SMs or more, one persistent block an SM; with fewer, the most parts
    (a power of two up to ``MAX_PARTS``) that keep the grid within one
    block an SM and give every block a full step of loads (``UNROLL``
    items a thread)."""
    if tiles >= sms:
        return 1, sms
    items = n_in * (rows // 8) * (width // 128)
    parts = 1
    while (2 * parts <= MAX_PARTS and 2 * parts * tiles <= sms
           and items >= UNROLL * step_chunks(element_size, 2 * parts)):
        parts *= 2
    return parts, tiles


def wide_layout(arr: torch.Tensor, width: int) -> torch.Tensor:
    """``run_wide``'s layout: arr (rows, tiles · width) seen as
    (tiles, rows, width)."""
    rows, total = arr.shape
    return arr.view(rows, total // width, width).transpose(0, 1)


def _check(inputs: Sequence[torch.Tensor], carry: torch.Tensor):
    if not 1 <= len(inputs) <= MAX_INPUTS:
        raise ValueError(f"{len(inputs)} inputs; the probe takes 1..{MAX_INPUTS}")
    x0 = inputs[0]
    if x0.dim() != 3:
        raise ValueError(f"inputs must be (tiles, rows, width) views, got "
                         f"{tuple(x0.shape)}")
    tiles, rows, width = x0.shape
    if rows % 8 or width % 128 or x0.stride(2) != 1:
        raise ValueError(f"blocks of ({rows}, {width}) with stride "
                         f"{x0.stride()}: need rows % 8 == 0, width % 128 == 0 "
                         f"and a unit last stride")
    for x in inputs:
        if (x.shape != x0.shape or x.stride() != x0.stride()
                or x.dtype != x0.dtype or x.device != x0.device):
            raise ValueError("inputs differ in shape, strides, dtype or device")
    if x0.dtype not in _SUFFIX:
        raise TypeError(f"no probe for {x0.dtype} (float32 or int8)")
    if (carry.shape != (8, 128) or carry.dtype != torch.float32
            or carry.device != x0.device):
        raise ValueError("carry must be an (8, 128) float32 tensor on the "
                         "inputs' device")
    return tiles, rows, width


def plain_stream_sum(inputs: Sequence[torch.Tensor],
                     carry: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the probe (same contract, any device)."""
    tiles, rows, width = inputs[0].shape
    out = carry.expand(tiles, 8, 128)
    for x in inputs:
        chunks = x.float().reshape(tiles, rows // 8, 8, width // 128, 128)
        out = out + chunks.sum(dim=(1, 3))
    return out


def stream_sum(inputs: Sequence[torch.Tensor],
               carry: torch.Tensor) -> torch.Tensor:
    """S1/S2: the per-tile (8, 128) sums of every input, plus ``carry``."""
    global stream_sum_launches
    tiles, rows, width = _check(inputs, carry)
    x0 = inputs[0]
    if x0.device.type == "cpu":
        return plain_stream_sum(inputs, carry)
    if x0.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {x0.device}")
    size = x0.element_size()
    if (x0.stride(0) * size % 16 or x0.stride(1) * size % 16
            or any(x.data_ptr() % 16 for x in inputs)):
        raise ValueError("the probe needs 16-byte aligned inputs and strides")
    if not carry.is_contiguous():
        raise ValueError("carry must be contiguous")
    lib = kernel_lib()
    out = torch.empty(tiles, 8, 128, dtype=torch.float32, device=x0.device)
    if tiles == 0:
        return out
    sms = torch.cuda.get_device_properties(x0.device).multi_processor_count
    parts, blocks = launch_plan(tiles, rows, width, size, len(inputs), sms)
    ptrs = (ctypes.c_void_p * len(inputs))(*(x.data_ptr() for x in inputs))
    with torch.cuda.device(x0.device):
        code = getattr(lib, f"stream_sum_{_SUFFIX[x0.dtype]}")(
            len(inputs), ptrs, tiles, rows, width, x0.stride(1), x0.stride(0),
            parts, blocks, carry.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        msg = lib.stream_error_string(code).decode()
        raise RuntimeError(f"stream_sum launch failed: CUDA error {code} ({msg})")
    stream_sum_launches += 1
    return out
