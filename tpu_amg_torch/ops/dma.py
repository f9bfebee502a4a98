"""Copy-engine probe on the device: KD ``dma_probe``.

``dma_probe(sources, carry, chunk_rows, touch_every=1, engine="bulk",
depth=4, unit=16384)`` copies every byte
of K float32 sources of shape (rows_total, 128) from device memory into
shared memory and returns the (8, 128) float32 result

    carry + Σ over touched chunks c of sources[0][c·R : c·R + 8, :],

R = ``chunk_rows``; chunk c is touched when c % ``touch_every`` == 0
(``touch_every=0`` touches nothing: the result is the carry).  The four
manual-DMA probes of the JAX package's ``tools/`` map onto it:

- D1 ``dmabench.py`` ``run_case.kernel`` (:39): a ring of ``depth``
  buffers of R rows; every chunk touched (the harness's ``touch``) or
  none (``touch_every=0``);
- D2 ``dmabench2.py::k_whole`` (:61): the whole 8 MB array on chip, R =
  512, every chunk touched: depth 1 with the unit set to a block's whole
  share (:func:`whole_share_unit`);
- D3 ``dmabench2.py::k_multi`` (:88): K = 4 sources, R = 2048, chunk i of
  every source in flight together, chunk i of source 0 touched: consecutive
  ring slots hold different sources;
- D4 ``dmabench2.py::k_same`` (:130): one source, K = 4 chunks in flight,
  the first of each K touched: ``touch_every=4``.

On the card (CUDA C++ in ``tpu_amg_torch/csrc/dma.cu``) one persistent
block per SM runs a ring of ``depth`` slots of ``unit`` bytes, depth ×
unit ≤ 227 KB, fed by the ``engine``: ``bulk`` (1-D TMA bulk copies
completing on an mbarrier per slot) or ``lsu`` (16-byte ``cp.async.cg``
per thread, one commit group per slot).  The unit is a tuning knob that
does not change the result; the TPU's chunks (64 KB-4 MB) do not fit an
SM, so the sweeps keep their meaning, bandwidth against bytes in flight
per SM, at smaller units.  The kernel writes carry + the blocks'
partials itself, with no launch before it: the last block of each
group of 12 to take the group's ticket sums the group's partials, and
the last of those the carry and the groups' sums (one integer atomic a
block a round, no float atomics).  The tickets are counters kept per
device, which the kernel leaves at 0: calls on one device run one at a
time (one stream).

The plain PyTorch version beside the kernel is a strided view and a
``sum``.  The wrapper takes it only when its tensors lie on the CPU; for
a CUDA tensor it launches the kernel (compiled with nvcc for ``sm_90a``
into ``build/tpu_amg_torch/libamg_dma.so`` at first launch) or raises.
Launches are counted in ``dma_probe_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import torch

from tpu_amg_torch.ops._build import build_cuda_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dma.cu"
ENGINES = ("bulk", "lsu")
DEPTHS = (1, 2, 4, 8, 16)
MAX_SOURCES = 8
HEAD_BYTES = 8 * 128 * 4  # the touched rows of a chunk: units are multiples
MAX_RING_BYTES = 227 * 1024 - 1024  # the block's shared memory, less barriers

GROUP = 12  # blocks a group of the ticket combine (the library's dma_group)
MAX_GROUPS = 64  # (dma_max_groups)

dma_probe_launches = 0
_tickets = {}  # device index -> 1 + MAX_GROUPS ticket counters at 0


def reset_launch_counts() -> None:
    global dma_probe_launches
    dma_probe_launches = 0


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The probe's library, compiled with nvcc on first call."""
    dll = ctypes.CDLL(str(build_cuda_library("libamg_dma.so", SOURCE)))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    dll.dma_probe.restype = i32
    dll.dma_probe.argtypes = [i32, i32, i32, ctypes.POINTER(vp), i64, i32, i64,
                              i64, i32, vp, vp, vp, vp, vp]
    dll.dma_error_string.restype = ctypes.c_char_p
    dll.dma_error_string.argtypes = [i32]
    check_groups(dll)
    return dll


def check_groups(dll) -> None:
    """Raise unless the library ``dll`` combines partials in groups of
    ``GROUP`` blocks, at most ``MAX_GROUPS``, for which the host
    allocates the partials and the tickets."""
    dll.dma_group.restype = dll.dma_max_groups.restype = ctypes.c_int
    built = (dll.dma_group(), dll.dma_max_groups())
    if built != (GROUP, MAX_GROUPS):
        raise RuntimeError(f"the library groups {built[0]} blocks, at most "
                           f"{built[1]} groups; the host allocates for "
                           f"{GROUP}, {MAX_GROUPS}")


def whole_share_unit(total_bytes: int, blocks: int) -> int:
    """D2's unit: one block's whole share of ``total_bytes``, rounded up
    to a multiple of 4 KB."""
    share = -(-total_bytes // blocks)
    return -(-share // HEAD_BYTES) * HEAD_BYTES


def _check(sources: Sequence[torch.Tensor], carry: torch.Tensor,
           chunk_rows: int, touch_every: int, engine: str, depth: int,
           unit: int) -> None:
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f"{len(sources)} sources; the probe takes "
                         f"1..{MAX_SOURCES}")
    s0 = sources[0]
    if s0.dim() != 2 or s0.shape[1] != 128 or s0.dtype != torch.float32:
        raise ValueError(f"sources must be (rows, 128) float32, got "
                         f"{tuple(s0.shape)} {s0.dtype}")
    for s in sources:
        if (s.shape != s0.shape or s.dtype != s0.dtype
                or s.device != s0.device or not s.is_contiguous()):
            raise ValueError("sources differ in shape, dtype or device, or "
                             "are not contiguous")
    if chunk_rows <= 0 or chunk_rows % 8 or s0.shape[0] % chunk_rows:
        raise ValueError(f"chunk_rows {chunk_rows}: must be a multiple of 8 "
                         f"that divides the {s0.shape[0]} rows")
    if touch_every < 0:
        raise ValueError(f"touch_every {touch_every} < 0")
    if engine not in ENGINES or depth not in DEPTHS:
        raise ValueError(f"engine {engine!r}, depth {depth}: engines "
                         f"{ENGINES}, depths {DEPTHS}")
    if unit <= 0 or unit % HEAD_BYTES or depth * unit > MAX_RING_BYTES:
        raise ValueError(f"unit {unit} B at depth {depth}: units are "
                         f"multiples of {HEAD_BYTES} B, depth x unit <= "
                         f"{MAX_RING_BYTES} B")
    if (carry.shape != (8, 128) or carry.dtype != torch.float32
            or carry.device != s0.device or not carry.is_contiguous()):
        raise ValueError("carry must be a contiguous (8, 128) float32 "
                         "tensor on the sources' device")


def plain_dma_probe(sources: Sequence[torch.Tensor], carry: torch.Tensor,
                    chunk_rows: int, touch_every: int = 1) -> torch.Tensor:
    """Plain PyTorch version (same result, any device): a strided view of
    the touched chunk heads and a ``sum``."""
    if touch_every == 0:
        return carry.clone()
    s0 = sources[0]
    heads = s0.view(-1, chunk_rows, 128)[::touch_every, :8, :]
    return carry + heads.sum(0)


def _tickets_of(device: torch.device) -> torch.Tensor:
    """The device's ticket counters, made (at 0) on their first use,
    which must not be inside a CUDA graph's capture."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("call dma_probe once on the device before "
                               "capturing it in a CUDA graph")
        _tickets[index] = torch.zeros(1 + MAX_GROUPS, dtype=torch.int32,
                                      device=device)
    return _tickets[index]


def dma_probe(sources: Sequence[torch.Tensor], carry: torch.Tensor,
              chunk_rows: int, touch_every: int = 1, engine: str = "bulk",
              depth: int = 4, unit: int = 16384) -> torch.Tensor:
    """KD: copy every source byte into shared memory; return the carry
    plus the touched chunk heads of ``sources[0]`` (module docstring),
    with one block per SM (at most one per unit)."""
    global dma_probe_launches
    _check(sources, carry, chunk_rows, touch_every, engine, depth, unit)
    s0 = sources[0]
    if s0.device.type == "cpu":
        return plain_dma_probe(sources, carry, chunk_rows, touch_every)
    if s0.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {s0.device}")
    if any(t.data_ptr() % 16 for t in (*sources, carry)):
        raise ValueError("the probe needs 16-byte aligned sources and carry")
    lib = kernel_lib()
    src_bytes = s0.numel() * 4
    units = len(sources) * -(-src_bytes // unit)
    sms = torch.cuda.get_device_properties(s0.device).multi_processor_count
    blocks = min(sms, units)
    ptrs = (ctypes.c_void_p * len(sources))(*(s.data_ptr() for s in sources))
    with torch.cuda.device(s0.device):
        out = torch.empty_like(carry)
        partials = torch.empty(blocks + -(-blocks // GROUP), 8, 128,
                               dtype=torch.float32, device=s0.device)
        code = lib.dma_probe(
            ENGINES.index(engine), depth, len(sources), ptrs, src_bytes, unit,
            chunk_rows * 128 * 4, touch_every, blocks, carry.data_ptr(),
            partials.data_ptr(), _tickets_of(s0.device).data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        msg = lib.dma_error_string(code).decode()
        raise RuntimeError(f"dma_probe launch failed: CUDA error {code} ({msg})")
    dma_probe_launches += 1
    return out


def probe_bytes(sources: Sequence[torch.Tensor]) -> int:
    """Bytes the probe must move: every source byte read once, the (8,
    128) float32 result written once."""
    return sum(s.numel() * 4 for s in sources) + HEAD_BYTES
