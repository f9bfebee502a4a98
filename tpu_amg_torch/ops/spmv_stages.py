"""Stage ablations of K1 on the device: KW ``csr_spmv_stages``.

``csr_spmv_stages(mat, x, mode, zero=0.0)`` runs K1 (``csr_spmv_capped``)
with stages taken out, on the capped part of a :class:`CappedCSR`, k = 1,
float64 or float32, with K1's group size ``mat.group`` and lane order.
j runs over the capped entries of row r, from ``start = indptr[r]``:

- ``full``: y[r] = Σ v_j·x[c_j], K1's arithmetic in K1's lane and
  shuffle order: bitwise equal to ``csr_spmv_capped``;
- ``nogather``: y[r] = Σ (v_j·x[r] + zero·c_j) = x[r]·Σ v_j + zero·Σ c_j:
  the indices are read, the x read is contiguous;
- ``nored``: P[r, l] = Σ over j with (j − start) mod G = l of v_j·x[c_j],
  shape (n, G): no shuffle reduce;
- ``nogather_nored``: the two combined;
- ``streamonly``: y[r] = Σ (v_j + zero·c_j): no x read;
- ``dataonly``: y[r] = Σ v_j: the indices are not read.

``zero`` is a runtime scalar, 0.0 in every timing, so that the compiler
keeps the index loads.

The kernel replaces the WELL prototype and ablation Pallas kernels of
the JAX package's ``tools/``:

| harness | TPU cases | port mode |
| --- | --- | --- |
| W1 ``well2proto.make_v3_kernel`` :258 | v3 | ``full`` |
| W3 ``make_v2_kernel`` :409 | v2, v2tile | ``full`` |
| W2 ``dataonly_call`` :324 | dataonly | ``dataonly`` |
| W3 / W4 / W5 | streamonly | ``streamonly`` |
| W3 / W4 / W5 | noA, noB | ``nogather``: on the card both WELL gather stages are the one x[c_j] load |
| W3 / W4 / W5 | nored | ``nored`` |
| W4 | noAnoBnored | ``nogather_nored`` |

Cases with no counterpart: ``blockedx``, ``passN`` and ``groupsN`` of W4
(``tools/wellablate.py``), ``v2high`` and ``v2roll`` of W3
(``tools/well2proto.py``) and ``justmm`` of W5 (``tools/wellablate2.py``).
They vary WELL's window tables, gather passes, window groups and MXU
merge, and a layout-free CSR kernel has none of these.

The plain PyTorch version beside the kernel is index arithmetic and
``index_add_``.  The wrapper takes it only when its tensors lie on the
CPU; for a CUDA tensor it launches the kernel (CUDA C++ in
``tpu_amg_torch/csrc/spmv_stages.cu``, compiled with nvcc for
``sm_90a`` into ``build/tpu_amg_torch/libamg_stages.so`` at first launch)
or raises.  Launches are counted in ``stages_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from tpu_amg_torch.ops._build import build_cuda_library
from tpu_amg_torch.ops.spmv import CappedCSR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "spmv_stages.cu"
MODES = ("full", "nogather", "nored", "nogather_nored", "streamonly",
         "dataonly")
_NO_REDUCE = ("nored", "nogather_nored")

stages_launches = 0


def reset_launch_counts() -> None:
    global stages_launches
    stages_launches = 0


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The ablation library, compiled with nvcc on first call."""
    dll = ctypes.CDLL(str(build_cuda_library("libamg_stages.so", SOURCE)))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix, scalar in (("f64", ctypes.c_double), ("f32", ctypes.c_float)):
        fn = getattr(dll, f"csr_spmv_stages_{suffix}")
        fn.restype = i32
        fn.argtypes = [i64, i32, i32, vp, vp, vp, vp, scalar, vp, vp]
    dll.stages_error_string.restype = ctypes.c_char_p
    dll.stages_error_string.argtypes = [i32]
    return dll


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _check(mat: CappedCSR, x: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; one of {MODES}")
    if x.device != mat.device or x.dtype != mat.dtype:
        raise ValueError(f"x ({x.dtype}, {x.device}) does not match the "
                         f"matrix ({mat.dtype}, {mat.device})")
    if x.dim() != 1 or x.shape[0] != mat.shape[1] or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous vector of {mat.shape[1]} "
                         f"entries, got {tuple(x.shape)}")
    if mode.startswith("nogather") and mat.shape[0] > mat.shape[1]:
        raise ValueError(f"{mode} reads x[r] for every row: A {mat.shape} "
                         f"has more rows than columns")


def out_shape(mat: CappedCSR, mode: str):
    return ((mat.shape[0], mat.group) if mode in _NO_REDUCE
            else (mat.shape[0],))


def stage_bytes(mat: CappedCSR, mode: str) -> int:
    """Bytes the mode must move, each read once: row pointers and values
    always, indices but in ``dataonly``, x (whole for a gather, the
    first n entries for ``nogather``), and the output written once."""
    isz = mat.data.element_size()
    n, m = mat.shape
    nnz = mat.data.numel()
    total = 8 * (n + 1) + nnz * isz
    if mode != "dataonly":
        total += 4 * nnz
    if mode in ("full", "nored"):
        total += m * isz
    elif mode.startswith("nogather"):
        total += n * isz
    out = 1
    for d in out_shape(mat, mode):
        out *= d
    return total + out * isz


def plain_csr_spmv_stages(mat: CappedCSR, x: torch.Tensor, mode: str,
                          zero: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract, any device)."""
    _check(mat, x, mode)
    rows = mat.rows()
    cols = mat.indices.long()
    v = mat.data
    if mode in ("full", "nored"):
        contrib = v * x[cols]
    elif mode in ("nogather", "nogather_nored"):
        contrib = v * x[rows] + zero * cols.to(v.dtype)
    elif mode == "streamonly":
        contrib = v + zero * cols.to(v.dtype)
    else:
        contrib = v
    n = mat.shape[0]
    if mode in _NO_REDUCE:
        g = mat.group
        lane = (torch.arange(v.numel(), device=v.device)
                - mat.indptr[:-1][rows]) % g
        out = torch.zeros(n * g, dtype=v.dtype, device=v.device)
        out.index_add_(0, rows * g + lane, contrib)
        return out.view(n, g)
    out = torch.zeros(n, dtype=v.dtype, device=v.device)
    out.index_add_(0, rows, contrib)
    return out


def csr_spmv_stages(mat: CappedCSR, x: torch.Tensor, mode: str,
                    zero: float = 0.0) -> torch.Tensor:
    """KW: K1 with stages taken out (see the module docstring)."""
    global stages_launches
    _check(mat, x, mode)
    if x.device.type == "cpu":
        return plain_csr_spmv_stages(mat, x, mode, zero)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"no kernel for {x.dtype}")
    lib = kernel_lib()
    y = torch.empty(out_shape(mat, mode), dtype=x.dtype, device=x.device)
    if mat.shape[0] == 0:
        return y
    with torch.cuda.device(x.device):
        code = getattr(lib, f"csr_spmv_stages_{_SUFFIX[x.dtype]}")(
            mat.shape[0], mat.group, MODES.index(mode), mat.indptr.data_ptr(),
            mat.indices.data_ptr(), mat.data.data_ptr(), x.data_ptr(),
            zero, y.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        msg = lib.stages_error_string(code).decode()
        raise RuntimeError(f"csr_spmv_stages launch failed: CUDA error {code} "
                           f"({msg})")
    stages_launches += 1
    return y
