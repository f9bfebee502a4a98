"""On-chip primitive throughput probe on the device: KG ``primitive_probe``.

``primitive_probe(x, idx, op, inner)`` returns, for every tile t,

    out[t] = Σ over k < inner of body_op(x[t], idx[t, k mod 8], k),

summed from x·0 in x's dtype, in k order.  x is (tiles, 8, 128) float32
with idx (tiles, 8, 8, 128) int32, or, for the two bf16 ops, (tiles, 16,
128) bfloat16 with int16 idx.  The bodies are those of the JAX package's
``tools/microbench_primitives.py`` (``make_kernel`` :52, bodies :96-143),
which it replaces; the two rolls follow ``jnp.roll``: element l of the
result is element (l − shift) mod width of x.

On the card (CUDA C++ in ``tpu_amg_torch/csrc/primitives.cu``, compiled
with nvcc for ``sm_90a`` into ``build/tpu_amg_torch/libamg_primitives.so``
at first launch) one block runs one tile; lane ops are shared-memory
reads across a row of 128, row ops shared-memory reads down the tile's
rows, and ``inner`` is compiled in: the harness's LO = 16 and HI = 272.
The cost of one op is (t(HI) − t(LO)) / (tiles · (HI − LO)), as in the
harness; :data:`OPS` gives the instructions and shared-memory loads each
element needs per step, from which :func:`op_bound_ns` reckons the least
time a tile-op can take: an SM issues 128 thread instructions a clock
(4 schedulers, one warp instruction each) and serves 32 lanes'
shared-memory loads a clock (32 banks of 4 bytes).

The plain PyTorch version beside the kernel runs the bodies as torch ops
in a Python loop over k.  The wrapper takes it only when its tensors lie
on the CPU; for a CUDA tensor it launches the kernel or raises.  Launches
are counted in ``primitive_probe_launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from tpu_amg_torch.ops._build import build_cuda_library, nvcc_path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "primitives.cu"
NIDX = 8  # index arrays cycled by k (the harness's NIDX)
LO, HI = 16, 272  # the harness's two loop lengths, compiled into the kernel
INNERS = (LO, HI)


ISSUE_PER_CLOCK = 128  # thread instructions an SM issues a clock (4 x 32)
LDS_PER_CLOCK = 32  # lanes' shared-memory loads an SM serves a clock


@dataclasses.dataclass(frozen=True)
class OpInfo:
    name: str  # the harness's case name
    bf16: bool  # (16, 128) bfloat16 tiles with int16 idx
    idx_max: int  # idx is drawn from [0, idx_max)
    issue: int  # instructions an element needs per step: the op, the add
    loads: int  # shared-memory loads an element needs per step
    what: str  # those instructions


# in the order of the kernel's Op enum
OPS = {
    "add": OpInfo("add x+idx (i32->f32 cast+add)", False, 8, 3, 0,
                  "convert, add, accumulate"),
    "fma": OpInfo("fma x*c[k]+x", False, 8, 2, 0, "FMA, accumulate"),
    "select": OpInfo("select(idx==k, x, 2x)", False, 8, 3, 0,
                     "compare, select, accumulate"),
    "roll_lane": OpInfo("roll lanes by k", False, 8, 2, 1, "load, accumulate"),
    "roll_sub": OpInfo("roll sublanes by k", False, 8, 2, 1,
                       "load, accumulate"),
    "lane_gather": OpInfo("lane gather (8,128)", False, 128, 2, 1,
                          "load, accumulate"),
    "sub_gather": OpInfo("sublane gather (8,128)", False, 8, 2, 1,
                         "load, accumulate"),
    "pair_gather": OpInfo("sub+lane gather pair (8,128)", False, 128, 3, 2,
                          "2 loads, accumulate"),
    "bf16_lane": OpInfo("lane gather bf16 (16,128) i16", True, 128, 3, 1,
                        "load, accumulate, round"),
    "bf16_sub": OpInfo("sublane gather bf16 (16,128) i16", True, 16, 3, 1,
                       "load, accumulate, round"),
    "gather_fma": OpInfo("gather pair + mul", False, 128, 3, 2,
                         "2 loads, FMA"),
}


def issued_steps(op: str, inner: int) -> int:
    """Steps of k whose body differs from every earlier one: all of them,
    but for fma, whose c_k = float32(1 + 1e-7 k) repeats (floats near 1
    are 1.19e-7 apart), so that a compiler merges the equal steps."""
    if op != "fma":
        return inner
    return len(np.unique(np.float32(1.0 + 1e-7 * np.arange(inner))))


primitive_probe_launches = 0


def reset_launch_counts() -> None:
    global primitive_probe_launches
    primitive_probe_launches = 0


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The probe's library, compiled with nvcc on first call."""
    dll = ctypes.CDLL(str(build_cuda_library("libamg_primitives.so", SOURCE)))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    dll.primitive_probe.restype = i32
    dll.primitive_probe.argtypes = [i32, i32, i64, vp, vp, vp, vp]
    dll.primitives_error_string.restype = ctypes.c_char_p
    dll.primitives_error_string.argtypes = [i32]
    return dll


def tile_rows(op: str) -> int:
    return 16 if OPS[op].bf16 else 8


def make_inputs(op: str, tiles: int, device, seed: int = 0):
    """The harness's inputs (microbench_primitives.py:65-69): x standard
    normal, then idx uniform in [0, idx_max), from one numpy generator."""
    info = OPS[op]
    sub = tile_rows(op)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((tiles, sub, 128)))
    idx = torch.from_numpy(rng.integers(0, info.idx_max, (tiles, NIDX, sub, 128)))
    if info.bf16:
        return (x.to(device, torch.float32).to(torch.bfloat16),
                idx.to(device, torch.int16))
    return x.to(device, torch.float32), idx.to(device, torch.int32)


def _check(x: torch.Tensor, idx: torch.Tensor, op: str, inner: int) -> None:
    if op not in OPS:
        raise ValueError(f"op {op!r}; one of {tuple(OPS)}")
    sub = tile_rows(op)
    dt, it = ((torch.bfloat16, torch.int16) if OPS[op].bf16
              else (torch.float32, torch.int32))
    tiles = x.shape[0] if x.dim() == 3 else -1
    if (x.shape != (tiles, sub, 128) or idx.shape != (tiles, NIDX, sub, 128)
            or x.dtype != dt or idx.dtype != it):
        raise ValueError(f"{op} takes x ({sub}, 128) {dt} tiles and idx "
                         f"({NIDX}, {sub}, 128) {it}; got {tuple(x.shape)} "
                         f"{x.dtype}, {tuple(idx.shape)} {idx.dtype}")
    if x.device != idx.device or not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous on one device")
    if inner < 1:
        raise ValueError(f"inner {inner} < 1")


def _body(op: str, x: torch.Tensor, i: torch.Tensor, k: int) -> torch.Tensor:
    if op == "add":
        return x + ((i + k) & 63).to(x.dtype)
    if op == "fma":
        return x * float(np.float32(1.0 + 1e-7 * k)) + x
    if op == "select":
        return torch.where(((i + k) & 7) == 3, x, x + x)
    if op == "roll_lane":
        return torch.roll(x, k % 127 + 1, dims=2)
    if op == "roll_sub":
        return torch.roll(x, k % 7 + 1, dims=1)
    if op in ("lane_gather", "bf16_lane"):
        return torch.gather(x, 2, ((i + k) & 127).long())
    if op == "sub_gather":
        return torch.gather(x, 1, ((i + k) & 7).long())
    if op == "bf16_sub":
        return torch.gather(x, 1, ((i + k) & 15).long())
    r = torch.gather(x, 1, ((i + k) & 7).long())
    v = torch.gather(r, 2, ((i + k) & 127).long())
    return v * x if op == "gather_fma" else v


def plain_primitive_probe(x: torch.Tensor, idx: torch.Tensor, op: str,
                          inner: int) -> torch.Tensor:
    """Plain PyTorch version (same contract, any device)."""
    _check(x, idx, op, inner)
    acc = x * 0.0
    for k in range(inner):
        acc = acc + _body(op, x, idx[:, k % NIDX], k)
    return acc


def primitive_probe(x: torch.Tensor, idx: torch.Tensor, op: str,
                    inner: int) -> torch.Tensor:
    """KG: Σ over k < inner of the op's body (module docstring)."""
    global primitive_probe_launches
    _check(x, idx, op, inner)
    if x.device.type == "cpu":
        return plain_primitive_probe(x, idx, op, inner)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {x.device}")
    if inner not in INNERS:
        raise ValueError(f"inner {inner}: the kernel is compiled for {INNERS}")
    lib = kernel_lib()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        code = lib.primitive_probe(
            list(OPS).index(op), inner, x.shape[0], x.data_ptr(),
            idx.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        msg = lib.primitives_error_string(code).decode()
        raise RuntimeError(f"primitive_probe launch failed: CUDA error {code} "
                           f"({msg})")
    primitive_probe_launches += 1
    return out


def op_bound_ns(op: str, sms: int, clock_mhz: float,
                inner: int | None = None) -> float:
    """The least time on the whole card of one tile-op, the marginal op
    between LO and HI that the probe measures (``inner`` None), or of one
    tile's ``inner`` steps: each element needs the op's instructions at
    the issue rate and its loads at the shared-memory rate; for fma only
    the steps that differ count."""
    info = OPS[op]
    elements = tile_rows(op) * 128
    clocks = max(info.issue / ISSUE_PER_CLOCK, info.loads / LDS_PER_CLOCK)
    steps = (issued_steps(op, inner) if inner is not None else
             (issued_steps(op, HI) - issued_steps(op, LO)) / (HI - LO))
    return elements * clocks * steps / (sms * clock_mhz * 1e6) * 1e9


PER_THREAD = 4  # tile elements per thread in the kernel
BLOCK_K = 16  # steps of k the kernel unrolls in one block of its loop
FULL_UNROLL = ("fma",)  # ops whose whole k loop is unrolled


def sass_instruction_counts() -> dict:
    """{(op, inner): counts} of the built library's kernels, from
    ``cuobjdump --dump-sass``: instructions, shared-memory loads (LDS),
    FFMAs, local-memory accesses (LDL/STL: spills) and whether the code
    has a backward branch (a loop)."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "--dump-sass",
         str(build_cuda_library("libamg_primitives.so", SOURCE))],
        capture_output=True, text=True, check=True).stdout
    counts = {}
    names = list(OPS)
    c = None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*probe_kernel\S*?Li(\d+)ELi(\d+)ELi(\d+)E",
                      line)
        if m:
            c = dict(total=0, LDS=0, FFMA=0, local=0, loop=False, labels=set())
            counts[(names[int(m.group(2))], int(m.group(3)))] = c
            continue
        if c is None:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+\S", line)
        if label:
            c["labels"].add(label.group(1))
        elif ins:
            c["total"] += 1
            for op in ("LDS", "FFMA"):
                c[op] += bool(re.search(rf"\b{op}(\.|\s)", line))
            c["local"] += bool(re.search(r"\b(LDL|STL)(\.|\s)", line))
            # a branch back to a label already seen, or to a lower address
            target = re.search(r"\bBRA\b\W*(\.L_x_\d+|0x[0-9a-f]+)", line)
            if target:
                t = target.group(1)
                c["loop"] |= (t in c["labels"] if t.startswith(".")
                              else int(t, 16) < int(ins.group(1), 16))
    for c in counts.values():
        del c["labels"]
    return counts


def sass_unfolded(counts: dict) -> dict:
    """{op: (ok, description)}: the HI kernel issues every step of its
    loop and spills nothing.  A looped op must keep a loop whose block
    holds 16 steps' loads (or two instructions a step, without loads) for
    its 4 elements; fma, unrolled in full, must hold an FFMA for every
    step that differs from the others, and element."""
    out = {}
    for op, info in OPS.items():
        hi, lo = counts[(op, HI)], counts[(op, LO)]
        steps = BLOCK_K * PER_THREAD
        if op in FULL_UNROLL:
            ok = hi["FFMA"] >= issued_steps(op, HI) * PER_THREAD
        elif info.loads:
            ok = hi["loop"] and hi["LDS"] >= steps * info.loads
        else:
            ok = hi["loop"] and hi["total"] >= steps * 2
        ok = ok and hi["local"] == 0 and lo["local"] == 0
        out[op] = (ok, f"{op}: {hi['total']} instructions, {hi['LDS']} LDS, "
                       f"{hi['FFMA']} FFMA, {hi['local']} LDL/STL, "
                       f"{'a loop' if hi['loop'] else 'no loop'}")
    return out
