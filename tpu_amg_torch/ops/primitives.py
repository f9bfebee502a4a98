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
The data-random gathers are laid out against the shared memory's bank
conflicts: the pair's index gather is a warp shuffle of packed rows,
and the x gather reads a replica of the tile, one copy a lane;
:func:`shared_wavefronts` counts, by a host model of the kernel's
thread map, what the gathers cost on given inputs.  The library reports
the design constants the host's checks rely on, and :func:`kernel_lib`
refuses one whose constants differ from this module's.
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
BANKS = 32  # shared-memory banks of 4 bytes; a wavefront is one word each

SHUFFLED = ("pair_gather", "gather_fma")  # ops whose index gather shuffles
REPLICATED = ("lane_gather", "pair_gather", "gather_fma")  # x from a replica


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
    dll.primitive_design.restype = i32
    dll.primitive_design.argtypes = [i32, ctypes.POINTER(i32)]
    check_design(dll)
    return dll


def design(op: str) -> tuple:
    """The host's statement of the op's kernel: (elements a thread, index
    gather by shuffle, x from the replica, k loop unrolled in full, steps
    of k a loop block), as ``primitive_design`` in the library gives it."""
    return (per_thread(op), int(op in SHUFFLED), int(op in REPLICATED),
            int(op in FULL_UNROLL), BLOCK_K)


def check_design(dll) -> None:
    """Raise unless every op's kernel in the library ``dll`` is built as
    :func:`design` states it, which the SASS check and the wavefront
    count rely on."""
    for code, op in enumerate(OPS):
        built = (ctypes.c_int * 5)()
        err = dll.primitive_design(code, built)
        if err or tuple(built) != design(op):
            raise RuntimeError(f"the library's {op} kernel is built as "
                               f"{tuple(built)} (error {err}), the host "
                               f"states {design(op)}")


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
    if idx.data_ptr() % 16:
        raise ValueError("the kernel reads idx 16 bytes at a time: it must "
                         "be 16-byte aligned")
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


def warp_wavefronts(words: np.ndarray) -> np.ndarray:
    """The shared-memory wavefronts of warp loads: ``words`` (..., 32)
    holds each lane's 4-byte word address; a load takes as many
    wavefronts as the most distinct words that fall in one bank (lanes
    reading one word share it)."""
    w = np.sort(np.asarray(words, np.int64).reshape(-1, 32), axis=1)
    first = np.ones(w.shape, bool)
    first[:, 1:] = w[:, 1:] != w[:, :-1]
    key = np.arange(w.shape[0])[:, None] * BANKS + w % BANKS
    per_bank = np.bincount(key[first], minlength=w.shape[0] * BANKS)
    return per_bank.reshape(-1, BANKS).max(1).reshape(np.shape(words)[:-1])


def shared_wavefronts(op: str, x: torch.Tensor, idx: torch.Tensor,
                      inner: int):
    """The mean shared-memory wavefronts of a warp gather of the kernel
    on these inputs, over every gather of its ``inner`` steps, under its
    thread map: element e = thread + q · threads (q < :func:`per_thread`)
    of the tile, so that a warp's 32 lanes share the tile row s = e //
    128 and hold columns l = e % 128 in order.  A warp shuffle (the
    pair's index gather) counts as one.  A host model of the kernel's
    addresses (:func:`warp_wavefronts`), not a hardware counter.  None
    for ops without a gather (add, fma, select)."""
    _check(x, idx, op, inner)
    if OPS[op].loads == 0:
        return None
    sub = tile_rows(op)
    n = sub * 128
    per = per_thread(op)
    e = np.arange(n).reshape(per, n // per // 32, 32)
    s, l = e // 128, e % 128
    lane = e % 32
    ix = idx.cpu().numpy().astype(np.int64)
    tiles = np.arange(ix.shape[0])[:, None, None, None]
    total, count = 0, 0
    for k in range(inner):
        mi = k % NIDX
        i = ix[:, mi][:, s, l] + k
        m = i & 127
        loads = []
        if op == "roll_lane":
            loads.append(s * 128 + ((l - (k % 127 + 1)) & 127))
        elif op == "roll_sub":
            loads.append(((s - (k % 7 + 1)) & 7) * 128 + l)
        elif op == "sub_gather":
            loads.append((i & 7) * 128 + l)
        elif op == "bf16_sub":
            loads.append(((i & 15) * 128 + l) // 2)  # two bfloat16 a word
        elif op == "bf16_lane":
            loads.append((s * 128 + m) // 2)
        elif op == "lane_gather":
            loads.append((s * 128 + m) * BANKS + lane)
        else:  # the pair: the index gather by a shuffle, then x at its row
            total, count = total + m.size // 32, count + m.size // 32
            row = (ix[:, mi][tiles, s, m] + k) & 7
            loads.append((row * 128 + m) * BANKS + lane)
        for words in loads:
            wf = warp_wavefronts(words)
            total, count = total + int(wf.sum()), count + wf.size
    return total / count


def design_floor_ns(op: str, wavefronts: float, sms: int,
                    clock_mhz: float) -> float:
    """The least time of one marginal tile-op (as :func:`op_bound_ns`)
    that the op's shared-memory accesses allow at ``wavefronts`` a warp
    gather: the bound's load term times the wavefronts."""
    info = OPS[op]
    steps = (issued_steps(op, HI) - issued_steps(op, LO)) / (HI - LO)
    return (tile_rows(op) * 128 * info.loads / LDS_PER_CLOCK * wavefronts
            * steps / (sms * clock_mhz * 1e6) * 1e9)


PER_THREAD = 4  # tile elements per thread in the kernel
REPLICA_PER_THREAD = 1  # for the ops that read the replica (one block an SM)
BLOCK_K = 16  # steps of k the kernel unrolls in one block of its loop
FULL_UNROLL = ("fma",)  # ops whose whole k loop is unrolled


def per_thread(op: str) -> int:
    """Tile elements a thread of the op's kernel."""
    return REPLICA_PER_THREAD if op in REPLICATED else PER_THREAD


def sass_instruction_counts() -> dict:
    """{(op, inner): counts} of the built library's kernels, from
    ``cuobjdump --dump-sass`` (:func:`parse_sass`)."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    return parse_sass(subprocess.run(
        [str(cuobjdump), "--dump-sass",
         str(build_cuda_library("libamg_primitives.so", SOURCE))],
        capture_output=True, text=True, check=True).stdout)


def _kinds(lines) -> dict:
    """Instructions, shared-memory loads (LDS), indexed warp shuffles
    (SHFL.IDX), FFMAs and local-memory accesses (LDL/STL: spills) among
    SASS ``lines``."""
    return dict(
        total=len(lines),
        LDS=sum(bool(re.search(r"\bLDS(\.|\s)", x)) for x in lines),
        SHFL=sum(bool(re.search(r"\bSHFL\.IDX\b", x)) for x in lines),
        FFMA=sum(bool(re.search(r"\bFFMA(\.|\s)", x)) for x in lines),
        local=sum(bool(re.search(r"\b(LDL|STL)(\.|\s)", x)) for x in lines))


def parse_sass(sass: str) -> dict:
    """{(op, inner): counts} of the probe's kernels in ``sass``: the
    function's :func:`_kinds`, whether it has a loop (a branch back to a
    lower address) and, as ``loop_total``, ``loop_LDS`` and
    ``loop_SHFL``, the kinds inside its largest loop's body (from the
    branch's target to the branch; 0 without a loop)."""
    names = list(OPS)
    # key -> ([(address, line)], {label: address}, labels awaiting one)
    functions = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*probe_kernel\S*?Li(\d+)ELi(\d+)ELi(\d+)E",
                      line)
        if m:
            cur = ([], {}, [])
            functions[(names[int(m.group(2))], int(m.group(3)))] = cur
            continue
        if cur is None:
            continue
        insns, labels, pending = cur
        label = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+\S", line)
        if label:
            pending.append(label.group(1))
        elif ins:
            addr = int(ins.group(1), 16)
            for name in pending:  # a label names the next instruction
                labels[name] = addr
            pending.clear()
            insns.append((addr, line))
    counts = {}
    for key, (insns, labels, _) in functions.items():
        c = _kinds([x for _, x in insns])
        body = []
        for addr, line in insns:
            target = re.search(r"\bBRA\b\W*(\.L_x_\d+|0x[0-9a-f]+)", line)
            if not target:
                continue
            t = target.group(1)
            start = labels.get(t) if t.startswith(".") else int(t, 16)
            if start is not None and start < addr:
                inside = [x for a, x in insns if start <= a <= addr]
                body = max(body, inside, key=len)
        c["loop"] = bool(body)
        inner = _kinds(body)
        c.update(loop_total=inner["total"], loop_LDS=inner["LDS"],
                 loop_SHFL=inner["SHFL"])
        counts[key] = c
    return counts


def sass_unfolded(counts: dict) -> dict:
    """{op: (ok, description)}: the HI kernel issues every step of its
    loop and spills nothing.  A looped op must keep a loop whose body
    holds 16 steps' gathers (or two instructions a step, without
    gathers) for its elements (:func:`per_thread`): a shared-memory load
    each, but a SHFL.IDX for the pair's index gather, so that no gather
    is merged with another step's or taken out of the loop; fma,
    unrolled in full, must hold an FFMA for every step that differs from
    the others, and element."""
    out = {}
    for op, info in OPS.items():
        hi, lo = counts[(op, HI)], counts[(op, LO)]
        steps = BLOCK_K * per_thread(op)
        shuffles = int(op in SHUFFLED)
        if op in FULL_UNROLL:
            ok = hi["FFMA"] >= issued_steps(op, HI) * PER_THREAD
        elif info.loads:
            ok = (hi["loop"]
                  and hi["loop_LDS"] >= steps * (info.loads - shuffles)
                  and hi["loop_SHFL"] >= steps * shuffles)
        else:
            ok = hi["loop"] and hi["loop_total"] >= steps * 2
        ok = ok and hi["local"] == 0 and lo["local"] == 0
        out[op] = (ok, f"{op}: {hi['total']} instructions, {hi['LDS']} LDS, "
                       f"{hi['SHFL']} SHFL.IDX, "
                       f"{hi['FFMA']} FFMA, {hi['local']} LDL/STL, "
                       + (f"a loop of {hi['loop_total']} instructions, "
                          f"{hi['loop_LDS']} LDS, {hi['loop_SHFL']} SHFL.IDX"
                          if hi["loop"] else "no loop"))
    return out
