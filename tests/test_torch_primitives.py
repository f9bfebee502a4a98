"""The on-chip primitive probe ``primitive_probe``
(tpu_amg_torch.ops.primitives) and its command line
(tpu_amg_torch.tools.microbench_primitives).

The JAX kernel (tools/microbench_primitives.py ``make_kernel``) is built
inside a timing harness and cannot be called alone, so the plain version
is held against jnp restatements of the harness's bodies (:96-143, with
``jnp.roll`` for ``pltpu.roll``) on 3 tiles at inner = 16: exactly, but
for fma and gather_fma at 1e-6 relative (a fused multiply-add rounds
once).  The CUDA cases run the kernel and skip without a card.
"""

import numpy as np
import pytest
import torch

from tpu_amg_torch.ops import primitives
from tpu_amg_torch.tools import microbench_primitives

_FUSED = ("fma", "gather_fma")


def _jax_bodies():
    import jax.numpy as jnp

    def taa(x, i, axis):
        return jnp.take_along_axis(x, i, axis=axis)

    def pair(x, i, k):
        r = taa(x, (i + k) & 7, 0)
        return taa(r, (i + k) & 127, -1)

    return {
        "add": lambda x, i, k: x + ((i + k) & 63).astype(x.dtype),
        "fma": lambda x, i, k: x * (1.0 + 1e-7 * k) + x,
        "select": lambda x, i, k: jnp.where(((i + k) & 7) == 3, x, x + x),
        "roll_lane": lambda x, i, k: jnp.roll(x, k % 127 + 1, 1),
        "roll_sub": lambda x, i, k: jnp.roll(x, k % 7 + 1, 0),
        "lane_gather": lambda x, i, k: taa(x, (i + k) & 127, -1),
        "sub_gather": lambda x, i, k: taa(x, (i + k) & 7, 0),
        "pair_gather": pair,
        "bf16_lane": lambda x, i, k: taa(
            x, (i + jnp.int16(k)) & jnp.int16(127), -1),
        "bf16_sub": lambda x, i, k: taa(
            x, (i + jnp.int16(k)) & jnp.int16(15), 0),
        "gather_fma": lambda x, i, k: pair(x, i, k) * x,
    }


def _jax_probe(op, x, idx, inner):
    """The harness's kernel body, tile by tile: acc = x * 0, then
    acc += body(x, idx[k % NIDX], k)."""
    import jax.numpy as jnp

    body = _jax_bodies()[op]
    dt = jnp.bfloat16 if primitives.OPS[op].bf16 else jnp.float32
    out = []
    for t in range(x.shape[0]):
        xt = jnp.asarray(x[t], dt)
        it = jnp.asarray(idx[t])
        acc = xt * 0.0
        for k in range(inner):
            acc += body(xt, it[k % primitives.NIDX], k)
        out.append(np.asarray(acc.astype(jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("op", list(primitives.OPS))
def test_plain_matches_the_harness_bodies(op):
    x, idx = primitives.make_inputs(op, 3, "cpu")
    got = primitives.primitive_probe(x, idx, op, 16)
    assert got.shape == x.shape and got.dtype == x.dtype
    ref = _jax_probe(op, x.float().numpy(), idx.numpy(), 16)
    if op in _FUSED:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_inputs_follow_the_harness():
    for op, info in primitives.OPS.items():
        x, idx = primitives.make_inputs(op, 2, "cpu")
        sub = 16 if info.bf16 else 8
        assert x.shape == (2, sub, 128) and idx.shape == (2, 8, sub, 128)
        assert int(idx.max()) < info.idx_max and int(idx.min()) >= 0


def test_rejects_bad_input():
    x, idx = primitives.make_inputs("add", 2, "cpu")
    with pytest.raises(ValueError, match="op"):
        primitives.primitive_probe(x, idx, "roll", 16)
    with pytest.raises(ValueError):  # f32 tiles for a bf16 op
        primitives.primitive_probe(x, idx, "bf16_lane", 16)
    with pytest.raises(ValueError):  # idx of the wrong shape
        primitives.primitive_probe(x, idx[:, :4], "add", 16)
    with pytest.raises(ValueError):
        primitives.primitive_probe(x, idx, "add", 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        primitives.primitive_probe(x.to("meta"), idx.to("meta"), "add", 16)


def test_plain_version_does_not_count_launches():
    before = primitives.primitive_probe_launches
    x, idx = primitives.make_inputs("fma", 1, "cpu")
    primitives.primitive_probe(x, idx, "fma", 16)
    assert primitives.primitive_probe_launches == before


def test_op_bound():
    # an (8, 128) tile of one shared-memory load and one add per element:
    # the loads bound it, 32 lanes a clock on 132 SMs at 1980 MHz
    assert primitives.op_bound_ns("lane_gather", 132, 1980.0) == pytest.approx(
        1024 / (32 * 132 * 1.98e9) * 1e9)
    # three instructions an element, issued 128 a clock
    assert primitives.op_bound_ns("add", 132, 1980.0) == pytest.approx(
        1024 * 3 / (128 * 132 * 1.98e9) * 1e9)
    assert primitives.op_bound_ns("bf16_sub", 132, 1980.0) == pytest.approx(
        2 * primitives.op_bound_ns("sub_gather", 132, 1980.0))
    # a whole tile's HI steps: every step of lane_gather, fma's 228
    assert primitives.op_bound_ns("lane_gather", 132, 1980.0,
                                  primitives.HI) == pytest.approx(
        primitives.HI * primitives.op_bound_ns("lane_gather", 132, 1980.0))
    assert primitives.op_bound_ns("fma", 132, 1980.0,
                                  primitives.HI) == pytest.approx(
        228 * 1024 * 2 / (128 * 132 * 1.98e9) * 1e9)


def test_fma_steps_repeat():
    # float32(1 + 1e-7 k) takes 228 values for k < 272 and 14 for k < 16
    assert primitives.issued_steps("fma", primitives.HI) == 228
    assert primitives.issued_steps("fma", primitives.LO) == 14
    assert primitives.issued_steps("add", primitives.HI) == primitives.HI


_SASS = """
        Function : _ZN46_GLOBAL__N__x12probe_kernelIfiLi8ELi5ELi272EEEvPKT_PKT0_PS1_i
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                          /* 0x000fe40000000800 */
.L_x_0:
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/                   LDS R2, [R3] ;
        /*0030*/              @P0 BRA `(.L_x_0) ;
        Function : _ZN46_GLOBAL__N__x12probe_kernelIfiLi8ELi5ELi16EEEvPKT_PKT0_PS1_i
        /*0000*/                   LDS.U16 R2, [R3] ;
        /*0010*/                   STL [R1], R2 ;
        /*0020*/                   BRA 0x30 ;
"""


def test_sass_counts(monkeypatch):
    from unittest import mock

    monkeypatch.setattr(primitives, "build_cuda_library",
                        lambda *a, **k: "lib.so")
    monkeypatch.setattr(primitives, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(primitives.subprocess, "run",
                        mock.Mock(return_value=mock.Mock(stdout=_SASS)))
    counts = primitives.sass_instruction_counts()
    assert counts == {
        ("lane_gather", 272): dict(total=4, LDS=1, SHFL=0, FFMA=0, local=0,
                                   loop=True, loop_total=3, loop_LDS=1,
                                   loop_SHFL=0),
        ("lane_gather", 16): dict(total=3, LDS=1, SHFL=0, FFMA=0, local=1,
                                  loop=False, loop_total=0, loop_LDS=0,
                                  loop_SHFL=0),
    }


_SASS_HEX = """
        Function : _ZN46_GLOBAL__N__x12probe_kernelIfiLi8ELi6ELi272EEEvPKT_PKT0_PS1_i
        /*0000*/                   LDS R2, [R3] ;
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/                   LDS R5, [R3+0x200] ;
        /*0030*/                   LDS R6, [R3+0x400] ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   STG.E [R8], R2 ;
        /*0060*/                   BRA 0x60;
"""


def test_sass_loop_body_by_address():
    # a branch back to an address: the loop body runs from its target to
    # the branch, and the load before it is the function's but not the
    # loop's; the closing branch to itself is no loop
    counts = primitives.parse_sass(_SASS_HEX)
    assert counts == {("sub_gather", 272): dict(
        total=7, LDS=3, SHFL=0, FFMA=0, local=0, loop=True, loop_total=4,
        loop_LDS=2, loop_SHFL=0)}


_SASS_SHFL = """
        Function : _ZN46_GLOBAL__N__x12probe_kernelIfiLi8ELi10ELi272EEEvPKT_PKT0_PS1_i
.L_x_3:
        /*0010*/                   SHFL.IDX PT, R5, R4, R6, 0x1f ;
        /*0020*/                   PRMT R5, R5, 0x3210, R6 ;
        /*0030*/                   LDS R7, [R8+0x40] ;
        /*0040*/                   SHFL.BFLY PT, R9, R4, 0x1, 0x1f ;
        /*0050*/                   FFMA R2, R7, R3, R2 ;
        /*0060*/              @P0 BRA `(.L_x_3) ;
"""


def test_sass_counts_shuffles(monkeypatch):
    # SHFL.IDX (the indexed shuffle of the pair's index gather) counts;
    # a butterfly shuffle does not
    from unittest import mock

    monkeypatch.setattr(primitives, "build_cuda_library", lambda *a, **k: "l")
    monkeypatch.setattr(primitives, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(primitives.subprocess, "run",
                        mock.Mock(return_value=mock.Mock(stdout=_SASS_SHFL)))
    counts = primitives.sass_instruction_counts()
    assert counts == {("gather_fma", 272): dict(total=6, LDS=1, SHFL=1,
                                                FFMA=1, local=0, loop=True,
                                                loop_total=6, loop_LDS=1,
                                                loop_SHFL=1)}


def _counts(op, lds, shfl, ffma=0, local=0, loop=True, loop_lds=None):
    return dict(total=1000, LDS=lds, SHFL=shfl, FFMA=ffma, local=local,
                loop=loop, loop_total=500 if loop else 0,
                loop_LDS=lds if loop_lds is None else loop_lds,
                loop_SHFL=shfl if loop else 0)


def test_sass_check_counts_shuffles_beside_loads():
    # every op's HI block holds its element-steps' gathers: the pair's
    # index gather as a SHFL.IDX, its x gather and every other gather as
    # an LDS; one short of either fails, as a spill does
    good = {}
    for op, info in primitives.OPS.items():
        steps = primitives.BLOCK_K * primitives.per_thread(op)
        shuffled = op in primitives.SHUFFLED
        for inner in primitives.INNERS:
            good[(op, inner)] = _counts(
                op, steps * (info.loads - shuffled), steps * shuffled,
                ffma=2000)
    assert all(ok for ok, _ in primitives.sass_unfolded(good).values())
    for op in primitives.SHUFFLED:
        steps = primitives.BLOCK_K * primitives.per_thread(op)
        short = dict(good)
        short[(op, primitives.HI)] = _counts(op, steps, steps - 1)
        assert not primitives.sass_unfolded(short)[op][0]
        short[(op, primitives.HI)] = _counts(op, steps - 1, steps)
        assert not primitives.sass_unfolded(short)[op][0]
        # two loads a step without the shuffle are not the kernel's code
        short[(op, primitives.HI)] = _counts(op, 2 * steps, 0)
        assert not primitives.sass_unfolded(short)[op][0]
    steps = primitives.BLOCK_K * primitives.per_thread("gather_fma")
    spilled = dict(good)
    spilled[("gather_fma", primitives.LO)] = _counts("gather_fma", steps,
                                                     steps, local=1)
    assert not primitives.sass_unfolded(spilled)["gather_fma"][0]


@pytest.mark.parametrize("op", ["sub_gather", "lane_gather", "roll_sub"])
def test_sass_check_counts_gathers_inside_the_loop(op):
    # the function holds every step's loads, but the loop one short: a
    # gather merged with another step's or hoisted out of the loop fails
    good = {}
    for o, info in primitives.OPS.items():
        steps = primitives.BLOCK_K * primitives.per_thread(o)
        shuffled = o in primitives.SHUFFLED
        for inner in primitives.INNERS:
            good[(o, inner)] = _counts(o, steps * (info.loads - shuffled),
                                       steps * shuffled, ffma=2000)
    assert primitives.sass_unfolded(good)[op][0]
    steps = primitives.BLOCK_K * primitives.per_thread(op)
    short = dict(good)
    short[(op, primitives.HI)] = _counts(op, 2 * steps, 0,
                                         loop_lds=steps - 1)
    ok, desc = primitives.sass_unfolded(short)[op]
    assert not ok and f"{steps - 1} LDS, 0 SHFL.IDX" in desc


class _Library:
    """A stand-in for the built library's design report."""

    def __init__(self, override=None):
        self.override = override or {}

    def primitive_design(self, code, out):
        op = list(primitives.OPS)[code]
        for j, v in enumerate(self.override.get(op, primitives.design(op))):
            out[j] = v
        return 0


def test_design_check():
    # the host's statement of each kernel, as the kernel source has it
    assert primitives.design("gather_fma") == (1, 1, 1, 0, 16)
    assert primitives.design("lane_gather") == (1, 0, 1, 0, 16)
    assert primitives.design("sub_gather") == (4, 0, 0, 0, 16)
    assert primitives.design("fma") == (4, 0, 0, 1, 16)
    primitives.check_design(_Library())
    # a library built otherwise is refused
    with pytest.raises(RuntimeError, match="pair_gather"):
        primitives.check_design(_Library({"pair_gather": (4, 1, 1, 0, 16)}))
    with pytest.raises(RuntimeError, match="add"):
        primitives.check_design(_Library({"add": (4, 0, 0, 0, 8)}))


def test_warp_wavefronts():
    lanes = np.arange(32)
    # 32 distinct words in one bank: 32 wavefronts
    assert primitives.warp_wavefronts(lanes * 32) == 32
    # lane c reads word c (an identity gather): every lane its own bank
    assert primitives.warp_wavefronts(lanes) == 1
    # every lane reads one word: a broadcast
    assert primitives.warp_wavefronts(np.full(32, 77)) == 1
    # two words in each of 16 banks, a batch of loads at once
    both = np.stack([lanes % 16 + 32 * (lanes // 16), lanes])
    np.testing.assert_array_equal(primitives.warp_wavefronts(both), [2, 1])


def _row_gather_words(idx, inner):
    """Words of a gather at column (idx + k) & 127 of the warp's own row
    of an (8, 128) table in shared memory, under the thread map of 4
    elements a thread (e = thread + 256 q): (loads, 32)."""
    e = np.arange(1024)
    s, l = e // 128, e % 128
    ix = np.asarray(idx, np.int64)
    return np.concatenate([s * 128 + ((ix[:, k % 8][:, s, l] + k) & 127)
                           for k in range(inner)]).reshape(-1, 32)


def test_shared_wavefronts_on_hand_built_tiles():
    x = torch.zeros(1, 8, 128)
    lane = torch.arange(128) % 32
    # every lane at column idx + k = 32 (l mod 4) + k: read from a table
    # of the tile as it is, 4 distinct words of one bank a warp load; from
    # the kernel's replica, one wavefront
    idx = (32 * (torch.arange(128) % 4)).expand(1, 8, 8, 128).contiguous()
    assert primitives.warp_wavefronts(
        _row_gather_words(idx.numpy(), 16)).mean() == 4
    assert primitives.shared_wavefronts("lane_gather", x, idx.int(), 16) == 1
    # column = lane: an identity gather; a constant column: a broadcast
    ident = lane.expand(1, 8, 8, 128).contiguous().int()
    assert primitives.warp_wavefronts(
        _row_gather_words(ident.numpy(), 16)).mean() == 1
    same = torch.zeros(1, 8, 8, 128, dtype=torch.int32)
    assert primitives.warp_wavefronts(
        _row_gather_words(same.numpy(), 16)).mean() == 1
    assert primitives.shared_wavefronts("pair_gather", x, same, 16) == 1
    # ops without gathers have none
    assert primitives.shared_wavefronts("add", x, same, 16) is None


@pytest.mark.parametrize("op", ["lane_gather", "pair_gather", "gather_fma"])
def test_shared_wavefronts_on_the_harness_inputs(op):
    x, idx = primitives.make_inputs(op, 4, "cpu")
    # random columns of a row read from a table of the tile as it is:
    # 2.7-2.9 deep in the fullest bank on average; the kernel's design
    # takes one wavefront a gather
    words = _row_gather_words(idx.numpy(), 16)
    assert 2.7 <= primitives.warp_wavefronts(words).mean() <= 2.9
    assert primitives.shared_wavefronts(op, x, idx, 16) == 1.0


@pytest.mark.parametrize("op", ["sub_gather", "roll_lane", "roll_sub"])
def test_shared_wavefronts_of_distinct_banks(op):
    x, idx = primitives.make_inputs(op, 2, "cpu")
    assert primitives.shared_wavefronts(op, x, idx, 16) == 1.0


def test_design_floor():
    # the load term of the bound, times the wavefronts
    sms, clock = 132, 1980.0
    assert primitives.design_floor_ns("gather_fma", 1.0, sms,
                                      clock) == pytest.approx(
        primitives.op_bound_ns("gather_fma", sms, clock))
    assert primitives.design_floor_ns("lane_gather", 2.78, sms,
                                      clock) == pytest.approx(
        2.78 * primitives.op_bound_ns("lane_gather", sms, clock))


def _shuffle_row(packed, m):
    """The kernel's index gather of column m: byte m & 3 of lane m >> 2's
    packed register (prmt.f4e keeps the byte in the low 8 bits)."""
    word = packed[m >> 2]
    return (word >> (8 * (m & 3))) & 0xff


def test_packed_shuffle_equals_the_index_gather():
    # a plain restatement of the kernel's packing (4 entries a lane, a
    # byte each) and shuffle: every entry of every row of every array,
    # and its low 3 bits for entries of any size
    x, idx = primitives.make_inputs("gather_fma", 3, "cpu")
    ix = idx.numpy().astype(np.int64)
    ix[0, 0, 0, :4] = [1000, -3, 255, 7 + 256]  # beyond idx_max
    for t in range(ix.shape[0]):
        for mi in range(primitives.NIDX):
            for s in range(8):
                row = ix[t, mi, s]
                b = row & 0xff
                packed = b[0::4] | b[1::4] << 8 | b[2::4] << 16 | b[3::4] << 24
                got = np.array([_shuffle_row(packed, m) for m in range(128)])
                assert np.array_equal(got & 7, row & 7)
                if t or mi or s:
                    assert np.array_equal(got, row)


def test_cli_on_cpu(capsys):
    recs, gathers = microbench_primitives.run(
        ["--device", "cpu", "--tiles", "4", "--reps", "1", "lane_gather",
         "xla_gather"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "plain version" in lines[0]
    assert [r["op"] for r in recs] == ["lane_gather"]
    assert len(gathers) == 3
    assert any("ns/op" in line for line in lines)
    assert sum("index_select" in line for line in lines) == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", list(primitives.OPS))
@pytest.mark.parametrize("inner", primitives.INNERS)
def test_kernel_matches_plain_on_card(cuda, op, inner):
    x, idx = primitives.make_inputs(op, 5, cuda)
    before = primitives.primitive_probe_launches
    got = primitives.primitive_probe(x, idx, op, inner)
    ref = primitives.plain_primitive_probe(x, idx, op, inner)
    torch.cuda.synchronize()
    assert primitives.primitive_probe_launches == before + 1
    if op in _FUSED:
        torch.testing.assert_close(got, ref, rtol=1e-6,
                                   atol=1e-6 * float(ref.abs().max()))
    else:
        assert torch.equal(got, ref)
