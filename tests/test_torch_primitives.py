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

    monkeypatch.setattr(primitives, "build_cuda_library", lambda *a: "lib.so")
    monkeypatch.setattr(primitives, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(primitives.subprocess, "run",
                        mock.Mock(return_value=mock.Mock(stdout=_SASS)))
    counts = primitives.sass_instruction_counts()
    assert counts == {
        ("lane_gather", 272): dict(total=4, LDS=1, FFMA=0, local=0, loop=True),
        ("lane_gather", 16): dict(total=3, LDS=1, FFMA=0, local=1,
                                  loop=False),
    }


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
