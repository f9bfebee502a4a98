"""The stream-bandwidth probe ``stream_sum`` (tpu_amg_torch.ops.stream)
and its command line (tpu_amg_torch.tools.streambench).

The JAX bodies (tools/streambench.py ``run_case.kernel``,
``run_wide.kernel``) are closures inside timing harnesses and cannot be
called alone, so the plain version is held against a numpy statement of
the same sums, in both layouts, for float32 and int8 (inputs are
integers 0-99, so every sum is exact).  The CUDA cases run the kernel
itself and skip without a card.
"""

import numpy as np
import pytest
import torch

from tpu_amg_torch.ops import stream
from tpu_amg_torch.tools import streambench

DTYPES = {"f32": (torch.float32, np.float32), "int8": (torch.int8, np.int8)}


def _numpy_case(arrs, carry):
    """run_case: arrays (tiles, rows, 128); out[t] = carry + Σ_i Σ_k
    arr_i[t, 8k:8k+8, :]."""
    tiles, rows, _ = arrs[0].shape
    out = np.repeat(carry[None].astype(np.float64), tiles, 0)
    for a in arrs:
        for t in range(tiles):
            for k in range(0, rows, 8):
                out[t] += a[t, k:k + 8, :]
    return out


def _numpy_wide(arrs, carry, width):
    """run_wide: arrays (sub, tiles·width); out[t] = carry + Σ_i Σ_s Σ_k
    arr_i[s:s+8, t·width + k : t·width + k + 128]."""
    sub, total = arrs[0].shape
    tiles = total // width
    out = np.repeat(carry[None].astype(np.float64), tiles, 0)
    for a in arrs:
        for t in range(tiles):
            for s in range(0, sub, 8):
                for k in range(0, width, 128):
                    c0 = t * width + k
                    out[t] += a[s:s + 8, c0:c0 + 128]
    return out


def _arrays(shape, n_in, np_dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, shape).astype(np_dtype) for _ in range(n_in)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tiles,rows,n_in", [(3, 16, 1), (2, 64, 7), (1, 8, 2)])
def test_plain_case_layout(tiles, rows, n_in, dtype):
    t_dtype, np_dtype = DTYPES[dtype]
    arrs = _arrays((tiles, rows, 128), n_in, np_dtype)
    carry = np.random.default_rng(1).integers(0, 9, (8, 128)).astype(np.float32)
    got = stream.stream_sum(
        [torch.from_numpy(a) for a in arrs],
        torch.from_numpy(carry))
    assert got.shape == (tiles, 8, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _numpy_case(arrs, carry))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tiles,sub,width,n_in",
                         [(3, 8, 256, 1), (2, 32, 512, 1), (4, 16, 128, 7)])
def test_plain_wide_layout(tiles, sub, width, n_in, dtype):
    t_dtype, np_dtype = DTYPES[dtype]
    arrs = _arrays((sub, tiles * width), n_in, np_dtype, seed=2)
    carry = np.zeros((8, 128), np.float32)
    views = [stream.wide_layout(torch.from_numpy(a), width) for a in arrs]
    assert views[0].shape == (tiles, sub, width)
    got = stream.stream_sum(views, torch.from_numpy(carry))
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_wide(arrs, carry, width))


def test_rejects_bad_input():
    carry = torch.zeros(8, 128)
    with pytest.raises(ValueError):  # rows not a multiple of 8
        stream.stream_sum([torch.zeros(2, 12, 128)], carry)
    with pytest.raises(ValueError):  # width not a multiple of 128
        stream.stream_sum([torch.zeros(2, 8, 100)], carry)
    with pytest.raises(ValueError):  # inputs of different shapes
        stream.stream_sum([torch.zeros(2, 8, 128), torch.zeros(3, 8, 128)],
                          carry)
    with pytest.raises(ValueError):  # too many inputs
        stream.stream_sum([torch.zeros(1, 8, 128)] * 9, carry)
    with pytest.raises(TypeError):
        stream.stream_sum([torch.zeros(1, 8, 128, dtype=torch.float64)], carry)
    with pytest.raises(ValueError):
        stream.stream_sum([torch.zeros(1, 8, 128)], torch.zeros(8, 64))
    with pytest.raises(RuntimeError, match="no kernel"):
        stream.stream_sum([torch.zeros(1, 8, 128, device="meta")],
                          torch.zeros(8, 128, device="meta"))


def test_plain_version_does_not_count_launches():
    before = stream.stream_sum_launches
    stream.stream_sum([torch.ones(2, 8, 128)], torch.zeros(8, 128))
    assert stream.stream_sum_launches == before


def test_case_list_matches_the_harness():
    # tools/streambench.py:154-179: 8 stacked and 6 wide cases, of which
    # "+cost" (an XLA cost hint on the case before it) is left out
    assert [c.layout for c in streambench.CASES] == ["case"] * 8 + ["wide"] * 5
    assert not any("+cost" in c.name for c in streambench.CASES)
    f32_512 = streambench.CASES[0]
    assert f32_512.tile_bytes == 512 * 128 * 4
    assert f32_512.tiles(streambench.TOTAL_MIB << 20) == 128
    wide_int8 = next(c for c in streambench.CASES if c.name.startswith("wide int8"))
    assert wide_int8.tiles(32 << 20) == 128


def test_cli_on_cpu(capsys):
    assert streambench.main(["--device", "cpu", "--total-mib", "1",
                             "--reps", "1", "1in rows=64", "8x4096"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "plain version" in lines[0]
    assert len(lines) == 3 and all("GB/s" in line for line in lines[1:])


def _walk(n_in, chunks, groups):
    """The (input, chunk) pairs a block of the kernel reads of a tile:
    items f (chunk-major: input f % n_in of chunk f // n_in), step s of
    thread group g taking items s·U·groups + g + u·groups, u < U, until
    the tile's items are done."""
    n = n_in * chunks
    step = stream.UNROLL * groups
    steps = max(1, -(-n // step))
    return [(f % n_in, f // n_in)
            for s in range(steps) for g in range(groups)
            for f in range(s * step + g, (s + 1) * step, groups) if f < n]


@pytest.mark.parametrize("total_mib", [32, 1024])
@pytest.mark.parametrize("name", [c.name for c in streambench.CASES])
def test_launch_plan_covers_every_chunk(name, total_mib):
    case = next(c for c in streambench.CASES if c.name == name)
    tiles = case.tiles(total_mib << 20)
    size = torch.tensor([], dtype=case.dtype).element_size()
    args = (tiles, case.rows, case.width, size, case.n_in, 132)
    parts, blocks = stream.launch_plan(*args)
    assert (parts, blocks) == stream.launch_plan(*args)
    # one block an SM at most; a tile shared by 1, 2, 4 or 8 blocks
    assert parts * blocks <= 132
    assert parts in (1, 2, 4, 8)
    # every tile taken by exactly one row of blocks (persistent rows walk
    # tiles b, b + blocks, ...); a shared tile has a row of its own
    rows_of = [t for b in range(blocks) for t in range(b, tiles,
                                                            blocks)]
    assert sorted(rows_of) == list(range(tiles))
    assert parts == 1 or blocks == tiles
    # each block of a tile owns 8 / parts rows of its (8, 128) sum, and
    # reads them from every chunk of every input exactly once
    owned = sorted(p * (8 // parts) + r for p in range(parts)
                   for r in range(8 // parts))
    assert owned == list(range(8))
    chunks = (case.rows // 8) * (case.width // 128)
    groups = stream.step_chunks(size, parts)
    seen = sorted(_walk(case.n_in, chunks, groups))
    assert seen == [(i, q) for i in range(case.n_in) for q in range(chunks)]
    # the grid fills the card where the tiles allow; a shared tile gives
    # each of its blocks a full step of loads
    assert parts == 1 or case.n_in * chunks >= stream.UNROLL * groups
    assert (parts * blocks >= min(132, tiles)
            and (parts == stream.MAX_PARTS
                 or 2 * parts * tiles > 132 or parts == 1
                 or case.n_in * chunks
                 < stream.UNROLL * stream.step_chunks(size, 2 * parts)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("total_mib", [4, 64])
@pytest.mark.parametrize("name", [c.name for c in streambench.CASES])
def test_kernel_matches_plain_on_card(cuda, name, total_mib):
    case = next(c for c in streambench.CASES if c.name == name)
    g = torch.Generator(device=cuda).manual_seed(0)
    inputs = streambench.make_inputs(case, total_mib << 20, cuda, g)
    carry = torch.full((8, 128), 3.0, device=cuda)
    before = stream.stream_sum_launches
    got = stream.stream_sum(inputs, carry)
    again = stream.stream_sum(inputs, carry)
    ref = stream.plain_stream_sum(inputs, carry)
    torch.cuda.synchronize()
    assert stream.stream_sum_launches == before + 2
    assert torch.equal(got, ref)
    assert torch.equal(got, again)
