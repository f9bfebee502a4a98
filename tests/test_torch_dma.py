"""The copy-engine probe ``dma_probe`` (tpu_amg_torch.ops.dma) and its
command lines (tpu_amg_torch.tools.dmabench, dmabench2).

The JAX bodies (tools/dmabench.py ``run_case.kernel``, dmabench2.py
``k_whole``, ``k_multi``, ``k_same``) are closures inside timing loops
and cannot be called alone, so the plain version is held against a
numpy statement of what each computes: the carry plus the first 8 rows
of each chunk it touches.  Inputs are integers, so every sum is exact.
The CUDA cases run the kernel with both engines and skip without a card.
"""

import numpy as np
import pytest
import torch

from tpu_amg_torch.ops import dma
from tpu_amg_torch.tools import dmabench, dmabench2


def _sources(n_src, rows, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 16, (rows, 128)).astype(np.float32)
            for _ in range(n_src)]


def _d1(x, carry, rows, touch):
    """dmabench.run_case: fori over chunks, acc += buf[slot, :8]."""
    acc = carry.astype(np.float64).copy()
    if touch:
        for i in range(x.shape[0] // rows):
            acc += x[i * rows:i * rows + 8]
    return acc


def _d2(x, carry):
    """k_whole: acc += x[512 i : 512 i + 8] for i < rows // 512."""
    acc = carry.astype(np.float64).copy()
    for i in range(x.shape[0] // 512):
        acc += x[i * 512:i * 512 + 8]
    return acc


def _d3(xs, carry, chunk):
    """k_multi: chunk i of every source in flight; bufs[0] is source 0's."""
    acc = carry.astype(np.float64).copy()
    for i in range(xs[0].shape[0] // chunk):
        acc += xs[0][i * chunk:i * chunk + 8]
    return acc


def _d4(x, carry, chunk, k):
    """k_same: chunks i·K .. i·K + K - 1 in flight; bufs[0] is chunk i·K."""
    acc = carry.astype(np.float64).copy()
    for i in range(x.shape[0] // chunk // k):
        acc += x[i * k * chunk:i * k * chunk + 8]
    return acc


def _carry(seed=1):
    return np.random.default_rng(seed).integers(0, 9, (8, 128)).astype(
        np.float32)


def _probe(xs, carry, rows, touch_every=1, **kw):
    return dma.dma_probe([torch.from_numpy(x) for x in xs],
                         torch.from_numpy(carry), rows, touch_every,
                         **kw).numpy()


@pytest.mark.parametrize("rows,touch", [(8, True), (64, True), (64, False),
                                        (512, True)])
def test_plain_d1(rows, touch):
    x, = _sources(1, 1024)
    carry = _carry()
    got = _probe([x], carry, rows, 1 if touch else 0)
    np.testing.assert_array_equal(got, _d1(x, carry, rows, touch))


def test_plain_d2():
    x, = _sources(1, 4096, seed=2)
    carry = _carry()
    np.testing.assert_array_equal(_probe([x], carry, 512), _d2(x, carry))


def test_plain_d3():
    xs = _sources(4, 2048, seed=3)
    carry = _carry()
    np.testing.assert_array_equal(_probe(xs, carry, 256), _d3(xs, carry, 256))


def test_plain_d4():
    x, = _sources(1, 2048, seed=4)
    carry = _carry()
    np.testing.assert_array_equal(_probe([x], carry, 128, 4),
                                  _d4(x, carry, 128, 4))


def test_rejects_bad_input():
    x = torch.zeros(1024, 128)
    carry = torch.zeros(8, 128)
    with pytest.raises(ValueError):  # chunk rows not a multiple of 8
        dma.dma_probe([x], carry, 12)
    with pytest.raises(ValueError):  # chunk rows do not divide the rows
        dma.dma_probe([x], carry, 48)
    with pytest.raises(ValueError):  # not 128 wide
        dma.dma_probe([torch.zeros(1024, 64)], carry, 8)
    with pytest.raises(ValueError):  # sources of different shapes
        dma.dma_probe([x, torch.zeros(512, 128)], carry, 8)
    with pytest.raises(ValueError):  # unknown engine
        dma.dma_probe([x], carry, 8, engine="tma")
    with pytest.raises(ValueError):  # depth x unit past a block's memory
        dma.dma_probe([x], carry, 8, depth=16, unit=64 << 10)
    with pytest.raises(ValueError):  # unit not a multiple of 4 KB
        dma.dma_probe([x], carry, 8, unit=6000)
    with pytest.raises(RuntimeError, match="no kernel"):
        dma.dma_probe([x.to("meta")], carry.to("meta"), 8)


def test_plain_version_does_not_count_launches():
    before = dma.dma_probe_launches
    dma.dma_probe([torch.ones(64, 128)], torch.zeros(8, 128), 8)
    assert dma.dma_probe_launches == before


def test_sweep_fits_a_block():
    cases = dmabench.sweep_cases()
    assert len(cases) == 20  # 10 (depth, unit) pairs under 227 KB, 2 engines
    assert all(c.depth * c.unit <= dma.MAX_RING_BYTES for c in cases)
    # D2's unit: 8 MB over 132 SMs, rounded up to 4 KB
    assert dma.whole_share_unit(8 << 20, 132) == 64 << 10
    assert len(dmabench2.cases()) == 6


def test_cli_on_cpu(capsys):
    recs = dmabench.run(["--device", "cpu", "--total-mib", "1", "--reps", "1",
                         "depth= 2 unit= 4KB"])
    recs2, base = dmabench2.run(["--device", "cpu", "--reps", "1",
                                 "bulk same"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "plain version" in lines[0] and "plain version" in lines[3]
    assert [r["name"] for r in recs] == ["bulk depth= 2 unit= 4KB",
                                         "lsu depth= 2 unit= 4KB"]
    assert [r["name"] for r in recs2] == ["bulk same 16MB"]
    assert recs2[0]["bytes"] == (16 << 20) + 4096
    assert base["bytes"] == 16 << 20
    assert len(lines) == 6
    assert all("GB/s" in line for line in lines if not line.startswith("#"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", dma.ENGINES)
@pytest.mark.parametrize("n_src,rows,touch_every,depth,unit", [
    (1, 8, 1, 2, 4096), (1, 128, 0, 4, 16384), (1, 512, 1, 1, 65536),
    (4, 2048, 1, 4, 32768), (1, 2048, 4, 4, 32768), (3, 64, 1, 16, 8192),
])
def test_kernel_matches_plain_on_card(cuda, engine, n_src, rows, touch_every,
                                      depth, unit):
    g = torch.Generator(device=cuda).manual_seed(0)
    srcs = [torch.randint(0, 16, (8192, 128), generator=g, device=cuda,
                          dtype=torch.float32) for _ in range(n_src)]
    carry = torch.full((8, 128), 3.0, device=cuda)
    before = dma.dma_probe_launches
    got = dma.dma_probe(srcs, carry, rows, touch_every, engine, depth, unit)
    ref = dma.plain_dma_probe(srcs, carry, rows, touch_every)
    torch.cuda.synchronize()
    assert dma.dma_probe_launches == before + 1
    assert torch.equal(got, ref)
