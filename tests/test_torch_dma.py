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
from tpu_amg_torch.utils import timing


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
    recs2, base, fixed = dmabench2.run(["--device", "cpu", "--reps", "1",
                                        "bulk same"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "plain version" in lines[0] and "plain version" in lines[3]
    assert [r["name"] for r in recs] == ["bulk depth= 2 unit= 4KB",
                                         "lsu depth= 2 unit= 4KB"]
    assert [r["name"] for r in recs2] == ["bulk same 16MB"]
    assert recs2[0]["bytes"] == (16 << 20) + 4096
    assert base["bytes"] == 16 << 20
    # off the card no L2 rate is measured: every bound is the data sheet's
    assert all(r["bound_rate"] == "HBM data sheet" for r in recs + recs2)
    assert fixed["bytes"] == 132 * 4096 + 4096
    assert len(lines) == 7 and lines[-1].startswith("fixed cost")
    assert all("GB/s" in line for line in lines[:-1]
               if not line.startswith("#"))


def test_l2_bound_divides_by_the_rate():
    assert timing.l2_bound_ms(8 << 20, 4000.0) == pytest.approx(
        (8 << 20) / 4000e6)
    # twice the rate, half the bound
    assert timing.l2_bound_ms(1 << 20, 8000.0) == pytest.approx(
        timing.l2_bound_ms(1 << 20, 4000.0) / 2)


def test_slope_leaves_the_fixed_cost_out():
    # 6 us of fixed cost and 4,000 GB/s: the calls' own rates are lower,
    # the slope between them is the rate
    def ms(n):
        return 6e-3 + n / 4000e6

    small, big = 16 << 20, 32 << 20
    assert timing.slope_gbps(small, ms(small), big, ms(big)) == \
        pytest.approx(4000.0)
    assert big / ms(big) / 1e6 < 3000.0
    # a bigger call that is not slower has no rate
    assert timing.slope_gbps(small, 1.0, big, 1.0) is None
    assert timing.slope_gbps(big, 1.0, small, 2.0) is None


def test_l2_read_rate_takes_the_best_slope(monkeypatch, capsys):
    # each case's time: a fixed cost and a rate of its own; the L2 rate is
    # the best rate between 16 and 32 MiB, not the best whole-call rate
    costs = {"stream_sum": (2e-3, 5000e6), "bulk": (6e-3, 7000e6),
             "lsu": (6e-3, 6000e6)}

    def record(kind, name, n):
        fixed, rate = costs[kind]
        ms = fixed + n / rate
        return dict(name=name, bytes=n, ms=ms, gbps=n / ms / 1e6)

    def dma_case(case, n, device, reps):
        return dict(record(case.engine, case.name, n), case=case)

    def stream_case(case, n, device, reps):
        return record("stream_sum", case.name, n)

    monkeypatch.setattr(dmabench, "time_case", dma_case)
    monkeypatch.setattr(dmabench.streambench, "time_case", stream_case)
    l2 = dmabench.l2_read_rate(torch.device("cpu"), 1)
    assert l2["gbps"] == pytest.approx(7000.0)
    assert l2["origin"].startswith("dma_probe bulk")
    assert "the slope from 16 to 32 MiB" in l2["origin"]
    # every engine's best copy and the single-input f32 stream cases
    # whose grid is the same at 16 and 32 MiB: rows=64's 512 and 1,024
    # tiles on 132 persistent blocks, but not the 8 and 16 tiles of
    # 64x8192, split 8 ways (64 and 128 blocks)
    assert max(l2["slopes"].values()) == l2["gbps"]
    copies = [n.split()[1] for n in l2["slopes"] if n.startswith("dma_probe")]
    assert copies == list(dma.ENGINES)
    assert "stream_sum f32 1in rows=64" in l2["slopes"]
    assert "stream_sum wide f32 1in 64x8192" not in l2["slopes"]
    wide = next(c for c in dmabench.streambench.CASES
                if c.name == "wide f32 1in 64x8192")
    assert dmabench.stream_grid(wide, 16 << 20, 132) == (8, 8)
    assert dmabench.stream_grid(wide, 32 << 20, 132) == (8, 16)
    # though stream_sum's whole call is the faster at 32 MiB
    big = 32 << 20
    assert record("stream_sum", "", big)["gbps"] > l2["call_gbps"]
    assert l2["call_gbps"] == pytest.approx(record("bulk", "", big)["gbps"])
    dmabench.print_l2(l2)
    line = capsys.readouterr().out
    assert line.startswith("# L2 read rate 7000.0 GB/s: dma_probe bulk")
    assert "lsu depth" in line and "stream_sum f32 1in rows=64" in line
    # calls that take no longer for more bytes give no rate
    for kind in costs:
        costs[kind] = (6e-3, float("inf"))
    with pytest.raises(RuntimeError, match="no L2 read rate"):
        dmabench.l2_read_rate(torch.device("cpu"), 1)


def test_l2_read_rate_times_the_sizes_in_turns(monkeypatch):
    # each candidate is timed 16, 32, 16, 32, 16, 32 MiB, and each size's
    # median counts: one slow outlier of either size moves nothing
    calls = []
    extra = iter([0.0, 0.0, 5e-3, 0.0, 0.0, 5e-3] * 8)

    def record(name, n):
        calls.append((name, n >> 20))
        ms = 6e-3 + n / 7000e6 + next(extra)
        return dict(name=name, bytes=n, ms=ms, gbps=n / ms / 1e6)

    monkeypatch.setattr(dmabench, "time_case", lambda case, n, d, r: dict(
        record(case.name, n), case=case))
    monkeypatch.setattr(dmabench.streambench, "time_case",
                        lambda case, n, d, r: record(case.name, n))
    copies = [dict(name=c.name, case=c, gbps=float(i))
              for i, c in enumerate(dmabench.sweep_cases())]
    l2 = dmabench.l2_read_rate(torch.device("cpu"), 1, copies)
    assert l2["gbps"] == pytest.approx(7000.0)
    assert all(r == pytest.approx(7000.0) for r in l2["slopes"].values())
    first = calls[0][0]
    assert [n for name, n in calls if name == first] == [16, 32] * 3


def test_library_groups_are_checked():
    # the host allocates partials and tickets for the library's groups
    class Library:
        def __init__(self, group, most):
            self.dma_group = lambda: group
            self.dma_max_groups = lambda: most

    dma.check_groups(Library(dma.GROUP, dma.MAX_GROUPS))
    with pytest.raises(RuntimeError, match="groups 16 blocks"):
        dma.check_groups(Library(16, dma.MAX_GROUPS))
    with pytest.raises(RuntimeError, match="at most 32 groups"):
        dma.check_groups(Library(dma.GROUP, 32))


def test_bound_takes_the_l2_rate_only_in_l2(monkeypatch):
    l2 = dict(gbps=4000.0, origin="stream_sum f32 1in rows=2048 at 32 MiB")
    cuda = torch.device("cuda")
    monkeypatch.setattr(dmabench, "in_l2", lambda n, d: n <= 50 << 20)
    inside = dmabench.bound(8 << 20, cuda, l2)
    assert inside["bound_ms"] == pytest.approx((8 << 20) / 4000e6)
    assert inside["hbm_bound_ms"] == pytest.approx(
        timing.hbm_bound_ms(8 << 20))
    assert inside["bound_rate"].startswith("L2 4000.0 GB/s (stream_sum")
    past = dmabench.bound(64 << 20, cuda, l2)
    assert past["bound_ms"] == past["hbm_bound_ms"]
    assert past["bound_rate"] == "HBM data sheet"
    # no rate known: the data sheet's
    assert dmabench.bound(8 << 20, cuda, None)["bound_rate"] == \
        "HBM data sheet"


@pytest.mark.parametrize("case", [c for c in dmabench2.cases()
                                  if "multi" not in c.name],
                         ids=lambda c: c.name)
def test_plain_equals_the_harness_d2_d4(case):
    # the harness's D2 and D4 at their own sizes (8 and 16 MB), through
    # the plain version the kernel is held to, against numpy's statement
    rng = np.random.default_rng(5)
    x = rng.integers(0, 16, ((case.src_mib << 20) // 512, 128)).astype(
        np.float32)
    carry = _carry()
    _, unit, rows = case.sizes(0, 132)
    got = _probe([x], carry, rows, case.touch_every, engine=case.engine,
                 depth=case.depth, unit=unit)
    want = (_d2(x, carry) if "whole" in case.name
            else _d4(x, carry, rows, case.touch_every))
    np.testing.assert_array_equal(got, want)


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
def test_kernel_matches_plain_on_card(cuda, engine, n_src, rows,
                                      touch_every, depth, unit):
    g = torch.Generator(device=cuda).manual_seed(0)
    srcs = [torch.randint(0, 16, (8192, 128), generator=g, device=cuda,
                          dtype=torch.float32) for _ in range(n_src)]
    carry = torch.full((8, 128), 3.0, device=cuda)
    before = dma.dma_probe_launches
    got = dma.dma_probe(srcs, carry, rows, touch_every, engine, depth, unit)
    again = dma.dma_probe(srcs, carry, rows, touch_every, engine, depth, unit)
    ref = dma.plain_dma_probe(srcs, carry, rows, touch_every)
    torch.cuda.synchronize()
    assert dma.dma_probe_launches == before + 2
    # the ticket is back at 0 after each call: the second is right too
    assert torch.equal(got, ref) and torch.equal(again, ref)
