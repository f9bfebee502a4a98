"""The setup profiler: ``utils/profiling.py`` against the JAX package's,
and ``tools.profile_setup`` on the CPU at a tiny size; on the card
(``cuda``), ``Timer`` and ``trace`` on CUDA work."""

import json
import logging
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_amg_torch.utils import profiling

try:  # the reference: absent where only the card's tests run
    from tpu_amg.utils import profiling as jax_profiling
except ImportError:
    jax_profiling = None

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("nnz,nrows,seconds,dtype_bytes", [
    (7_339_948, 1_048_576, 3.355e-5, 4),
    (1_809_806, 110_592, 9.76e-6, 8),
    (71_100, 1_536, 1e-3, 2),
])
def test_spmv_metrics_match_jax(nnz, nrows, seconds, dtype_bytes):
    if jax_profiling is None:
        pytest.skip("the JAX package (the reference) is not installed")
    got = profiling.spmv_metrics(nnz, nrows, seconds, dtype_bytes)
    want = jax_profiling.spmv_metrics(nnz, nrows, seconds, dtype_bytes)
    assert got == want


def test_timer_logs_its_label(caplog):
    with caplog.at_level(logging.INFO, logger="tpu_amg_torch.utils.profiling"):
        with profiling.Timer("bootstrap span", device="cpu") as t:
            torch.ones(8).sum()
    assert t.elapsed >= 0.0
    (rec,) = [r for r in caplog.records if "bootstrap span" in r.getMessage()]
    assert rec.levelno == logging.INFO
    assert rec.getMessage() == f"bootstrap span: {t.elapsed:.3f}s"


def test_timer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.Timer("span", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace("unused", device="cuda"):
            pass


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path, name="spmv_span", device="cpu"):
        (torch.ones(64, 64) @ torch.ones(64)).sum()
    path = tmp_path / "spmv_span.pt.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "spmv_span" for e in events)


def test_trace_is_a_noop_without_a_dir(tmp_path):
    with profiling.trace(None):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_profile_setup_cli():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_amg_torch.tools.profile_setup",
         "--side", "16", "--device", "cpu", "--top", "5"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    assert "Ordered by: cumulative time" in out.stdout
    assert "Ordered by: internal time" in out.stdout
    phases = out.stdout.strip().splitlines()[-1]
    assert phases.startswith("# setup phases: near_null ")
    assert "hierarchy " in phases and "multigrid " in phases
    assert "# system n=256" in out.stderr


@pytest.mark.cuda
def test_timer_and_trace_on_the_card(tmp_path):
    """On a CUDA device the span holds the work it enqueued, and the
    trace holds the card's kernels (CUPTI), the span's name beside."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(4096, 4096, device="cuda", dtype=torch.float64)
    with profiling.Timer("matmul", device="cuda") as t:
        y = x @ x
    assert t.elapsed > 0.0 and float(y[0, 0]) == 4096.0
    with profiling.trace(tmp_path, name="card_span", device="cuda"):
        (x @ x).sum()
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "card_span.pt.trace.json").read_text()
                        )["traceEvents"]
    assert any(e.get("name") == "card_span" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
