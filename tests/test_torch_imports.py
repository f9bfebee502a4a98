"""The port imports neither jax nor tpu_amg, and names its device."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import tpu_amg_torch
names = [m.name for m in
         pkgutil.walk_packages(tpu_amg_torch.__path__, "tpu_amg_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpu_amg"))
print(len(names), bad, " ".join(names))
"""

# modules of the structured slice, which the walk must reach
SLICE_2 = ["tpu_amg_torch.sparse.dia", "tpu_amg_torch.ops.dia",
           "tpu_amg_torch.ops.stream", "tpu_amg_torch.structured",
           "tpu_amg_torch.tools.streambench", "tpu_amg_torch.utils.timing"]
# modules of the slice of the last TPU kernels
SLICE_3 = ["tpu_amg_torch.ops.spmv_stages", "tpu_amg_torch.ops.dma",
           "tpu_amg_torch.ops.primitives", "tpu_amg_torch.tools.wellablate",
           "tpu_amg_torch.tools.dmabench", "tpu_amg_torch.tools.dmabench2",
           "tpu_amg_torch.tools.microbench_primitives"]
# the row-block sweep of K1
SLICE_4 = ["tpu_amg_torch.tools.rowblocks"]


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, check=True,
    ).stdout.split()
    assert int(out[0]) >= 20  # every module was imported
    assert out[1] == "[]"
    assert set(SLICE_2) <= set(out[2:])
    assert set(SLICE_3) <= set(out[2:])
    assert set(SLICE_4) <= set(out[2:])


def test_importing_builds_nothing():
    # kernels and the native library are built at first use, not on import
    out = subprocess.run(
        [sys.executable, "-c",
         "import tpu_amg_torch.solver, tpu_amg_torch.structured, "
         "tpu_amg_torch.tools.streambench, tpu_amg_torch.ops.spmv as s, "
         "tpu_amg_torch.ops.dia as d, tpu_amg_torch.ops.stream as t, "
         "tpu_amg_torch.ops.native as n; "
         "print(s.kernel_lib.cache_info().currsize, "
         "d.kernel_lib.cache_info().currsize, "
         "t.kernel_lib.cache_info().currsize, "
         "n.lib.cache_info().currsize)"],
        cwd=ROOT, capture_output=True, text=True, check=True,
    ).stdout.split()
    assert out == ["0", "0", "0", "0"]


def test_importing_the_probes_builds_nothing():
    # the ablation, copy and primitive kernels build at first launch too;
    # no module, the chip smoke script included, imports bench or tools/
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke, tpu_amg_torch.tools.wellablate, "
         "tpu_amg_torch.tools.dmabench2, "
         "tpu_amg_torch.tools.microbench_primitives, "
         "tpu_amg_torch.ops.spmv_stages as w, tpu_amg_torch.ops.dma as d, "
         "tpu_amg_torch.ops.primitives as g; "
         "print(w.kernel_lib.cache_info().currsize, "
         "d.kernel_lib.cache_info().currsize, "
         "g.kernel_lib.cache_info().currsize, "
         "sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'tpu_amg', 'bench', 'tools', 'well2proto')))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
    ).stdout.split()
    assert out == ["0", "0", "0", "[]"]


@pytest.mark.parametrize("cli", ["wellablate", "dmabench", "dmabench2",
                                 "microbench_primitives", "rowblocks"])
def test_probe_clis_default_to_the_card(cli):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"tpu_amg_torch.tools.{cli}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run([])


def test_cuda_config_raises_without_card():
    from tpu_amg_torch.solver import SolverConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverConfig(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverConfig()  # the default device is "cuda"
    assert SolverConfig(device="cpu").device == "cpu"


def test_no_kernel_off_cpu_and_cuda():
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.sparse.csr import CSR

    mat = spmv.CappedCSR.from_csr(CSR.from_dense(np.eye(4)), "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        spmv.spmv(mat, torch.zeros(4, dtype=torch.float64, device="meta"))
