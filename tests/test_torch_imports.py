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
             if m.split(".")[0] in ("jax", "jaxlib", "tpu_amg", "bench"))
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
# the CLI path: the stationary solve, the CUDA-graph step, the harness,
# I/O, reordering, stats, the families and the CLIs
SLICE_7 = ["tpu_amg_torch.errors", "tpu_amg_torch.solvers.stationary",
           "tpu_amg_torch.solvers.graph", "tpu_amg_torch.utils.reorder",
           "tpu_amg_torch.utils.stats", "tpu_amg_torch.utils.testing",
           "tpu_amg_torch.utils.io", "tpu_amg_torch.utils.geometric",
           "tpu_amg_torch.models", "tpu_amg_torch.models.families",
           "tpu_amg_torch.tools.amg", "tpu_amg_torch.tools.simple_geometric",
           "tpu_amg_torch.tools.make_fem_fixture"]
# the adaptive composite, rand-SVD and the multilevel partitioner
SLICE_8 = ["tpu_amg_torch.preconditioners.composite",
           "tpu_amg_torch.partition.multilevel",
           "tpu_amg_torch.decompositions",
           "tpu_amg_torch.decompositions.rand_svd",
           "tpu_amg_torch.tools.rand_svd_test"]
# the mixed-precision cycle
SLICE_10 = ["tpu_amg_torch.precision"]
# the setup slice and block-3 elasticity: the profiler, the setup and
# solve tools, the elasticity bench
SLICE_11 = ["tpu_amg_torch.utils.profiling",
            "tpu_amg_torch.tools.profile_setup",
            "tpu_amg_torch.tools.setup3d", "tpu_amg_torch.tools.solve3d",
            "tpu_amg_torch.tools.bench_elasticity",
            "tpu_amg_torch.tools.bootstrap_study"]
# classical AMG and the banded coarse solve
SLICE_12 = ["tpu_amg_torch.interpolation.classical",
            "tpu_amg_torch.preconditioners.coarse",
            "tpu_amg_torch.preconditioners.block_smoother",
            "tpu_amg_torch.partition.strength"]

# distribution over torch.distributed: the shard primitives, the halo
# operators, sharding, the process scaffolding, the dry run and the
# weak-scaling harness
SLICE_13 = ["tpu_amg_torch.shard_utils", "tpu_amg_torch.parallel",
            "tpu_amg_torch.parallel.dist", "tpu_amg_torch.parallel.halo",
            "tpu_amg_torch.parallel.multihost",
            "tpu_amg_torch.tools.dryrun_multichip",
            "tpu_amg_torch.tools.bench_scaling"]

# the rest of M21: the viz export, the aggregation tool, the V-cycle
# breakdown and the two V-cycle benches
SLICE_14 = ["tpu_amg_torch.utils.viz", "tpu_amg_torch.tools.aggregation",
            "tpu_amg_torch.tools.vcycle_breakdown",
            "tpu_amg_torch.tools.bench_vcycle",
            "tpu_amg_torch.tools.bench_unstructured"]

# the rest of the sparse package and its distributed names: the ELL and
# BSR containers (through K1 + K2)
SLICE_17 = ["tpu_amg_torch.sparse.ell", "tpu_amg_torch.sparse.bsr",
            "tpu_amg_torch.sparse.ops"]

# the SpMV throughput benchmark, the port of the root bench.py
SLICE_18 = ["tpu_amg_torch.tools.bench"]


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
    assert set(SLICE_7) <= set(out[2:])
    assert set(SLICE_8) <= set(out[2:])
    assert set(SLICE_10) <= set(out[2:])
    assert set(SLICE_11) <= set(out[2:])
    assert set(SLICE_12) <= set(out[2:])
    assert set(SLICE_13) <= set(out[2:])
    assert set(SLICE_14) <= set(out[2:])
    assert set(SLICE_17) <= set(out[2:])
    assert set(SLICE_18) <= set(out[2:])


@pytest.mark.parametrize("package", ["sparse", "parallel"])
def test_public_names_hold_the_jax_packages(package):
    """``tpu_amg_torch.sparse.__all__`` and ``.parallel.__all__`` hold
    every name the JAX package exports there."""
    import importlib

    jax_names = importlib.import_module(f"tpu_amg.{package}").__all__
    port = importlib.import_module(f"tpu_amg_torch.{package}")
    assert set(jax_names) <= set(port.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


def test_importing_builds_nothing():
    # kernels and the native library are built at first use, not on import
    out = subprocess.run(
        [sys.executable, "-c",
         "import tpu_amg_torch.solver, tpu_amg_torch.structured, "
         "tpu_amg_torch.tools.streambench, tpu_amg_torch.tools.amg, "
         "tpu_amg_torch.tools.simple_geometric, tpu_amg_torch.models, "
         "tpu_amg_torch.solvers.graph, tpu_amg_torch.ops.spmv as s, "
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


@pytest.mark.parametrize("tool", ["dryrun_multichip", "bench_scaling"])
def test_distributed_tools_default_to_the_card(tool):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"tpu_amg_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


@pytest.mark.parametrize("tool,argv", [
    ("aggregation", []), ("bench_vcycle", []), ("bench_unstructured", []),
    ("vcycle_breakdown", ["--ckpt", "none.npz"]),
])
def test_slice14_tools_default_to_the_card(tool, argv):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"tpu_amg_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


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
