"""Multi-process rehearsal on the CPU: the port of tests/test_multihost.py.

Four gloo ranks (``tests/torch_multihost_worker.py``, started once by
``parallel.multihost.launch``, with its own time limit) play 2 nodes of
2 ranks: the pod mesh orders them so that row-block neighbours share a
node, and the halo PCG on that order reproduces the single-process
solution on every rank.  The same ranks then run the multi-rank dry run
(``tools.dryrun_multichip``) at 4 and at 2 ranks, where every phase
must pass its gate (2e-6 in float32, 1e-12 in float64) and the block-3
phase must run on a halo fine level; a system the 4 ranks do not divide
is padded with identity rows and solved as on one rank.  A rank that
fails fails its launch.
"""

import re

import pytest

from tpu_amg_torch.ops import native
from tpu_amg_torch.parallel.multihost import launch

PHASES = ("dryrun 2-D grid", "dryrun_multichip OK", "dryrun block-3 "
          "elasticity OK", "dryrun f64 near-singular OK")


@pytest.fixture(scope="module")
def outputs():
    native.lib()  # built here once, not by every rank at its first use
    return launch("tests.torch_multihost_worker", [], 4, timeout=300)


@pytest.mark.parametrize("rank", range(4))
def test_pod_mesh_halo_pcg(outputs, rank):
    line = next(ln for ln in outputs[rank].splitlines()
                if ln.startswith(f"MULTIHOST p{rank}:"))
    assert "converged=True" in line and "HaloCSR" in line
    assert f"row block {[0, 2, 1, 3].index(rank)} " in line


@pytest.mark.parametrize("width", (4, 2))
@pytest.mark.parametrize("phase", PHASES)
def test_dryrun_multichip(outputs, width, phase):
    lines = [ln for ln in outputs[0].splitlines()
             if ln.startswith(f"[{width}] {phase}")]
    assert len(lines) == 1, outputs[0][-3000:]
    if phase != PHASES[0]:
        assert "fine=HaloCSR" in lines[0]
        err = float(re.search(r"rel err ([0-9.e+-]+)", lines[0]).group(1))
        assert err < (1e-12 if "f64" in phase else 2e-6)


def test_padded_system(outputs):
    line = next(ln for ln in outputs[0].splitlines()
                if ln.startswith("PADDED p0:"))
    err = float(re.search(r"rel err ([0-9.e+-]+)", line).group(1))
    assert "n=225 over 4 ranks" in line and err < 1e-12


def test_a_failed_rank_fails_the_launch():
    """A rank that fails stops the ranks waiting on it and fails the
    launch, which names it."""
    with pytest.raises(RuntimeError, match=r"of 2 failed \(rank 1: exit 1\)"
                       r"[\s\S]*fails on purpose"):
        launch("tests.torch_multihost_worker", ["fail-rank", "1"], 2,
               timeout=120)
