"""The visualization export, the viewer client, the CLI's ``--viz-out``
and the aggregation tool, against the JAX package.

``hierarchy_viz`` runs on one hierarchy built by tpu_amg and carried to
the port by the checkpoint loader: the JSON text must be equal.  Both
``VizClient``s post to one stdlib HTTP server on 127.0.0.1 in a thread:
the requests must be equal.  The aggregation tool's partition and
metrics log (after every fifth pass) are held against the JAX example's
callback loop on one basis: partitions exactly, metrics to 1e-12
(relative); the l1 smoothing of one start block agrees to 1e-12.
Float64 on the CPU.
"""

import dataclasses
import http.server
import json
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_amg.adaptivity import _smooth_loop as jax_smooth_loop
from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.hierarchy import create_weights as jax_create_weights
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.preconditioners import build_smoother as jax_build_smoother
from tpu_amg.utils import problems as jax_problems
from tpu_amg.utils import viz as jax_viz
from tpu_amg.utils.checkpoint import _pack_hierarchy
from tpu_amg_torch.tools import aggregation
from tpu_amg_torch.tools import amg as amg_cli
from tpu_amg_torch.utils import problems, viz
from tpu_amg_torch.utils.checkpoint import hierarchy_from_arrays

METRIC_RTOL = 1e-12
SMOOTH_RTOL = 1e-12


@pytest.fixture(scope="module")
def hierarchies():
    """(JAX hierarchy, the port's from its checkpoint arrays)."""
    a = jax_problems.anisotropic_diffusion_2d(24)
    rng = np.random.default_rng(0)
    nn, _ = np.linalg.qr(np.concatenate(
        [np.ones((a.nrows, 1)), rng.standard_normal((a.nrows, 3))], 1))
    ref = JaxHierarchyConfig(
        coarsest_dim=30,
        interpolation_config=JaxInterpolationConfig(
            kind="aggregation",
            aggregation=JaxAggregationConfig(
                candidate_dimension=2,
                partitioner_config=JaxPartitionerConfig(coarsening_factor=8.0),
            ),
        ),
    ).build(a, nn)
    arrays = {}
    meta = _pack_hierarchy(ref, arrays)
    got = hierarchy_from_arrays(arrays, json.loads(json.dumps(meta)))
    assert ref.num_levels >= 3
    return ref, got


@pytest.mark.parametrize("coords", [False, True])
def test_hierarchy_viz_json_matches_jax(hierarchies, coords):
    ref, got = hierarchies
    xy = (np.random.default_rng(1).random((ref.matrices[0].nrows, 2))
          if coords else None)
    text = viz.hierarchy_viz(got, xy).to_json()
    assert text == jax_viz.hierarchy_viz(ref, xy).to_json()
    payload = json.loads(text)
    assert len(payload["levels"]) == got.num_levels - 1


def test_dump_hierarchy_viz_matches_jax(hierarchies, tmp_path):
    ref, got = hierarchies
    viz.dump_hierarchy_viz(got, tmp_path / "a" / "viz.json")
    jax_viz.dump_hierarchy_viz(ref, tmp_path / "b" / "viz.json")
    assert ((tmp_path / "a" / "viz.json").read_text()
            == (tmp_path / "b" / "viz.json").read_text())


def test_partition_metrics_matches_jax():
    m = viz.PartitionMetrics(iteration=5, size_cost=1.5, edge_cost=2.25,
                             modularity=0.5)
    ref = jax_viz.PartitionMetrics(iteration=5, size_cost=1.5,
                                   edge_cost=2.25, modularity=0.5)
    assert m.to_dict() == ref.to_dict()


# ---- the CLI's --viz-out (the port's CLI, in this process)

VIZ_CASES = {
    "sa": ["--n", "16", "--coarsest-dim", "40", "--coarsening-near-null-dim",
           "16", "--smoothing-iters", "10"],
    "classical": ["--problem", "poisson2d", "--interpolation", "classical",
                  "--n", "16", "--coarsest-dim", "100", "--smoother",
                  "chebyshev"],
}


@pytest.mark.parametrize("case", list(VIZ_CASES))
def test_amg_cli_viz_out(case, tmp_path, capsys, hierarchies):
    out = tmp_path / "sub" / "viz.json"
    amg_cli.main(["--device", "cpu", "--skip-sli", "--skip-enorm",
                  "--max-iters", "200", "--viz-out", str(out),
                  *VIZ_CASES[case]])
    err = capsys.readouterr().err
    num_levels = int(err.split("Hierarchy(levels=")[1].split(",")[0])
    payload = json.loads(out.read_text())
    assert payload["coords"] is None
    levels = payload["levels"]
    assert len(levels) == num_levels - 1 >= 1
    ref_keys = set(jax_viz.hierarchy_viz(hierarchies[0]).levels[0])
    for i, lv in enumerate(levels):
        assert set(lv) == ref_keys
        assert lv["level"] == i
        assert len(lv["node_to_agg"]) == lv["dims"][0]
        assert len(lv["near_null_first"]) == lv["dims"][0]
        assert max(lv["node_to_agg"]) + 1 == lv["num_aggs"]
        assert lv["kind"] == ("classical" if case == "classical"
                              else "aggregation")
    assert levels[0]["dims"][0] == 256


# ---- the viewer client


class _Recorder(http.server.BaseHTTPRequestHandler):
    log = None  # set per server

    def _reply(self):
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        self.log.append(("GET", self.path, None))
        self._reply()

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.log.append(("POST", self.path, self.headers["Content-Type"],
                         json.loads(body)))
        self._reply()

    def log_message(self, *args):
        pass


@pytest.fixture
def server():
    log = []
    handler = type("Handler", (_Recorder,), {"log": log})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", log
    srv.shutdown()
    srv.server_close()
    thread.join(5)


@dataclasses.dataclass
class _System:
    coords: np.ndarray
    mesh_geometry: object = None


def _drive(client):
    rng = np.random.default_rng(2)
    coords = rng.random((6, 2))
    oks = [
        client.health_check(),
        client.upload_mesh(coords, np.array([[0, 1, 2], [3, 4, 5]])),
        client.upload_mesh(coords),
        client.upload_system_mesh(_System(coords=coords)),
        client.update_partition(np.array([0, 0, 1, 1, 2, 2])),
        client.update_function(rng.standard_normal(6)),
        client.update_metrics(viz.PartitionMetrics(3, 1.0, 2.0, 0.25)),
    ]
    return oks


def test_viz_client_posts_what_jax_posts(server):
    url, log = server
    got = _drive(viz.VizClient(url))
    got_log = list(log)
    log.clear()
    ref = _drive(jax_viz.VizClient(url))
    assert got == ref == [True] * 7
    assert got_log == log and len(log) == 7
    assert [r[1] for r in log] == ["/health", "/mesh", "/mesh", "/mesh",
                                   "/partition", "/function", "/metrics"]


def test_viz_client_without_server():
    with socket.socket() as s:  # a port with nothing listening
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    client, ref = viz.VizClient(url), jax_viz.VizClient(url)
    assert client.health_check() is False and ref.health_check() is False
    assert client.update_partition([0, 1]) is False


# ---- the aggregation tool


@pytest.fixture(scope="module")
def aniso():
    a, ref_a = (problems.anisotropic_diffusion_2d(24),
                jax_problems.anisotropic_diffusion_2d(24))
    np.testing.assert_array_equal(a.data, ref_a.data)
    return a, ref_a


def test_aggregation_smoothing_matches_jax(aniso):
    a, ref_a = aniso
    start = np.random.default_rng(4).standard_normal((a.nrows, 4))
    basis, cfs = aggregation.smoothed_basis(a, torch.from_numpy(start), 10)
    op = jax_aslinearoperator(ref_a)
    ref_basis, ref_cfs = jax_smooth_loop(
        op, jax_build_smoother("l1", op.ell), jnp.asarray(start), 10)
    np.testing.assert_allclose(basis, np.asarray(ref_basis),
                               rtol=0, atol=SMOOTH_RTOL)
    np.testing.assert_allclose(cfs, np.asarray(ref_cfs), rtol=SMOOTH_RTOL)


@pytest.mark.parametrize("viz_every", [1, 5])
def test_aggregation_matches_jax_callback_loop(aniso, viz_every):
    a, ref_a = aniso
    rng = np.random.default_rng(5)
    basis, _ = np.linalg.qr(np.concatenate(
        [np.ones((a.nrows, 1)), rng.standard_normal((a.nrows, 3))], 1))
    cfs = rng.random(4)
    lines = []
    got = aggregation.aggregate(a, basis, cfs, 8.0, 200, viz_every,
                                log=lines.append)
    # the JAX example's callback loop (examples/aggregation.py:73-105)
    ref_log = []

    def callback(iteration, partitioner):
        if iteration % viz_every:
            return
        ref_log.append(jax_viz.PartitionMetrics(
            iteration=iteration,
            size_cost=partitioner.total_agg_size_cost(),
            edge_cost=partitioner.total_edge_cost(),
            modularity=partitioner.modularity(),
        ).to_dict())

    ref_part = JaxPartitionerConfig(
        coarsening_factor=8.0, max_improvement_iters=200,
        callback=callback,
    ).build(ref_a, basis, jax_create_weights(ref_a, basis)).partition
    assert set(got) == {"node_to_agg", "stats", "metrics",
                        "convergence_factors"}
    assert got["node_to_agg"] == ref_part.node_to_agg.tolist()
    assert got["stats"] == dataclasses.asdict(ref_part.info())
    assert got["convergence_factors"] == cfs.tolist()
    assert ([m["iteration"] for m in got["metrics"]]
            == [m["iteration"] for m in ref_log])
    assert len(ref_log) > 1
    for m, r in zip(got["metrics"], ref_log):
        assert set(m) == set(r)
        for key in ("size_cost", "edge_cost", "modularity"):
            assert m[key] == pytest.approx(r[key], rel=METRIC_RTOL)
    assert lines[-1].startswith("final: ")
    json.dumps(got)


def test_aggregation_cli(tmp_path, capsys):
    out = tmp_path / "agg.json"
    payload = aggregation.run(["--device", "cpu", "--n", "16", "--out",
                               str(out), "--smoothing-iters", "5"])
    assert json.loads(out.read_text()) == payload
    assert len(payload["node_to_agg"]) == 256
    assert len(payload["convergence_factors"]) == 8
    mods = [m["modularity"] for m in payload["metrics"]]
    assert mods and mods[-1] >= mods[0]
    assert f"wrote {out}" in capsys.readouterr().out
