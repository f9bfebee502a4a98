"""Metric readers, one module a metric, found by the metric's name in
``BENCHMARK.json``.  Each module states the metric's ``LAYER``, ``UNIT``
and ``MOVES`` (the end-to-end metric it should move; itself for an
end-to-end metric) as ``BENCHMARK.json`` has them, and its
``read(record)`` takes the number from an :class:`amgbench.run.Record`,
or returns None where the run has nothing to read: the harness then
leaves the metric out of the result line.
"""
