"""Command-line entry points of the port (``python -m tpu_amg_torch.tools.<name>``):
the CLI examples (``amg``, ``simple_geometric``), the FEM fixture writer
and the device probes."""
