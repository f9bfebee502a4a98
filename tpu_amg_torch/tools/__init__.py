"""Command-line probes of the device (``python -m tpu_amg_torch.tools.<name>``)."""
