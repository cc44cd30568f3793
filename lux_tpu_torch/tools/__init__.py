"""Command-line tools of the port: python -m lux_tpu_torch.tools.<name>."""
