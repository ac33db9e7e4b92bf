"""Command-line apps of the port (``python -m dir_tpu_torch.apps.<name>``)."""
