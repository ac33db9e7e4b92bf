"""Measurement tools of the port (``python -m dir_tpu_torch.tools.<name>``),
the counterparts of the JAX package's ``tools/`` of the same names."""
