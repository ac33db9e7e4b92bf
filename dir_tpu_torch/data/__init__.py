"""Data pipeline of the port: the host dataset and loader, the packed
sample cache, the synthetic split writer, and the on-device pipeline."""
