"""Training-side code of the port (so far: the evaluation metrics)."""
