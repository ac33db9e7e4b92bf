"""Training-side code of the port: losses live in ``models/losses.py``;
here the train state, the steps, checkpoints and the evaluation metrics."""
